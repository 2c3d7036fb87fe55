"""Cross-modal projectors (counterpart of ``mquant_tpu/models/projectors.py``):
InternVL2's pixel shuffle + ``mlp1`` = LayerNorm → fc1 → GELU → fc2 (the
quant sites ``proj.fc1`` / ``proj.fc2``), and GLM-4V's GLU projector: a
2 × 2 merge → conv → linear_proj → LayerNorm → GELU → silu(gate) · h_to_4h
→ 4h_to_h between learned boi / eoi rows (the sites ``proj.conv``,
``proj.linear_proj``, ``proj.gate``, ``proj.h_to_4h``, ``proj.4h_to_h``).
The Qwen2-VL merger lives in ``vision.py``."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from . import layers as L
from .layers import qlinear


@dataclasses.dataclass(frozen=True)
class Mlp1Config:
    vit_width: int
    out_dim: int
    downsample: int = 2  # pixel-shuffle factor (InternVL's 0.5 ratio → 2)
    norm_kind: str = "ln"
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16

    @property
    def in_dim(self) -> int:
        return self.vit_width * self.downsample * self.downsample


def init_mlp1_params(cfg: Mlp1Config, gen: torch.Generator, dtype=None,
                     device="cuda") -> Dict:
    """Random mlp1 params in the JAX package's layout (its
    ``init_mlp1_params``): N(0, 1/fan_in) fc1 / fc2 drawn on ``gen``'s
    device, zero biases, a unit ``ln`` (zero bias for LayerNorm)."""
    dtype = dtype or cfg.dtype
    kw = dict(dtype=dtype, device=device)
    D, out = cfg.in_dim, cfg.out_dim
    p = {"ln": {"w": torch.ones((D,), **kw)},
         "fc1": {"w": L.normal_init(gen, (D, out), **kw),
                 "b": torch.zeros((out,), **kw)},
         "fc2": {"w": L.normal_init(gen, (out, out), **kw),
                 "b": torch.zeros((out,), **kw)}}
    if cfg.norm_kind == "ln":
        p["ln"]["b"] = torch.zeros((D,), **kw)
    return p


def pixel_shuffle(x: torch.Tensor, gh: int, gw: int, factor: int = 2
                  ) -> torch.Tensor:
    """(B, gh·gw, C) → (B, gh·gw / factor², C·factor²): each factor ×
    factor neighbourhood merged into the channels, row-major."""
    B, _, C = x.shape
    x = x.reshape(B, gh // factor, factor, gw // factor, factor, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (gh // factor) * (gw // factor), factor * factor * C)


def mlp1_forward(cfg: Mlp1Config, params: Dict, x: torch.Tensor, specs=None,
                 state=None, mode="fp", token_mask=None,
                 collect_stats: bool = False, collect_samples: bool = False,
                 prefix: str = "proj"):
    """x (B, T, in_dim) pixel-shuffled features → ((B, T, out_dim), stats):
    None unless ``collect_stats``, then (stats, samples). LayerNorm while
    ``ln`` keeps its bias, unit RMSNorm once fusion dropped it."""
    if token_mask is not None:
        raise NotImplementedError("vision token masks (padded patch "
                                  "sequences) are not ported (ROADMAP A6)")
    specs = specs or {}
    tape = L.Tape(collect_samples) if collect_stats else None
    if cfg.norm_kind == "ln" and params["ln"].get("b") is not None:
        x = L.layer_norm(x, params["ln"]["w"], params["ln"]["b"], cfg.norm_eps)
    else:
        x = L.rms_norm(x, params["ln"]["w"], cfg.norm_eps)
    x = qlinear(x, params["fc1"], f"{prefix}.fc1", specs.get(f"{prefix}.fc1"),
                state, mode, tape)
    x = L.gelu(x)
    x = qlinear(x, params["fc2"], f"{prefix}.fc2", specs.get(f"{prefix}.fc2"),
                state, mode, tape)
    return x, None if tape is None else (tape.stats, tape.samples)


# ---------------------------------------------------------------------------
# GLM-4V: conv 2×2/2 downsample + GLU projector + boi / eoi rows
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GluProjectorConfig:
    vit_width: int
    out_dim: int  # ChatGLM's hidden
    ffn_dim: int  # ChatGLM's ffn_hidden_size
    scaling_factor: float = 8.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16


GLU_SITES = ("conv", "linear_proj", "gate", "h_to_4h", "4h_to_h")


def init_glu_params(cfg: GluProjectorConfig, gen: torch.Generator,
                    dtype=None, device="cuda") -> Dict:
    """Random GLU projector params in the JAX package's layout (its
    ``init_glu_params``): N(0, 1/fan_in) weights drawn on ``gen``'s device
    in JAX's site order, a zero conv bias, no other bias, a unit
    ``norm1`` with a zero bias, zero boi / eoi rows."""
    dtype = dtype or cfg.dtype
    kw = dict(dtype=dtype, device=device)
    W, D, F = cfg.vit_width, cfg.out_dim, cfg.ffn_dim
    return {
        # the 2 × 2, stride-2 conv as a linear over 2 × 2-merged patches
        "conv": {"w": L.normal_init(gen, (4 * W, D), **kw),
                 "b": torch.zeros((D,), **kw)},
        "linear_proj": {"w": L.normal_init(gen, (D, D), **kw), "b": None},
        "norm1": {"w": torch.ones((D,), **kw), "b": torch.zeros((D,), **kw)},
        "gate": {"w": L.normal_init(gen, (D, F), **kw), "b": None},
        "h_to_4h": {"w": L.normal_init(gen, (D, F), **kw), "b": None},
        "4h_to_h": {"w": L.normal_init(gen, (F, D), **kw), "b": None},
        "boi": {"w": torch.zeros((1, D), **kw)},
        "eoi": {"w": torch.zeros((1, D), **kw)},
    }


def glu_projector_forward(cfg: GluProjectorConfig, params: Dict,
                          x: torch.Tensor, gh: int, gw: int, specs=None,
                          state=None, mode="fp", collect_stats: bool = False,
                          collect_samples: bool = False,
                          prefix: str = "proj"):
    """x (B, gh·gw, vit_width) ViT features → ((B, 2 + gh·gw / 4,
    out_dim), stats): the rows [boi | projected | eoi] divided by
    ``scaling_factor``; stats None unless ``collect_stats``, then (stats,
    samples)."""
    specs = specs or {}
    tape = L.Tape(collect_samples) if collect_stats else None
    B = x.shape[0]

    def ql(x, nm):
        return qlinear(x, params[nm], f"{prefix}.{nm}",
                       specs.get(f"{prefix}.{nm}"), state, mode, tape)

    x = ql(pixel_shuffle(x, gh, gw, 2), "conv")
    x = ql(x, "linear_proj")
    x = L.layer_norm(x, params["norm1"]["w"], params["norm1"]["b"],
                     cfg.norm_eps)
    x = L.gelu(x)
    x = L.swiglu(ql(x, "gate"), ql(x, "h_to_4h"))
    x = ql(x, "4h_to_h")
    ends = [params[t]["w"][None].expand(B, 1, cfg.out_dim).to(x.dtype)
            for t in ("boi", "eoi")]
    x = torch.cat([ends[0], x, ends[1]], dim=1) / cfg.scaling_factor
    return x, None if tape is None else (tape.stats, tape.samples)
