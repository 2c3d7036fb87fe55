"""Cross-modal projectors (counterpart of ``mquant_tpu/models/projectors.py``):
InternVL2's pixel shuffle + ``mlp1`` = LayerNorm → fc1 → GELU → fc2 (the
quant sites ``proj.fc1`` / ``proj.fc2``). GLM-4V's GLU projector is not
ported (ROADMAP A12b); the Qwen2-VL merger lives in ``vision.py``."""

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
