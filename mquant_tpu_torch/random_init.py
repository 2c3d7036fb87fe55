"""Seeded random W4A8 LLM + W8A8 vision weights at any width, built on the
device (port of ``bench.py::init_w4a8_on_device`` / ``init_vision_on_device``
with the same layouts and constant scales). No checkpoint is needed: the
weights are random, so outputs are meaningless text but exercise every
kernel at the real shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from .core.quant import QuantParams
from .kernels.qmm import quantize_weights_real
from .models.layers import SiteSpec
from .models.llm import LLM_SITES, DecoderConfig
from .models.vision import VIT_SITES, MergerConfig, ViTConfig

PATCH, MERGE = 14, 2  # Qwen2-VL's patch side and spatial merge


def llm_specs(had_mode: str = "block", split: bool = False
              ) -> Dict[str, SiteSpec]:
    """The serving specs of bench.py's ``llm_specs``: W4 per-channel sym,
    static per-tensor int8 activations, int8 lm_head, and an online
    Hadamard before ``down``: block I⊗H₁₂₈ or, with ``had_mode="full"``, the
    exact transform over the whole width (hadK ⊗ H₁₂₈). ``split`` adds the
    RMS first-column split on ``down`` (the pipeline's default artifact)."""
    if had_mode not in ("block", "full"):
        raise ValueError(f"had_mode {had_mode!r}: block or full")
    s = {f"llm.{n}": SiteSpec(w_bits=4, a_bits=8, a_static=True)
         for n in LLM_SITES}
    s["llm.down"] = dataclasses.replace(
        s["llm.down"], online_had=had_mode,
        head_dim=128 if had_mode == "block" else 0, split=split)
    s["llm.lm_head"] = SiteSpec(w_bits=8, a_bits=8, a_static=True)
    return s


def vision_specs() -> Dict[str, SiteSpec]:
    s = {f"vis.{n}": SiteSpec(w_bits=8, a_bits=8, a_static=True)
         for n in VIT_SITES}
    s.update({f"merger.{n}": SiteSpec(w_bits=8, a_bits=8, a_static=True)
              for n in ("mlp0", "mlp2")})
    return s


def init_w4a8(cfg: DecoderConfig, gen: torch.Generator, device
              ) -> Tuple[Dict, Dict]:
    """W4-grid codes in int8 storage (values in [-7, 7], per-channel scale
    0.01), bf16 embedding, int8 lm_head (scale 2e-4) and static activation
    scales of 0.05. Returns (params, state)."""
    L, Hd, I = cfg.n_layers, cfg.hidden, cfg.inter_eff
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def qsite(din, dout, bias=False):
        d = {"w_q": torch.randint(-7, 8, (L, din, dout), generator=gen,
                                  device=device, dtype=torch.int8),
             "w_scale": torch.full((L, dout), 0.01, device=device)}
        d["b"] = (torch.zeros((L, dout), dtype=torch.bfloat16, device=device)
                  if bias else None)
        return d

    embed = torch.randn((cfg.vocab, Hd), generator=gen, device=device)
    params = {
        "embed": {"w": (embed * 0.02).to(torch.bfloat16)},
        "layers": {
            "ln1": {"w": torch.ones((L, Hd), dtype=torch.bfloat16,
                                    device=device)},
            "q": qsite(Hd, H * hd, True),
            "k": qsite(Hd, KV * hd, True),
            "v": qsite(Hd, KV * hd, True),
            "o": qsite(H * hd, Hd),
            "ln2": {"w": torch.ones((L, Hd), dtype=torch.bfloat16,
                                    device=device)},
            "gate": qsite(Hd, I),
            "up": qsite(Hd, I),
            "down": qsite(I, Hd),
        },
        "ln_f": {"w": torch.ones((Hd,), dtype=torch.bfloat16, device=device)},
        "lm_head": {
            "w_q": torch.randint(-127, 128, (Hd, cfg.vocab), generator=gen,
                                 device=device, dtype=torch.int8),
            "w_scale": torch.full((cfg.vocab,), 2e-4, device=device),
        },
    }
    del embed
    state = {f"llm.{n}": {"act": QuantParams(
        torch.full((L,), 0.05, device=device))} for n in LLM_SITES}
    state["llm.lm_head"] = {"act": QuantParams(
        torch.tensor(0.05, device=device))}
    return params, state


def init_split_down(cfg: DecoderConfig, gen: torch.Generator, device
                    ) -> Dict[str, torch.Tensor]:
    """``down`` in RMS-split storage, as the JAX package realizes it: W4
    codes of input rows 1..I−1 in int8 storage (I − 1 rows, odd, so they
    stay unpacked), the per-channel scale 0.01 of :func:`init_w4a8`, and an
    f32 ``w_col0`` (L, 1, hidden) drawn as one more dequantized W4 row."""
    L, Hd, I = cfg.n_layers, cfg.hidden, cfg.inter_eff
    col0 = torch.randint(-7, 8, (L, 1, Hd), generator=gen, device=device)
    return {"w_q": torch.randint(-7, 8, (L, I - 1, Hd), generator=gen,
                                 device=device, dtype=torch.int8),
            "w_scale": torch.full((L, Hd), 0.01, device=device),
            "w_col0": col0.float() * 0.01, "b": None}


def _normal_w(gen, device, *shape):
    """bf16 N(0, 1/fan_in) weight, as the JAX package's init_*_params."""
    w = torch.randn(shape, generator=gen, device=device)
    return (w * (1.0 / shape[-2] ** 0.5)).to(torch.bfloat16)


def _realize8(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-layer ``quantize_weights_real(w, 8)`` of a stacked (L, in, out)
    or single (in, out) weight."""
    if w.ndim == 2:
        return quantize_weights_real(w, 8)
    parts = [quantize_weights_real(wl, 8) for wl in w]
    return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}


def init_vision_w8a8(vcfg: ViTConfig, mcfg: MergerConfig,
                     gen: torch.Generator, device
                     ) -> Tuple[Dict, Dict, Dict]:
    """Qwen2-VL ViT + merger with realized int8 W8A8 sites (per-channel
    minmax grid from N(0, 1/fan_in) bf16 weights), bf16 patch embed and
    norms, static activation scales of 0.05. Returns (vit, merger, state)."""
    Lv, W, M = vcfg.n_layers, vcfg.width, vcfg.mlp_width
    hd, H = vcfg.head_dim, vcfg.n_heads
    bf = dict(dtype=torch.bfloat16, device=device)

    def site(din, dout):
        d = _realize8(_normal_w(gen, device, Lv, din, dout))
        d["b"] = torch.zeros((Lv, dout), **bf)
        return d

    def norm(*shape):
        return {"w": torch.ones(shape, **bf), "b": torch.zeros(shape, **bf)}

    vit = {
        "patch_embed": {"w": _normal_w(gen, device, vcfg.patch_dim, W),
                        "b": torch.zeros((W,), **bf)},
        "blocks": {"ln1": norm(Lv, W), "q": site(W, H * hd),
                   "k": site(W, H * hd), "v": site(W, H * hd),
                   "o": site(H * hd, W), "ln2": norm(Lv, W),
                   "fc1": site(W, M), "fc2": site(M, W)},
    }
    merger = {"ln_q": norm(mcfg.context_dim)}
    for name, (din, dout) in (("mlp0", (mcfg.in_dim, mcfg.in_dim)),
                              ("mlp2", (mcfg.in_dim, mcfg.out_dim))):
        d = _realize8(_normal_w(gen, device, din, dout))
        d["b"] = torch.zeros((dout,), **bf)
        merger[name] = d
    state = {f"vis.{n}": {"act": QuantParams(
        torch.full((Lv,), 0.05, device=device))} for n in VIT_SITES}
    state.update({f"merger.{n}": {"act": QuantParams(
        torch.tensor(0.05, device=device))} for n in ("mlp0", "mlp2")})
    return vit, merger, state


def vlm_inputs(image_token_id: int, patch_dim: int, prefill: int,
               gen: torch.Generator, device, side: int = 448):
    """(patches, grid, tokens) of a request with one side × side image: its
    (side/14)² patch rows, their grid, and a ``prefill``-token prompt with the
    image's (side/28)² merged tokens at positions 2.. (the rest token 11).
    side 448 is bench.py's request (32×32 patches, 256 image tokens); 896 is
    a document page (64×64 patches, 4096 ViT rows, 1024 image tokens)."""
    g = side // PATCH
    n_img = (g // MERGE) ** 2
    patches = torch.randn((1, g * g, patch_dim), generator=gen,
                          device=device).to(torch.bfloat16)
    rows = torch.arange(g, device=device)[:, None].expand(g, g)
    cols = torch.arange(g, device=device)[None, :].expand(g, g)
    grid = torch.stack([rows, cols], -1).reshape(1, -1, 2).to(torch.int32)
    toks = torch.full((1, prefill), 11, dtype=torch.long, device=device)
    toks[:, 2:2 + n_img] = image_token_id
    return patches, grid, toks
