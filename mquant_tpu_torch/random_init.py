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
from .kernels.qmm import pack_int4_split, quantize_weights_real
from .models.layers import SiteSpec
from .models.llm import LLM_SITES, DecoderConfig
from .models.vision import (VIT_SITES, MergerConfig, ViTConfig,
                            init_merger_params, init_vit_params)

PATCH, MERGE = 14, 2  # Qwen2-VL's patch side and spatial merge


def llm_specs(had_mode: str = "block", split: bool = False,
              lm_head_bits: int = 8) -> Dict[str, SiteSpec]:
    """The serving specs of bench.py's ``llm_specs``: W4 per-channel sym,
    static per-tensor int8 activations, an int8 (or, with
    ``lm_head_bits=4``, packed W4) lm_head, and an online Hadamard before
    ``down``: block I⊗H₁₂₈ or, with ``had_mode="full"``, the exact transform
    over the whole width (hadK ⊗ H₁₂₈). ``split`` adds the RMS first-column
    split on ``down`` (the pipeline's default artifact)."""
    if had_mode not in ("block", "full"):
        raise ValueError(f"had_mode {had_mode!r}: block or full")
    if lm_head_bits not in (4, 8):
        raise ValueError(f"lm_head_bits {lm_head_bits}: 4 or 8")
    s = {f"llm.{n}": SiteSpec(w_bits=4, a_bits=8, a_static=True)
         for n in LLM_SITES}
    s["llm.down"] = dataclasses.replace(
        s["llm.down"], online_had=had_mode,
        head_dim=128 if had_mode == "block" else 0, split=split)
    s["llm.lm_head"] = SiteSpec(w_bits=lm_head_bits, a_bits=8,
                                a_static=True)
    return s


def vision_specs() -> Dict[str, SiteSpec]:
    s = {f"vis.{n}": SiteSpec(w_bits=8, a_bits=8, a_static=True)
         for n in VIT_SITES}
    s.update({f"merger.{n}": SiteSpec(w_bits=8, a_bits=8, a_static=True)
              for n in ("mlp0", "mlp2")})
    return s


def init_w4a8(cfg: DecoderConfig, gen: torch.Generator, device,
              lm_head_bits: int = 8) -> Tuple[Dict, Dict]:
    """W4-grid codes in int8 storage (values in [-7, 7], per-channel scale
    0.01), bf16 embedding, an int8 lm_head (scale 2e-4) or, with
    ``lm_head_bits=4``, a split-half packed W4 one ((hidden/2, vocab) bytes
    of [-7, 7] codes, scale 4e-3: bench.py's), and static activation scales
    of 0.05. Returns (params, state)."""
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
    }
    if lm_head_bits == 4:
        hq = torch.randint(-7, 8, (Hd, cfg.vocab), generator=gen,
                           device=device, dtype=torch.int8)
        params["lm_head"] = {"w_q": pack_int4_split(hq),
                             "w_scale": torch.full((cfg.vocab,), 4e-3,
                                                   device=device)}
        del hq
    else:
        params["lm_head"] = {
            "w_q": torch.randint(-127, 128, (Hd, cfg.vocab), generator=gen,
                                 device=device, dtype=torch.int8),
            "w_scale": torch.full((cfg.vocab,), 2e-4, device=device)}
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


def _realize8(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-layer ``quantize_weights_real(w, 8)`` of a stacked (L, in, out)
    or single (in, out) weight."""
    if w.ndim == 2:
        return quantize_weights_real(w, 8)
    parts = [quantize_weights_real(wl, 8) for wl in w]
    return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}


def realize_vision(vit: Dict, merger: Dict) -> Tuple[Dict, Dict]:
    """The ViT's and merger's linear sites as realized int8 W8 storage
    (per-channel minmax grid, bench.py's ``_realize_site``), biases, patch
    embed and norms as they are."""
    def site(p):
        out = {k: v for k, v in p.items() if k != "w"}
        out.update(_realize8(p["w"]))
        return out

    vq = {**vit, "blocks": {k: site(v) if k in VIT_SITES else v
                            for k, v in vit["blocks"].items()}}
    mq = {k: site(v) if k in ("mlp0", "mlp2") else v
          for k, v in merger.items()}
    return vq, mq


def vision_state(n_layers: int, device) -> Dict:
    """Static activation scales of 0.05 for every W8A8 vision site."""
    state = {f"vis.{n}": {"act": QuantParams(
        torch.full((n_layers,), 0.05, device=device))} for n in VIT_SITES}
    state.update({f"merger.{n}": {"act": QuantParams(
        torch.full((), 0.05, device=device))} for n in ("mlp0", "mlp2")})
    return state


def init_vision_w8a8(vcfg: ViTConfig, mcfg: MergerConfig,
                     gen: torch.Generator, device
                     ) -> Tuple[Dict, Dict, Dict]:
    """Qwen2-VL ViT + merger with realized int8 W8A8 sites (per-channel
    minmax grid from the N(0, 1/fan_in) bf16 weights of
    ``init_vit_params`` / ``init_merger_params`` drawn on ``gen``), bf16
    patch embed and norms, static activation scales of 0.05. Returns (vit,
    merger, state)."""
    vit = init_vit_params(vcfg, gen, dtype=torch.bfloat16, device=device)
    merger = init_merger_params(mcfg, gen, dtype=torch.bfloat16,
                                device=device)
    vit, merger = realize_vision(vit, merger)
    return vit, merger, vision_state(vcfg.n_layers, device)


def vlm_inputs(image_token_id: int, patch_dim: int, prefill: int,
               gen: torch.Generator, device, side: int = 448,
               patch: int = PATCH):
    """(patches, grid, tokens) of a request with one side × side image: its
    (side/patch)² patch rows, their grid, and a ``prefill``-token prompt
    with the image's (side/(2·patch))² merged tokens at positions 2.. (the
    rest token 11). side 448 is bench.py's request (32×32 patches, 256 image
    tokens); 896 is a document page (64×64 patches, 4096 ViT rows, 1024
    image tokens)."""
    g = side // patch
    n_img = (g // MERGE) ** 2
    patches = torch.randn((1, g * g, patch_dim), generator=gen,
                          device=device).to(torch.bfloat16)
    rows = torch.arange(g, device=device)[:, None].expand(g, g)
    cols = torch.arange(g, device=device)[None, :].expand(g, g)
    grid = torch.stack([rows, cols], -1).reshape(1, -1, 2).to(torch.int32)
    toks = torch.full((1, prefill), 11, dtype=torch.long, device=device)
    toks[:, 2:2 + n_img] = image_token_id
    return patches, grid, toks
