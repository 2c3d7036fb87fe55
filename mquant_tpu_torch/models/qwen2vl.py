"""Qwen2-VL (2B / 7B / 72B): configurations, the multimodal splice, M-RoPE
positions and the end-to-end forward ViT → merger → splice → decoder
(counterpart of ``mquant_tpu/models/qwen2vl.py``)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .llm import DecoderConfig, decoder_forward, init_decoder_params
from .vision import (MergerConfig, ViTConfig, init_merger_params,
                     init_vit_params, merger_forward, vit_forward)


@dataclasses.dataclass(frozen=True)
class Qwen2VLConfig:
    name: str
    llm: DecoderConfig
    vit: ViTConfig
    merger: MergerConfig
    image_token_id: int = 151655
    spatial_merge: int = 2
    patch: int = 14

    @staticmethod
    def tiny():
        """CPU-testable miniature with the same structure (f32)."""
        return Qwen2VLConfig(
            name="qwen2vl-tiny",
            llm=DecoderConfig(vocab=256, hidden=64, n_layers=2, n_heads=4,
                              n_kv_heads=2, intermediate=96,
                              mrope_sections=(2, 3, 3), dtype=torch.float32),
            vit=ViTConfig(width=32, n_layers=2, n_heads=2, mlp_width=48,
                          patch_dim=2 * 4 * 4 * 3, rotary_2d=True,
                          dtype=torch.float32),
            merger=MergerConfig(context_dim=32, out_dim=64,
                                dtype=torch.float32),
            image_token_id=255,
            patch=4,
        )

    @staticmethod
    def qwen2vl_2b():
        return Qwen2VLConfig(
            name="Qwen2-VL-2B-Instruct",
            llm=DecoderConfig(vocab=151936, hidden=1536, n_layers=28,
                              n_heads=12, n_kv_heads=2, intermediate=8960,
                              tie_embeddings=True,
                              mrope_sections=(16, 24, 24)),
            vit=_QWEN2VL_VIT,
            merger=MergerConfig(context_dim=1280, out_dim=1536),
        )

    @staticmethod
    def qwen2vl_7b():
        return Qwen2VLConfig(
            name="Qwen2-VL-7B-Instruct",
            llm=DecoderConfig(vocab=152064, hidden=3584, n_layers=28,
                              n_heads=28, n_kv_heads=4, intermediate=18944,
                              mrope_sections=(16, 24, 24)),
            vit=_QWEN2VL_VIT,
            merger=MergerConfig(context_dim=1280, out_dim=3584),
        )

    @staticmethod
    def qwen2vl_72b():
        """72B's intermediate of 29568 is outside the Hadamard tail
        kernel's row contract (ROADMAP B-c1): its full-Hadamard tail takes
        the unfused chain on the card."""
        return Qwen2VLConfig(
            name="Qwen2-VL-72B-Instruct",
            llm=DecoderConfig(vocab=152064, hidden=8192, n_layers=80,
                              n_heads=64, n_kv_heads=8, intermediate=29568,
                              mrope_sections=(16, 24, 24)),
            vit=_QWEN2VL_VIT,
            merger=MergerConfig(context_dim=1280, out_dim=8192),
        )


_QWEN2VL_VIT = ViTConfig(width=1280, n_layers=32, n_heads=16, mlp_width=5120,
                         patch_dim=2 * 14 * 14 * 3, rotary_2d=True,
                         act="quick_gelu", norm_eps=1e-6)


def init_qwen2vl_params(cfg: Qwen2VLConfig, gen: torch.Generator,
                        device="cuda") -> Dict:
    """Random Qwen2-VL params in the JAX package's layout (its
    ``init_qwen2vl_params``), drawn from ``gen`` in the order LLM, ViT,
    merger (other values than JAX's RNG)."""
    return {"llm": init_decoder_params(cfg.llm, gen, device=device),
            "vit": init_vit_params(cfg.vit, gen, device=device),
            "merger": init_merger_params(cfg.merger, gen, device=device)}


def splice_image_embeds(text_embeds: torch.Tensor, tokens: torch.Tensor,
                        image_embeds: torch.Tensor, image_token_id: int
                        ) -> torch.Tensor:
    """Replace embeddings at image-token slots with image features, in order:
    the i-th image-token slot receives the i-th row of ``image_embeds``."""
    mask = tokens == image_token_id  # (B, T)
    idx = torch.clamp(torch.cumsum(mask.long(), dim=1) - 1, 0,
                      image_embeds.shape[1] - 1)
    gathered = torch.take_along_dim(image_embeds, idx[..., None], dim=1)
    return torch.where(mask[..., None], gathered.to(text_embeds.dtype),
                       text_embeds)


def mrope_positions(tokens: np.ndarray, image_token_id: int, grid_thw=None,
                    merge: int = 2) -> np.ndarray:
    """Host-side M-RoPE position ids (3, B, T): text advances all three
    planes together; an image span of a (t, h, w) patch grid takes
    temporal = const and the merged grid's row / column; text after an image
    resumes at max(position) + 1. ``grid_thw``: one (t, h, w) or a list, the
    i-th image-token span taking the i-th grid."""
    B, T = tokens.shape
    pos = np.zeros((3, B, T), np.int64)
    grids = None
    if grid_thw is not None:
        grids = list(grid_thw) if isinstance(grid_thw, list) else [grid_thw]
    for b in range(B):
        p = 0
        t_iter = 0
        img_i = 0
        while t_iter < T:
            if tokens[b, t_iter] == image_token_id and grids is not None:
                t, h, w = grids[min(img_i, len(grids) - 1)]
                img_i += 1
                hh, ww = h // merge, w // merge
                n = t * hh * ww
                ti = np.repeat(np.arange(t), hh * ww)
                hi = np.tile(np.repeat(np.arange(hh), ww), t)
                wi = np.tile(np.arange(ww), t * hh)
                pos[0, b, t_iter:t_iter + n] = p + ti
                pos[1, b, t_iter:t_iter + n] = p + hi
                pos[2, b, t_iter:t_iter + n] = p + wi
                p = p + max(t, hh, ww)
                t_iter += n
            else:
                pos[:, b, t_iter] = p
                p += 1
                t_iter += 1
    return pos


def qwen2vl_forward(cfg: Qwen2VLConfig, params: Dict, tokens: torch.Tensor,
                    patches: Optional[torch.Tensor] = None,
                    grid_hw: Optional[torch.Tensor] = None,
                    specs: Optional[Dict] = None,
                    state: Optional[Dict] = None, mode: str = "fp",
                    positions: Optional[torch.Tensor] = None,
                    cache: Optional[Dict] = None,
                    vis_token_mask: Optional[torch.Tensor] = None,
                    collect_stats: bool = False,
                    collect_samples: bool = False):
    """End-to-end VLM forward: tokens (B, T), optional patches (B, N·merge²,
    patch_dim) with their grid (B, N·merge², 2) spliced in at the image
    tokens, M-RoPE ``positions`` (3, B, T). Returns (logits, cache, stats):
    ``stats`` None unless ``collect_stats``, then (stats, samples) of every
    subsystem's sites (``vis.*``, ``merger.*``, ``llm.*``)."""
    stats: Dict = {}
    samples: Dict = {}

    def add(st):
        if st is not None:
            stats.update(st[0] or {})
            samples.update(st[1] or {})

    embeds = params["llm"]["embed"]["w"][tokens].to(cfg.llm.dtype)
    if patches is not None:
        feats, vs = vit_forward(cfg.vit, params["vit"], patches, specs, state,
                                mode, grid_hw=grid_hw,
                                token_mask=vis_token_mask,
                                collect_stats=collect_stats,
                                collect_samples=collect_samples)
        add(vs)
        merged, ms = merger_forward(cfg.merger, params["merger"], feats,
                                    specs, state, mode,
                                    token_mask=vis_token_mask,
                                    collect_stats=collect_stats,
                                    collect_samples=collect_samples)
        add(ms)
        embeds = splice_image_embeds(embeds, tokens, merged,
                                     cfg.image_token_id)
    logits, cache, ls = decoder_forward(
        cfg.llm, params["llm"], embeds, specs=specs, state=state, mode=mode,
        cache=cache, positions=positions, collect_stats=collect_stats,
        collect_samples=collect_samples)
    add(ls)
    return logits, cache, (stats, samples) if collect_stats else None


def default_w4a8_specs(visual_w_bits: int = 8, llm_w_bits: int = 4,
                       a_bits: int = 8, a_static: bool = True,
                       online_had: bool = True, split: bool = True,
                       observer: str = "minmax",
                       online_had_mode: str = "full") -> Dict:
    """The reference's headline config: visual W8A8 (or W4A8) + LLM W4A8,
    static activations, online Hadamard before ``down`` (full, or block
    I⊗H₁₂₈) with the RMS split."""
    from .layers import SiteSpec
    from .llm import LLM_SITES
    from .vision import VIT_SITES

    s = {}
    for n in VIT_SITES + ("patch_embed",):
        s[f"vis.{n}"] = SiteSpec(w_bits=visual_w_bits, a_bits=a_bits,
                                 a_static=a_static, observer=observer)
    for n in ("mlp0", "mlp2"):
        s[f"merger.{n}"] = SiteSpec(w_bits=visual_w_bits, a_bits=a_bits,
                                    a_static=a_static, observer=observer)
    for n in LLM_SITES:
        s[f"llm.{n}"] = SiteSpec(w_bits=llm_w_bits, a_bits=a_bits,
                                 a_static=a_static, observer=observer)
    if online_had:
        if online_had_mode == "block":
            s["llm.down"] = dataclasses.replace(
                s["llm.down"], online_had="block", head_dim=128, split=split)
        else:
            s["llm.down"] = dataclasses.replace(
                s["llm.down"], online_had="full", split=split)
    return s
