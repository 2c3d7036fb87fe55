"""Qwen-VL-Chat: a CLIP-style ViT (ln_pre, ``fc_sub_mean``, ln_post) →
the ``attn_pool`` resampler → the Qwen decoder (counterpart of
``mquant_tpu/models/qwenvl.py``).

The layout is the JAX package's, the reference's checkpoint surgery done
at load time (``loader.load_qwenvl``): separate q / k / v in the tower and
the resampler, ``proj`` as the ``proj_fc`` linear, and ``fc_sub_mean``, the
explicit (I − 11ᵀ/n) centering after ln_pre that makes the tower's
LayerNorm → RMSNorm fusion exact (a float linear, never quantized). The
decoder is ``llm.py``'s with Qwen's widths: 32 / 32 heads (G = 1), q/k/v
biases, dynamic NTK past 2048 positions. The resampler's ``n_queries``
pooled rows are spliced in at the image tokens, whatever the image's
patch count.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .llm import DecoderConfig, decoder_forward, init_decoder_params
from .qwen2vl import splice_image_embeds
from .resampler import (ResamplerConfig, init_resampler_params,
                        resampler_forward)
from .vision import ViTConfig, init_vit_params, vit_forward


@dataclasses.dataclass(frozen=True)
class QwenVLConfig:
    name: str
    llm: DecoderConfig
    vit: ViTConfig
    resampler: ResamplerConfig
    image_token_id: int = 151857  # <imgpad> in Qwen-VL's vocabulary
    patch: int = 14

    @staticmethod
    def tiny():
        """CPU-testable miniature with the same structure (f32)."""
        return QwenVLConfig(
            name="qwenvl-tiny",
            llm=DecoderConfig(vocab=256, hidden=64, n_layers=2, n_heads=4,
                              n_kv_heads=4, intermediate=96,
                              rope_theta=10000.0, dtype=torch.float32),
            vit=ViTConfig(width=32, n_layers=2, n_heads=2, mlp_width=64,
                          patch_dim=4 * 4 * 3, n_pos=64, pre_norm=True,
                          post_norm=True, act="gelu", dtype=torch.float32),
            resampler=ResamplerConfig(n_queries=4, width=64, kv_dim=32,
                                      n_heads=2, out_dim=64,
                                      dtype=torch.float32),
            image_token_id=255,
            patch=4,
        )

    @staticmethod
    def qwenvl_chat():
        """Qwen-VL-Chat (7.7 B LLM + 1.9 B ViT), the HF config's widths."""
        return QwenVLConfig(
            name="Qwen-VL-Chat",
            llm=DecoderConfig(vocab=151936, hidden=4096, n_layers=32,
                              n_heads=32, n_kv_heads=32, intermediate=11008,
                              rope_theta=10000.0, use_dynamic_ntk=True,
                              ntk_seq_length=2048),
            vit=ViTConfig(width=1664, n_layers=48, n_heads=16,
                          mlp_width=8192, patch_dim=14 * 14 * 3, n_pos=1024,
                          pre_norm=True, post_norm=True, act="gelu",
                          norm_eps=1e-6),
            resampler=ResamplerConfig(n_queries=256, width=4096, kv_dim=1664,
                                      n_heads=32, out_dim=4096),
        )


def init_qwenvl_params(cfg: QwenVLConfig, gen: torch.Generator,
                       device="cuda") -> Dict:
    """Random Qwen-VL params in the JAX package's layout (its
    ``init_qwenvl_params``), drawn from ``gen`` in the order LLM, ViT,
    resampler (other values than JAX's RNG); ``vit.fc_sub_mean`` is the
    exact centering matrix in the tower's dtype."""
    from ..transform.fuse import sub_mean_matrix

    p = {"llm": init_decoder_params(cfg.llm, gen, device=device),
         "vit": init_vit_params(cfg.vit, gen, device=device),
         "res": init_resampler_params(cfg.resampler, gen,
                                      n_pos=cfg.vit.n_pos or 1024,
                                      device=device)}
    p["vit"]["fc_sub_mean"] = {
        "w": sub_mean_matrix(cfg.vit.width, device=device).to(cfg.vit.dtype),
        "b": None}
    return p


def image_features(cfg: QwenVLConfig, params: Dict, patches: torch.Tensor,
                   grid: Optional[tuple] = None, specs=None, state=None,
                   mode: str = "fp", collect_stats: bool = False,
                   collect_samples: bool = False):
    """patches (B, T, patch_dim) → (the resampler's pooled rows (B,
    n_queries, hidden), stats of the ViT and the resampler or None).
    ``grid`` is not read: the pool takes any patch count."""
    feats, vs = vit_forward(cfg.vit, params["vit"], patches, specs, state,
                            mode, collect_stats=collect_stats,
                            collect_samples=collect_samples)
    img, rs = resampler_forward(cfg.resampler, params["res"], feats, specs,
                                state, mode, collect_stats=collect_stats,
                                collect_samples=collect_samples)
    if not collect_stats:
        return img, None
    return img, ({**vs[0], **rs[0]}, {**vs[1], **rs[1]})


def qwenvl_forward(cfg: QwenVLConfig, params: Dict, tokens: torch.Tensor,
                   patches: Optional[torch.Tensor] = None,
                   grid: Optional[tuple] = None,
                   specs: Optional[Dict] = None,
                   state: Optional[Dict] = None, mode: str = "fp",
                   positions: Optional[torch.Tensor] = None,
                   cache: Optional[Dict] = None,
                   collect_stats: bool = False,
                   collect_samples: bool = False):
    """End-to-end forward: tokens (B, T), optional patches (B, T_p,
    patch_dim) whose n_queries pooled rows are spliced in at the image
    tokens, optional 1-D ``positions`` (B, T); ``grid`` (the runner's
    patch grid) is not read. Returns (logits, cache, stats): ``stats``
    None unless ``collect_stats``, then (stats, samples) of the ``vis.*``,
    ``res.*`` and ``llm.*`` sites."""
    stats: Dict = {}
    samples: Dict = {}
    embeds = params["llm"]["embed"]["w"][tokens].to(cfg.llm.dtype)
    if patches is not None:
        img, st = image_features(cfg, params, patches, grid, specs, state,
                                 mode, collect_stats, collect_samples)
        if st is not None:
            stats.update(st[0])
            samples.update(st[1])
        embeds = splice_image_embeds(embeds, tokens, img, cfg.image_token_id)
    logits, cache, ls = decoder_forward(
        cfg.llm, params["llm"], embeds, specs=specs, state=state, mode=mode,
        cache=cache, positions=positions, collect_stats=collect_stats,
        collect_samples=collect_samples)
    if ls is not None:
        stats.update(ls[0] or {})
        samples.update(ls[1] or {})
    return logits, cache, (stats, samples) if collect_stats else None
