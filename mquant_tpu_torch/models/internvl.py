"""InternVL2-8B: InternViT (learned positions, LayerScale) → pixel shuffle
+ mlp1 → the InternLM2 decoder (counterpart of
``mquant_tpu/models/internvl.py``).

InternLM2 is the decoder of ``llm.py`` with its own widths: GQA 32 / 8
heads, no q/k/v bias, rope θ = 1e6 over 1-D positions (no M-RoPE). Its
interleaved ``wqkv`` is split into q / k / v by the loader
(``loader.load_internvl``); ls1 / ls2 fold into o / fc2 in the fusion
recipe (``transform.vlm_recipes.fuse_vit``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .llm import DecoderConfig, decoder_forward, init_decoder_params
from .projectors import (Mlp1Config, init_mlp1_params, mlp1_forward,
                         pixel_shuffle)
from .qwen2vl import splice_image_embeds
from .vision import ViTConfig, init_vit_params, vit_forward


@dataclasses.dataclass(frozen=True)
class InternVLConfig:
    name: str
    llm: DecoderConfig
    vit: ViTConfig
    mlp1: Mlp1Config
    image_token_id: int = 92546  # <IMG_CONTEXT>
    patch: int = 14

    @staticmethod
    def tiny():
        """CPU-testable miniature with the same structure (f32)."""
        return InternVLConfig(
            name="internvl-tiny",
            llm=DecoderConfig(vocab=256, hidden=64, n_layers=2, n_heads=4,
                              n_kv_heads=2, intermediate=96, qkv_bias=False,
                              dtype=torch.float32),
            vit=ViTConfig(width=32, n_layers=2, n_heads=2, mlp_width=64,
                          patch_dim=4 * 4 * 3, n_pos=64, layerscale=True,
                          dtype=torch.float32),
            mlp1=Mlp1Config(vit_width=32, out_dim=64, dtype=torch.float32),
            image_token_id=255,
            patch=4,
        )

    @staticmethod
    def internvl2_8b():
        return InternVLConfig(
            name="InternVL2-8B",
            llm=DecoderConfig(vocab=92553, hidden=4096, n_layers=32,
                              n_heads=32, n_kv_heads=8, intermediate=14336,
                              qkv_bias=False, rope_theta=1_000_000.0),
            vit=ViTConfig(width=1024, n_layers=24, n_heads=16,
                          mlp_width=4096, patch_dim=14 * 14 * 3, n_pos=1025,
                          layerscale=True, norm_eps=1e-6),
            mlp1=Mlp1Config(vit_width=1024, out_dim=4096),
        )


def init_internvl_params(cfg: InternVLConfig, gen: torch.Generator,
                         device="cuda") -> Dict:
    """Random InternVL params in the JAX package's layout (its
    ``init_internvl_params``), drawn from ``gen`` in the order LLM, ViT,
    mlp1 (other values than JAX's RNG)."""
    return {"llm": init_decoder_params(cfg.llm, gen, device=device),
            "vit": init_vit_params(cfg.vit, gen, device=device),
            "proj": init_mlp1_params(cfg.mlp1, gen, device=device)}


def image_features(cfg: InternVLConfig, params: Dict, patches: torch.Tensor,
                   grid: tuple, specs=None, state=None, mode: str = "fp",
                   collect_stats: bool = False, collect_samples: bool = False):
    """patches (B, gh·gw, patch_dim) of a (gh, gw) grid → (image rows (B,
    gh·gw / 4, hidden), stats of the ViT and mlp1 or None)."""
    gh, gw = grid
    feats, vs = vit_forward(cfg.vit, params["vit"], patches, specs, state,
                            mode, collect_stats=collect_stats,
                            collect_samples=collect_samples)
    shuffled = pixel_shuffle(feats[:, :gh * gw], gh, gw, cfg.mlp1.downsample)
    img, ps = mlp1_forward(cfg.mlp1, params["proj"], shuffled, specs, state,
                           mode, collect_stats=collect_stats,
                           collect_samples=collect_samples)
    if not collect_stats:
        return img, None
    return img, ({**vs[0], **ps[0]}, {**vs[1], **ps[1]})


def internvl_forward(cfg: InternVLConfig, params: Dict, tokens: torch.Tensor,
                     patches: Optional[torch.Tensor] = None,
                     grid: Optional[tuple] = None,
                     specs: Optional[Dict] = None,
                     state: Optional[Dict] = None, mode: str = "fp",
                     positions: Optional[torch.Tensor] = None,
                     cache: Optional[Dict] = None,
                     collect_stats: bool = False,
                     collect_samples: bool = False):
    """End-to-end forward: tokens (B, T), optional patches (B, gh·gw,
    patch_dim) of the (gh, gw) ``grid`` spliced in at the image tokens,
    optional 1-D ``positions`` (B, T). Returns (logits, cache, stats):
    ``stats`` None unless ``collect_stats``, then (stats, samples) of the
    ``vis.*``, ``proj.*`` and ``llm.*`` sites."""
    stats: Dict = {}
    samples: Dict = {}
    embeds = params["llm"]["embed"]["w"][tokens].to(cfg.llm.dtype)
    if patches is not None:
        if grid is None:
            raise ValueError("internvl_forward: patches need their grid")
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
