"""GLM-4V-9B: EVA2CLIP vision tower → conv downsample + GLU projector →
ChatGLM (counterpart of ``mquant_tpu/models/glm4v.py``).

ChatGLM is the decoder of ``llm.py`` with its own widths and flags: MQA with
2 KV heads for 32 query heads, q/k/v biases, rotary on half of each head
(``rope_partial`` 0.5) in interleaved (re, im) pairs (``rope_interleaved``)
over 1-D positions. The loader (``loader.load_glm4v``) splits the fused
``query_key_value`` and ``dense_h_to_4h``. The image rows are spliced in at
the image tokens between the projector's boi and eoi rows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .llm import DecoderConfig, decoder_forward, init_decoder_params
from .projectors import (GluProjectorConfig, glu_projector_forward,
                         init_glu_params)
from .qwen2vl import splice_image_embeds
from .vision import ViTConfig, init_vit_params, vit_forward


@dataclasses.dataclass(frozen=True)
class GLM4VConfig:
    name: str
    llm: DecoderConfig
    vit: ViTConfig
    proj: GluProjectorConfig
    image_token_id: int = 151339  # the slots of the boi … eoi span
    patch: int = 14

    @staticmethod
    def tiny():
        """CPU-testable miniature with the same structure (f32)."""
        return GLM4VConfig(
            name="glm4v-tiny",
            llm=DecoderConfig(vocab=256, hidden=64, n_layers=2, n_heads=4,
                              n_kv_heads=2, intermediate=96,
                              rope_partial=0.5, rope_interleaved=True,
                              rope_theta=10000.0, dtype=torch.float32),
            vit=ViTConfig(width=32, n_layers=2, n_heads=2, mlp_width=64,
                          patch_dim=4 * 4 * 3, n_pos=64,
                          dtype=torch.float32),
            proj=GluProjectorConfig(vit_width=32, out_dim=64, ffn_dim=96,
                                    dtype=torch.float32),
            image_token_id=255,
            patch=4,
        )

    @staticmethod
    def glm4v_9b():
        return GLM4VConfig(
            name="glm-4v-9b",
            llm=DecoderConfig(vocab=151552, hidden=4096, n_layers=40,
                              n_heads=32, n_kv_heads=2, intermediate=13696,
                              rope_partial=0.5, rope_interleaved=True,
                              rope_theta=10000.0),
            vit=ViTConfig(width=1792, n_layers=63, n_heads=16,
                          mlp_width=15360, patch_dim=14 * 14 * 3,
                          n_pos=6401, norm_eps=1e-6),
            proj=GluProjectorConfig(vit_width=1792, out_dim=4096,
                                    ffn_dim=13696),
        )


def init_glm4v_params(cfg: GLM4VConfig, gen: torch.Generator,
                      device="cuda") -> Dict:
    """Random GLM-4V params in the JAX package's layout (its
    ``init_glm4v_params``), drawn from ``gen`` in the order LLM, ViT,
    projector (other values than JAX's RNG)."""
    return {"llm": init_decoder_params(cfg.llm, gen, device=device),
            "vit": init_vit_params(cfg.vit, gen, device=device),
            "proj": init_glu_params(cfg.proj, gen, device=device)}


def image_features(cfg: GLM4VConfig, params: Dict, patches: torch.Tensor,
                   grid: tuple, specs=None, state=None, mode: str = "fp",
                   collect_stats: bool = False, collect_samples: bool = False):
    """patches (B, gh·gw, patch_dim) of a (gh, gw) grid → (image rows (B,
    2 + gh·gw / 4, hidden) with boi and eoi, stats of the ViT and the
    projector or None)."""
    gh, gw = grid
    feats, vs = vit_forward(cfg.vit, params["vit"], patches, specs, state,
                            mode, collect_stats=collect_stats,
                            collect_samples=collect_samples)
    img, ps = glu_projector_forward(cfg.proj, params["proj"],
                                    feats[:, :gh * gw], gh, gw,
                                    specs, state, mode,
                                    collect_stats=collect_stats,
                                    collect_samples=collect_samples)
    if not collect_stats:
        return img, None
    return img, ({**vs[0], **ps[0]}, {**vs[1], **ps[1]})


def glm4v_forward(cfg: GLM4VConfig, params: Dict, tokens: torch.Tensor,
                  patches: Optional[torch.Tensor] = None,
                  grid: Optional[tuple] = None,
                  specs: Optional[Dict] = None,
                  state: Optional[Dict] = None, mode: str = "fp",
                  positions: Optional[torch.Tensor] = None,
                  cache: Optional[Dict] = None,
                  collect_stats: bool = False,
                  collect_samples: bool = False):
    """End-to-end forward: tokens (B, T), optional patches (B, gh·gw,
    patch_dim) of the (gh, gw) ``grid`` spliced in at the image tokens (2 +
    gh·gw / 4 of them: boi, the image rows, eoi), optional 1-D
    ``positions`` (B, T). Returns (logits, cache, stats): ``stats`` None
    unless ``collect_stats``, then (stats, samples) of the ``vis.*``,
    ``proj.*`` and ``llm.*`` sites."""
    stats: Dict = {}
    samples: Dict = {}
    embeds = params["llm"]["embed"]["w"][tokens].to(cfg.llm.dtype)
    if patches is not None:
        if grid is None:
            raise ValueError("glm4v_forward: patches need their grid")
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
