"""Vision transformer tower + Qwen2-VL merger (counterpart of
``mquant_tpu/models/vision.py``): Qwen2-VL's ViT (2-D rotary), InternViT
(learned position embeddings, LayerScale) and Qwen-VL's CLIP-style tower
(``pre_norm``: ln_pre and the float ``fc_sub_mean`` centering after the
patch embed; ``post_norm``: ln_post after the blocks).

Blocks are stacked (L, ...) like the decoder and walked with per-layer views.
The patch-embed "conv" (kernel == stride) is a linear over flattened patch
pixels (:func:`patchify_qwen2vl` / :func:`patchify_2d` + ``qlinear``, the
``vis.patch_embed`` site). Every site runs in the modes ``qlinear``
ports: realized int8 storage in "real" mode, float weights with
fake-quantized activations in "fake" mode (or in "real" mode where the
pipeline realized the LLM alone), ``vis.fc2`` with its online Hadamard
over the MLP width and its RMS split where the specs set them. Validity
masks of padded patch sequences (``token_mask``) are not ported (ROADMAP
A6).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from . import layers as L
from .layers import SiteSpec, qlinear
from .llm import layer_views

VIT_SITES = ("q", "k", "v", "o", "fc1", "fc2")


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    width: int
    n_layers: int
    n_heads: int
    mlp_width: int
    patch_dim: int  # flattened patch pixel count (e.g. 2*14*14*3)
    n_pos: int = 0  # learned position embeddings (0 = none)
    norm_kind: str = "ln"  # "ln" pre-fusion, "rmsn" post-fusion
    act: str = "gelu"  # gelu | quick_gelu | gelu_tanh
    rotary_2d: bool = False  # Qwen2-VL vision rotary
    layerscale: bool = False  # InternViT ls1 / ls2 (folded away by fusion)
    norm_eps: float = 1e-6
    head_dim: int = 0
    pre_norm: bool = False  # CLIP-style ln_pre before the blocks
    post_norm: bool = False  # ln_post after the blocks
    dtype: Any = torch.bfloat16

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.width // self.n_heads)


def init_vit_params(cfg: ViTConfig, gen: torch.Generator, dtype=None,
                    device="cuda") -> Dict:
    """Random ViT params in the JAX package's stacked layout (its
    ``init_vit_params`` with q/k/v biases): N(0, 1/fan_in) weights drawn on
    ``gen``'s device (``models.layers.normal_init``), zero biases, unit
    norms (with a zero bias for LayerNorm); with ``layerscale`` ls1 / ls2
    of 0.1, with ``n_pos`` N(0, 0.02²) position embeddings drawn after the
    blocks, with ``pre_norm`` / ``post_norm`` an unbatched ln_pre /
    ln_post."""
    dtype = dtype or cfg.dtype
    Lx, W, M = cfg.n_layers, cfg.width, cfg.mlp_width
    hd, H = cfg.head_dim, cfg.n_heads
    kw = dict(dtype=dtype, device=device)

    def site(din, dout):
        return {"w": L.normal_init(gen, (Lx, din, dout), **kw),
                "b": torch.zeros((Lx, dout), **kw)}

    def norm(*lead):
        d = {"w": torch.ones((*lead, W), **kw)}
        if cfg.norm_kind == "ln":
            d["b"] = torch.zeros((*lead, W), **kw)
        return d

    patch = {"w": L.normal_init(gen, (cfg.patch_dim, W), **kw),
             "b": torch.zeros((W,), **kw)}
    blocks = {"ln1": norm(Lx)}
    blocks.update(q=site(W, H * hd), k=site(W, H * hd), v=site(W, H * hd),
                  o=site(H * hd, W), ln2=norm(Lx), fc1=site(W, M),
                  fc2=site(M, W))
    p = {"patch_embed": patch, "blocks": blocks}
    if cfg.layerscale:
        blocks["ls1"] = {"w": torch.full((Lx, W), 0.1, **kw)}
        blocks["ls2"] = {"w": torch.full((Lx, W), 0.1, **kw)}
    if cfg.n_pos:
        p["pos_embed"] = {"w": L.normal_init(gen, (cfg.n_pos, W), 0.02, **kw)}
    if cfg.pre_norm:
        p["ln_pre"] = norm()
    if cfg.post_norm:
        p["ln_post"] = norm()
    return p


def _norm(cfg: ViTConfig, x, nparams):
    # LayerNorm while the norm keeps its bias, unit RMSNorm once fusion
    # dropped it (the JAX package's rule)
    if cfg.norm_kind == "ln" and nparams.get("b") is not None:
        return L.layer_norm(x, nparams["w"], nparams.get("b"), cfg.norm_eps)
    return L.rms_norm(x, nparams["w"], cfg.norm_eps)


def _act(cfg: ViTConfig, x):
    if cfg.act == "gelu":
        return L.gelu(x)
    if cfg.act == "gelu_tanh":
        return L.gelu_tanh(x)
    if cfg.act == "quick_gelu":
        return x * L.sigmoid(1.702 * x)
    raise ValueError(cfg.act)


def rot2d_tables(grid_hw: torch.Tensor, head_dim: int, theta: float = 10000.0):
    """Qwen2-VL vision 2D rotary: half the rotary channels encode the row
    index, half the column. grid_hw: (..., T, 2) int (row, col)."""
    quarter = head_dim // 4
    exps = torch.arange(quarter, dtype=torch.float32,
                        device=grid_hw.device) / quarter
    inv = 1.0 / (theta ** exps)
    h = grid_hw[..., 0:1].float() * inv
    w_ = grid_hw[..., 1:2].float() * inv
    freqs = torch.cat([h, w_], dim=-1)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def vit_preamble(cfg: ViTConfig, params: Dict, patches: torch.Tensor,
                 specs=None, state=None, mode: str = "fp", tape=None,
                 prefix: str = "vis") -> torch.Tensor:
    """Everything before the blocks (the GPTQ driver's block-0 inputs):
    the patch-embed linear, plus the first T learned position embeddings
    where the tower has them, then a CLIP-style tower's ln_pre and its
    ``fc_sub_mean`` (a float linear, never quantized)."""
    specs = specs or {}
    h = qlinear(patches.to(cfg.dtype), params["patch_embed"],
                f"{prefix}.patch_embed", specs.get(f"{prefix}.patch_embed"),
                state, mode, tape)
    if cfg.n_pos and "pos_embed" in params:
        h = h + params["pos_embed"]["w"][None, :h.shape[1]].to(h.dtype)
    if cfg.pre_norm and "ln_pre" in params:
        h = _norm(cfg, h, params["ln_pre"])
        if "fc_sub_mean" in params:
            h = qlinear(h, params["fc_sub_mean"], f"{prefix}.fc_sub_mean",
                        None, None, "fp")
    return h


def _no_token_mask(token_mask):
    if token_mask is not None:
        raise NotImplementedError("vision token masks (padded patch "
                                  "sequences) are not ported (ROADMAP A6)")


def vit_forward(cfg: ViTConfig, params: Dict, patches: torch.Tensor,
                specs: Optional[Dict[str, SiteSpec]] = None,
                state: Optional[Dict] = None, mode: str = "fp",
                grid_hw: Optional[torch.Tensor] = None, prefix: str = "vis",
                token_mask: Optional[torch.Tensor] = None,
                collect_stats: bool = False, collect_samples: bool = False):
    """patches (B, T, patch_dim), grid_hw (B, T, 2) → (features (B, T, W),
    stats): ``stats`` is None unless ``collect_stats``, then (stats,
    samples) as ``decoder_forward`` gives them, the blocks' sites stacked
    over the layers and the patch embed's unstacked."""
    _no_token_mask(token_mask)
    specs = specs or {}
    B, T, _ = patches.shape
    tape0 = L.Tape(collect_samples) if collect_stats else None
    h = vit_preamble(cfg, params, patches, specs, state, mode, tape0, prefix)
    cos = sin = None
    if cfg.rotary_2d:
        if grid_hw is None:
            raise ValueError("rotary_2d needs grid_hw")
        cos, sin = rot2d_tables(grid_hw, cfg.head_dim)

    site_names = {f"{prefix}.{s}" for s in VIT_SITES}
    lstate_all = None
    if state:
        lstate_all = {k: v for k, v in state.items() if k in site_names} or None
    H, hd = cfg.n_heads, cfg.head_dim

    def site(nm):
        return specs.get(f"{prefix}.{nm}")

    tapes = []
    for li in range(cfg.n_layers):
        bp = layer_views(params["blocks"], li)
        lst = None if lstate_all is None else layer_views(lstate_all, li)
        tape = None
        if collect_stats:
            tape = L.Tape(collect_samples)
            tapes.append(tape)
        x = _norm(cfg, h, bp["ln1"])
        q = qlinear(x, bp["q"], f"{prefix}.q", site("q"), lst, mode, tape)
        k = qlinear(x, bp["k"], f"{prefix}.k", site("k"), lst, mode, tape)
        v = qlinear(x, bp["v"], f"{prefix}.v", site("v"), lst, mode, tape)
        q = q.reshape(B, T, H, hd)
        k = k.reshape(B, T, H, hd)
        v = v.reshape(B, T, H, hd)
        if cos is not None:
            q, k = L.apply_rope(q, k, cos, sin)
        a = L.attention(q, k, v).reshape(B, T, H * hd)
        a = qlinear(a, bp["o"], f"{prefix}.o", site("o"), lst, mode, tape)
        if cfg.layerscale and "ls1" in bp:
            a = a * bp["ls1"]["w"].to(a.dtype)
        h = h + a
        x = _norm(cfg, h, bp["ln2"])
        x = qlinear(x, bp["fc1"], f"{prefix}.fc1", site("fc1"), lst, mode,
                    tape)
        x = _act(cfg, x)
        x = qlinear(x, bp["fc2"], f"{prefix}.fc2", site("fc2"), lst, mode,
                    tape)
        if cfg.layerscale and "ls2" in bp:
            x = x * bp["ls2"]["w"].to(x.dtype)
        h = h + x
    if cfg.post_norm and "ln_post" in params:
        h = _norm(cfg, h, params["ln_post"])
    if not collect_stats:
        return h, None
    stats, samples = L.stack_tapes(tapes) or ({}, {})
    stats.update(tape0.stats)
    samples.update(tape0.samples)
    return h, (stats, samples)


def patchify_2d(images: torch.Tensor, patch: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """images (B, H, W, C) → ((B, T, patch²·C) patches in row-major grid
    order, (B, T, 2) grid coords): a stride = kernel conv's im2col."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, gh * gw, patch * patch * C)
    rows = torch.arange(gh, device=images.device)[:, None].expand(gh, gw)
    cols = torch.arange(gw, device=images.device)[None, :].expand(gh, gw)
    grid = torch.stack([rows, cols], -1).reshape(1, gh * gw, 2)
    return x, grid.to(torch.int32).expand(B, gh * gw, 2)


def patchify_qwen2vl(images: torch.Tensor, patch: int = 14,
                     temporal: int = 2, merge: int = 2
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """images (B, H, W, C) → ((B, T, temporal·patch²·C) patches with each
    merge×merge group contiguous, (B, T, 2) grid coords)."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 2, 4, 5)
    x = torch.stack([x] * temporal, dim=-2)  # (B, gh, gw, p, p, t, C)
    x = x.reshape(B, gh, gw, patch * patch * temporal * C)
    x = x.reshape(B, gh // merge, merge, gw // merge, merge, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, gh * gw, -1)
    a = torch.arange(gh // merge, device=images.device)[:, None, None, None]
    b = torch.arange(gw // merge, device=images.device)[None, :, None, None]
    c = torch.arange(merge, device=images.device)[None, None, :, None]
    d = torch.arange(merge, device=images.device)[None, None, None, :]
    shape = (gh // merge, gw // merge, merge, merge)
    rows = (a * merge + c).expand(shape).reshape(-1)
    cols = (b * merge + d).expand(shape).reshape(-1)
    grid = torch.stack([rows, cols], -1)[None].to(torch.int32)
    return x, grid.expand(B, gh * gw, 2)


@dataclasses.dataclass(frozen=True)
class MergerConfig:
    context_dim: int  # ViT width
    out_dim: int  # LLM hidden
    merge: int = 2
    norm_kind: str = "ln"
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16

    @property
    def in_dim(self) -> int:
        return self.context_dim * self.merge * self.merge


def init_merger_params(cfg: MergerConfig, gen: torch.Generator, dtype=None,
                       device="cuda") -> Dict:
    """Random merger params in the JAX package's layout (its
    ``init_merger_params``): N(0, 1/fan_in) ``mlp0`` / ``mlp2`` drawn on
    ``gen``'s device, zero biases, a unit ``ln_q`` (zero bias for ln)."""
    dtype = dtype or cfg.dtype
    kw = dict(dtype=dtype, device=device)
    D, out = cfg.in_dim, cfg.out_dim
    p = {"ln_q": {"w": torch.ones((cfg.context_dim,), **kw)},
         "mlp0": {"w": L.normal_init(gen, (D, D), **kw),
                  "b": torch.zeros((D,), **kw)},
         "mlp2": {"w": L.normal_init(gen, (D, out), **kw),
                  "b": torch.zeros((out,), **kw)}}
    if cfg.norm_kind == "ln":
        p["ln_q"]["b"] = torch.zeros((cfg.context_dim,), **kw)
    return p


def merger_forward(cfg: MergerConfig, params, x: torch.Tensor, specs=None,
                   state=None, mode="fp", token_mask=None,
                   collect_stats: bool = False, collect_samples: bool = False):
    """x (B, T, context_dim), merge groups contiguous → ((B, T/merge²,
    out_dim), stats): None unless ``collect_stats``, then (stats,
    samples)."""
    _no_token_mask(token_mask)
    specs = specs or {}
    tape = L.Tape(collect_samples) if collect_stats else None
    g = cfg.merge * cfg.merge
    B, T, D = x.shape
    if cfg.norm_kind == "ln" and params["ln_q"].get("b") is not None:
        x = L.layer_norm(x, params["ln_q"]["w"], params["ln_q"]["b"],
                         cfg.norm_eps)
    else:
        x = L.rms_norm(x, params["ln_q"]["w"], cfg.norm_eps)
    x = x.reshape(B, T // g, g * D)
    x = qlinear(x, params["mlp0"], "merger.mlp0", specs.get("merger.mlp0"),
                state, mode, tape)
    x = L.gelu(x)
    x = qlinear(x, params["mlp2"], "merger.mlp2", specs.get("merger.mlp2"),
                state, mode, tape)
    return x, None if tape is None else (tape.stats, tape.samples)
