"""Perceiver-style resampler (counterpart of
``mquant_tpu/models/resampler.py``): a fixed set of learned queries
cross-attends over the vision tower's output and projects to the LLM
width. Qwen-VL's ``attn_pool`` (256 queries, width 4096, keys and values
from the 1664-wide tower through ``kv_proj``, a learned key position
table ``pos_embed_kv``, ``proj_fc`` into the LLM) is the layout the JAX
package's loader writes, with separate q / k / v / out linears.

Quant sites: ``res.kv_proj``, ``res.q``, ``res.k``, ``res.v``, ``res.out``,
``res.proj_fc``, each through ``layers.qlinear``. The cross-attention is
the non-causal einsum of ``layers.attention``. A norm keeps its bias
before fusion (LayerNorm) and loses it after (unit RMSNorm), as the ViT's.
MiniCPM-V's resampler is the same layout on a SigLIP tower: 64 queries,
width 3584, ``kv_proj`` from 1152. A padded patch sequence (MiniCPM-V's
adaptive resolution, valid patches first) comes with its key mask: the
queries attend to the valid keys only, and the calibration tape leaves the
padded rows out of the key / value path's stats (``kv_proj``, ``k``,
``v``); a caller may give the key position table per resolution
(``pos_embed_kv``, e.g. ``buckets.resampler_pos_table``'s sincos rows).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..parallel.sharding import tp_mesh
from . import layers as L
from .layers import SiteSpec, qlinear

RES_SITES = ("kv_proj", "q", "k", "v", "out", "proj_fc")


@dataclasses.dataclass(frozen=True)
class ResamplerConfig:
    n_queries: int  # 256 (Qwen-VL) / 64 (MiniCPM-V)
    width: int  # the resampler's embedding width
    kv_dim: int  # the vision tower's output width
    n_heads: int
    out_dim: int = 0  # proj_fc's output (0: no proj_fc)
    has_kv_proj: bool = True  # kv_dim → width projection
    norm_kind: str = "ln"
    norm_eps: float = 1e-6
    use_pos_embed: bool = True
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self):
        return self.width // self.n_heads


def init_resampler_params(cfg: ResamplerConfig, gen: torch.Generator,
                          n_pos: int = 1024, dtype=None,
                          device="cuda") -> Dict:
    """Random resampler params in the JAX package's layout (its
    ``init_resampler_params``): N(0, 0.02²) queries, N(0, 1/fan_in)
    weights drawn on ``gen``'s device, zero biases, unit norms with zero
    biases for LayerNorm, an N(0, 0.02²) key position table of ``n_pos``
    rows (other values than JAX's RNG)."""
    dtype = dtype or cfg.dtype
    kw = dict(dtype=dtype, device=device)
    W = cfg.width

    def lin(i, o, bias=True):
        return {"w": L.normal_init(gen, (i, o), **kw),
                "b": torch.zeros((o,), **kw) if bias else None}

    def norm():
        d = {"w": torch.ones((W,), **kw)}
        if cfg.norm_kind == "ln":
            d["b"] = torch.zeros((W,), **kw)
        return d

    p: Dict[str, Any] = {
        "query": {"w": L.normal_init(gen, (cfg.n_queries, W), 0.02, **kw)},
        "ln_q": norm(), "ln_kv": norm(),
        "q": lin(W, W), "k": lin(W, W), "v": lin(W, W), "out": lin(W, W),
        "ln_post": norm()}
    if cfg.has_kv_proj:
        p["kv_proj"] = lin(cfg.kv_dim, W, bias=False)
    if cfg.out_dim:
        p["proj_fc"] = lin(W, cfg.out_dim)
    if cfg.use_pos_embed:
        p["pos_embed_kv"] = {"w": L.normal_init(gen, (n_pos, W), 0.02, **kw)}
    return p


def sincos_2d_pos_embed(dim: int, gh: int, gw: int) -> np.ndarray:
    """The 2-D sin-cos position table (gh·gw, dim) in float64 on the host
    (MiniCPM-V's per-resolution key positions), computed as the JAX
    function computes it."""
    if dim % 4:
        raise ValueError(f"dim {dim} is not a multiple of 4")
    d4 = dim // 4
    omega = 1.0 / (10000.0 ** (np.arange(d4) / d4))
    ys, xs = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")

    def enc(pos):
        a = pos.reshape(-1, 1) * omega[None, :]
        return np.concatenate([np.sin(a), np.cos(a)], axis=1)

    return np.concatenate([enc(ys.astype(np.float64)),
                           enc(xs.astype(np.float64))], axis=1)


def resampler_forward(cfg: ResamplerConfig, params: Dict,
                      kv_feats: torch.Tensor,
                      specs: Optional[Dict[str, SiteSpec]] = None,
                      state: Optional[Dict] = None, mode: str = "fp",
                      key_mask: Optional[torch.Tensor] = None,
                      pos_embed_kv: Optional[torch.Tensor] = None,
                      collect_stats: bool = False,
                      collect_samples: bool = False, prefix: str = "res"):
    """kv_feats (B, S, kv_dim) → (out (B, n_queries, out_dim or width),
    stats): None unless ``collect_stats``, then (stats, samples) of the
    resampler's sites. ``pos_embed_kv`` (S, width) replaces the first S
    rows of the learned key position table. ``key_mask`` (B, S), 1 = a
    valid key: the attention's key mask, and the tape's mask on the key /
    value path (the queries' side, out and proj_fc are always valid)."""
    specs = specs or {}
    tape = L.Tape(collect_samples) if collect_stats else None
    if tape is not None:
        tape.mask = key_mask

    def nrm(x, np_):
        if cfg.norm_kind == "ln" and np_.get("b") is not None:
            return L.layer_norm(x, np_["w"], np_["b"], cfg.norm_eps)
        return L.rms_norm(x, np_["w"], cfg.norm_eps)

    def qlin(x, name, masked=None):
        if tape is not None and masked is not None:
            tape.mask = key_mask if masked else None
        return qlinear(x, params[name], f"{prefix}.{name}",
                       specs.get(f"{prefix}.{name}"), state, mode, tape)

    B, S, _ = kv_feats.shape
    x = kv_feats.to(cfg.dtype)
    if cfg.has_kv_proj and "kv_proj" in params:
        x = qlin(x, "kv_proj")
    kv = nrm(x, params["ln_kv"])
    if (pos_embed_kv is None and cfg.use_pos_embed
            and "pos_embed_kv" in params):
        pos_embed_kv = params["pos_embed_kv"]["w"][:S]
    k_in = kv if pos_embed_kv is None else kv + pos_embed_kv[None].to(
        kv.dtype)
    q_in = nrm(params["query"]["w"][None].to(cfg.dtype), params["ln_q"])
    q_in = q_in.expand(B, cfg.n_queries, cfg.width)

    q = qlin(q_in, "q", masked=False)
    k = qlin(k_in, "k", masked=True)
    v = qlin(kv, "v", masked=True)
    hd = cfg.head_dim  # the heads: all of them, or a tp rank's share
    mask = None if key_mask is None else key_mask[:, None, None, :] > 0
    attn = L.attention(q.reshape(B, cfg.n_queries, -1, hd),
                       k.reshape(B, S, -1, hd), v.reshape(B, S, -1, hd), mask)
    out = qlin(attn.reshape(B, cfg.n_queries, -1), "out", masked=False)
    out = nrm(out, params["ln_post"])
    if "proj_fc" in params:
        mesh = tp_mesh()
        if mesh is not None:  # row-parallel on a whole input: its columns
            n = out.shape[-1] // mesh.tp
            out = out[..., mesh.tp_index * n:(mesh.tp_index + 1) * n]
        out = qlin(out, "proj_fc", masked=False)
    return out, None if tape is None else (tape.stats, tape.samples)
