"""Quantizable LLM decoder — the text tower (counterpart of
``mquant_tpu/models/llm.py``, Qwen2 / Qwen2-VL configuration).

Parameters keep the JAX package's layout: nested dicts of tensors STACKED
along a leading (L,) axis. The forward walks the layers in a Python loop and
takes each layer's view ``w[l]``, which costs nothing; the W4 GEMV kernel
reads such a view as it reads a per-layer matrix.

The KV cache is a dict {"k", "v": (L, B, S, KVH, hd), "pos": 0-d int32
tensor or (B,) per row, "rope_delta": (B,) optional}. Unlike the JAX
version it is updated IN PLACE (one row block per layer and step) to avoid
copying the cache. ``pos`` lives on the cache's device, as JAX's does. On
the card the positions, the cache write (a scatter at pos) and the decode
mask (col ≤ pos over the whole cache, JAX's formulation) derive from it with
no host read, so a decode step can be captured in a CUDA graph
(``serve.generate``). A host int ``pos``, or a 0-d one in a CPU cache, is
read on the host and the written rows are sliced, as before the position
moved to the device (the einsum's f32 sums then keep their order). A (B,)
``pos`` (the slot engine's, ``serve.engine``) is one write offset per row
on any device: the rows pos_b + t are scattered and the mask is
col ≤ pos_b + t over the whole cache, as JAX's vmapped write and per-row
mask. An int8 / int4 cache (``init_cache(quantized=8 | 4)``) adds per-token
per-head scales (and int4 zero points) of shape (L, B, S, KVH); its new rows
are quantized as they are written and attention reads the dequantized cache
through the einsum (never ``attn_decode``).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
from typing import Any, Dict, Optional, Tuple

import torch

from ..core import quant as Q
from . import layers as L
from .layers import SiteSpec, qlinear

# site names within one decoder layer
LLM_SITES = ("q", "k", "v", "o", "gate", "up", "down")


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab: int
    hidden: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    intermediate: int
    head_dim: int = 0
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False  # logits = h · embedᵀ (no lm_head; 2B)
    mrope_sections: Tuple[int, ...] = ()  # Qwen2-VL M-RoPE (t, h, w) sections
    intermediate_pad: int = 0  # Hadamard-friendly padded intermediate
    dtype: Any = torch.bfloat16
    qkv_bias: bool = True  # Qwen1 / Qwen2 style
    o_bias: bool = False
    rope_partial: float = 1.0  # fraction of head_dim that RoPE rotates
    rope_interleaved: bool = False  # ChatGLM's pairwise (re, im) rotary
    use_dynamic_ntk: bool = False  # Qwen-VL long-context NTK theta scaling
    ntk_seq_length: int = 2048  # training length the NTK ratio is taken over

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.hidden // self.n_heads)

    @property
    def inter_eff(self) -> int:
        return self.intermediate_pad or self.intermediate

    @property
    def in_dims(self) -> Dict[str, int]:
        """Input width of each layer site."""
        return {"q": self.hidden, "k": self.hidden, "v": self.hidden,
                "gate": self.hidden, "up": self.hidden,
                "o": self.n_heads * self.head_dim, "down": self.inter_eff}


def init_decoder_params(cfg: DecoderConfig, gen: torch.Generator,
                        dtype=None, device="cuda") -> Dict:
    """Random params in the JAX package's stacked layout (its
    ``init_decoder_params``): N(0, 1/fan_in) weights in ``dtype`` (default
    the config's), embedding and lm_head N(0, 0.02²), unit norms, zero
    q/k/v biases and no o bias (Qwen2's, JAX's defaults), no lm_head where
    the embedding is tied. Drawn on ``gen``'s
    device in JAX's site order and put on ``device``; a CPU generator gives
    the same values on the CPU and on the card. The values are not JAX's
    (another RNG). q/k/v biases only with ``cfg.qkv_bias``, an o bias with
    ``cfg.o_bias`` (zeros, as JAX's)."""
    dtype = dtype or cfg.dtype
    Lx, Hd, KV, hd, I = (cfg.n_layers, cfg.hidden, cfg.n_kv_heads,
                         cfg.head_dim, cfg.inter_eff)
    H = cfg.n_heads
    kw = dict(dtype=dtype, device=device)

    def w(*shape, scale=None):
        return L.normal_init(gen, shape, scale, **kw)

    embed = {"w": w(cfg.vocab, Hd, scale=0.02)}
    layers = {"ln1": {"w": torch.ones((Lx, Hd), **kw)}}
    for name, dout in (("q", H * hd), ("k", KV * hd), ("v", KV * hd)):
        layers[name] = {"w": w(Lx, Hd, dout),
                        "b": torch.zeros((Lx, dout), **kw)
                        if cfg.qkv_bias else None}
    layers["o"] = {"w": w(Lx, H * hd, Hd),
                   "b": torch.zeros((Lx, Hd), **kw) if cfg.o_bias else None}
    layers["ln2"] = {"w": torch.ones((Lx, Hd), **kw)}
    for name, (din, dout) in (("gate", (Hd, I)), ("up", (Hd, I)),
                              ("down", (I, Hd))):
        layers[name] = {"w": w(Lx, din, dout), "b": None}
    params = {"embed": embed, "layers": layers,
              "ln_f": {"w": torch.ones((Hd,), **kw)}}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": w(Hd, cfg.vocab, scale=0.02)}
    return params


# ---------------------------------------------------------------------------
# rope
# ---------------------------------------------------------------------------


def ntk_alpha_for(cfg: DecoderConfig, seq_len: int) -> float:
    """Dynamic-NTK alpha for a prompt of ``seq_len`` tokens (the Qwen-VL
    long-context rule): max(2^ceil(log2(seq_len / ntk_seq_length) + 1) − 1,
    1); 1.0 without ``use_dynamic_ntk``. Decode reuses the prefill's."""
    if not cfg.use_dynamic_ntk:
        return 1.0
    context_value = math.log(max(seq_len, 1) / cfg.ntk_seq_length, 2) + 1
    return float(max(2 ** math.ceil(context_value) - 1, 1))


def rope_tables(cfg: DecoderConfig, positions: torch.Tensor,
                dtype=torch.float32, ntk_alpha=1.0):
    """cos/sin (B, T, rd) for positions (B, T), or for Qwen2-VL M-RoPE
    positions (3, B, T) — (temporal, height, width) planes, with the
    rotated channels split into ``mrope_sections`` consuming one plane
    each; rd = head_dim · rope_partial. ``ntk_alpha`` scales theta by
    alpha^(rd/(rd−2)) (dynamic NTK): a host float, a 0-d tensor (scaled
    unconditionally, an exact no-op at 1), or a (B,) tensor, one alpha per
    row (the slot engine's; not with M-RoPE planes)."""
    rd = int(cfg.head_dim * cfg.rope_partial)
    theta = cfg.rope_theta
    if isinstance(ntk_alpha, torch.Tensor) and ntk_alpha.ndim >= 1:
        if cfg.mrope_sections and positions.ndim == 3:
            raise ValueError("per-row NTK alpha not supported with M-RoPE")
        if positions.ndim == 3:
            positions = positions[0]
        th = theta * ntk_alpha.float()[:, None] ** (rd / (rd - 2))
        exps = torch.arange(0, rd, 2, dtype=torch.float32,
                            device=positions.device) / rd
        inv = th ** -exps[None, :]  # (B, rd/2)
        freqs = positions[..., None].float() * inv[:, None, :]
        emb = torch.cat([freqs, freqs], dim=-1)
        return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)
    if isinstance(ntk_alpha, torch.Tensor):
        theta = theta * ntk_alpha.float() ** (rd / (rd - 2))
    elif ntk_alpha != 1.0:
        theta = theta * ntk_alpha ** (rd / (rd - 2))
    if cfg.mrope_sections and positions.ndim == 3:
        cos3, sin3 = L.rotary_embedding(positions, rd, theta, dtype)
        secs = list(cfg.mrope_sections)
        if sum(secs) != rd // 2:
            raise ValueError(f"mrope_sections {secs} do not cover {rd // 2}")
        # plane[c] = the section of channel c mod rd/2, made on the device
        # (no host copy, so a CUDA graph can capture it)
        chan = torch.arange(rd, device=positions.device)
        half = chan % (rd // 2)
        plane = torch.zeros_like(chan)
        for edge in itertools.accumulate(secs[:-1]):
            plane += half >= edge
        # (3, B, T, rd) → (B, T, rd): channel c reads plane[c]
        return cos3[plane, ..., chan].permute(1, 2, 0), \
            sin3[plane, ..., chan].permute(1, 2, 0)
    if positions.ndim == 3:
        positions = positions[0]
    return L.rotary_embedding(positions, rd, theta, dtype)


def _apply_rope(cfg: DecoderConfig, q, k, cos, sin):
    """RoPE over the first rd = head_dim · rope_partial channels (the rest
    pass through): rotate-half, or ChatGLM's interleaved pairs with
    ``rope_interleaved``."""
    rd = int(cfg.head_dim * cfg.rope_partial)
    rope = _rope_interleaved if cfg.rope_interleaved else L.apply_rope
    if cfg.rope_partial < 1.0:
        q_r, k_r = rope(q[..., :rd], k[..., :rd], cos, sin)
        return (torch.cat([q_r, q[..., rd:]], -1),
                torch.cat([k_r, k[..., rd:]], -1))
    return rope(q, k, cos, sin)


def _rope_interleaved(q, k, cos, sin):
    """ChatGLM's rotary (JAX's ``_rope_core``): channels 2i, 2i + 1 are the
    (re, im) parts of pair i, rotated by the angle at channel i of the
    [freqs, freqs] table."""
    half = q.shape[-1] // 2
    cs = cos[..., :, None, :half]
    sn = sin[..., :, None, :half]

    def rot(v):
        v2 = v.reshape(*v.shape[:-1], half, 2)
        re, im = v2[..., 0], v2[..., 1]
        return torch.stack([re * cs - im * sn, im * cs + re * sn],
                           -1).reshape(v.shape).to(v.dtype)

    return rot(q), rot(k)


# ---------------------------------------------------------------------------
# decoder forward
# ---------------------------------------------------------------------------


def layer_views(tree: Any, l: int) -> Any:
    """Layer ``l`` of a stacked (L, ...) params / state tree (views)."""
    if isinstance(tree, dict):
        return {k: layer_views(v, l) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(None if v is None else layer_views(v, l)
                            for v in tree))
    if isinstance(tree, torch.Tensor):
        return tree[l]
    return tree


def _use_fused_tail(dspec, mode: str, T: int, dp: Dict, act,
                    g: Optional[torch.Tensor] = None) -> bool:
    """Eligibility of ``kernels.fwht.fused_swiglu_had_quant`` (the JAX
    function's gate): the ``MQUANT_FUSED_TAIL`` flag set to "1" (default
    "0": the unfused chain swiglu → ``online_hadamard`` with a bf16 output →
    static int8, whose codes JAX's default makes), real mode, full online
    Hadamard, static symmetric per-tensor int8 activations, no output
    quantizer, integer storage without the RMS split, and a prefill of
    T ≥ 256 with T % 256 == 0. JAX's other gate, the TPU backend, is the
    card here; with the flag on a CPU tensor takes the kernel's plain
    version. For a gate ``g`` on the card, also the kernel's row contract
    (``fwht.tail_supports``: n and bf16); a row outside it takes the chain,
    as JAX's default does. Under a tensor-parallel mesh the chain: a rank's
    g · u holds its own columns, and the full Hadamard mixes all of them
    (``layers.qlinear``'s row-parallel site gathers them first)."""
    from ..kernels import fwht
    from ..parallel.sharding import tp_mesh

    if os.environ.get("MQUANT_FUSED_TAIL", "0") != "1" or tp_mesh():
        return False
    if g is not None and L._on_card(g) and not fwht.tail_supports(
            g.shape[-1], g.dtype):
        return False
    return (mode == "real" and dspec is not None
            and dspec.online_had == "full" and dspec.a_bits == 8
            and dspec.a_static and dspec.a_symmetric
            and dspec.out_bits is None and "w_col0" not in dp
            and "w_q" in dp and act is not None and act.zero_point is None
            and torch.as_tensor(act.scale).ndim == 0
            and T >= 256 and T % 256 == 0)


def _mlp_tail(dspec, mode, g, u, dp, lstate, tape=None, verify=False):
    """swiglu → down-projection. Where :func:`_use_fused_tail` holds, swiglu
    → Hadamard → int8 is one fused kernel and its codes go straight to the
    integer GEMM; otherwise the unfused chain of ``qlinear``. A verify
    window routes as its one-row decode steps do."""
    dstate = None if lstate is None else lstate.get("llm.down")
    act = None if dstate is None else dstate.get("act")
    if _use_fused_tail(dspec, mode, 1 if verify else g.shape[-2], dp, act,
                       g):
        from ..kernels import fwht
        from ..kernels.qmm import quantized_matmul_pre

        q8 = fwht.KERNELS["fused_swiglu_had_quant"](g, u, act.scale)
        y = quantized_matmul_pre(q8, act.scale, dp, g.dtype)
        if dp.get("b") is not None:
            y = y + dp["b"].to(y.dtype)
        return y
    return qlinear(L.swiglu(g, u), dp, "llm.down", dspec, lstate, mode, tape,
                   verify)


def _layer_step(cfg: DecoderConfig, specs: Dict[str, SiteSpec], mode: str,
                h: torch.Tensor, lp: Dict, lstate: Optional[Dict],
                cache_kv: Optional[Tuple[torch.Tensor, torch.Tensor]],
                cache_pos, cos, sin, prefill_fresh: bool,
                attn_mask: Optional[torch.Tensor] = None,
                attn_start: Optional[torch.Tensor] = None,
                fused_decode: bool = False,
                tape: Optional[L.Tape] = None,
                verify: bool = False) -> torch.Tensor:
    """One decoder layer. ``cache_kv`` = this layer's (k, v) cache views
    (B, S, KVH, hd), written in place at rows [cache_pos, cache_pos + T)
    (``cache_pos`` a 0-d device tensor, a host int, or a (B,) tensor: one
    offset per row). ``fused_decode``: the T == 1 cache write and attention
    are one ``kernels.attn_decode`` call (mask start ≤ col ≤ pos).
    ``tape`` collects the layer's calibration stats. ``verify``: the T rows
    are a speculative verify window, run as T decode steps would run them
    (:func:`decoder_forward`)."""
    B, T, _ = h.shape
    hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads

    x = L.per_step(lambda t: L.rms_norm(t, lp["ln1"]["w"], cfg.norm_eps), h,
                   verify)
    q, k, v = L.qlinear_group(x, [lp["q"], lp["k"], lp["v"]],
                              ["llm.q", "llm.k", "llm.v"], specs, lstate,
                              mode, tape, verify)
    q = q.reshape(B, T, H, hd)
    k = k.reshape(B, T, KV, hd)
    v = v.reshape(B, T, KV, hd)
    q, k = _apply_rope(cfg, q, k, cos, sin)

    def attend(q, k, v, pos):
        return _attend(cfg, q, k, v, cache_kv, pos, prefill_fresh, attn_mask,
                       attn_start, fused_decode)

    if verify and T > 1:
        # one query row at a time, each at its own position: the cache
        # writes and attention reads of T decode steps
        attn = torch.cat([attend(q[:, j:j + 1].contiguous(),
                                 k[:, j:j + 1].contiguous(),
                                 v[:, j:j + 1].contiguous(), cache_pos + j)
                          for j in range(T)], dim=1)
    else:
        attn = attend(q, k, v, cache_pos)
    attn = attn.reshape(B, T, H * hd)
    h = h + qlinear(attn, lp["o"], "llm.o", specs.get("llm.o"), lstate, mode,
                    tape, verify)
    x = L.per_step(lambda t: L.rms_norm(t, lp["ln2"]["w"], cfg.norm_eps), h,
                   verify)
    g, u = L.qlinear_group(x, [lp["gate"], lp["up"]], ["llm.gate", "llm.up"],
                           specs, lstate, mode, tape, verify)
    return h + _mlp_tail(specs.get("llm.down"), mode, g, u, lp["down"],
                         lstate, tape, verify)


def _kv_quant8(val: torch.Tensor):
    """(…, hd) → int8 codes and a per-(…) symmetric scale amax / 127, the
    division rounded as inside the JAX package's jitted decoder."""
    v32 = val.float()
    scale = torch.clamp(Q._over(v32.abs().amax(-1), 127.0, True), min=1e-8)
    qv = torch.clamp(torch.round(v32 / scale[..., None]), -127, 127)
    return qv.to(torch.int8), scale


def _kv_pack4(val: torch.Tensor):
    """(…, hd) → nibble-packed uint4 codes (…, hd/2) (channel 2i in the low
    nibble) with a per-(…) asymmetric scale (max − min) / 15 and zero
    point, rounded as inside the JAX package's jitted decoder."""
    v32 = val.float()
    mn, mx = v32.amin(-1), v32.amax(-1)
    scale = torch.clamp(Q._over(mx - mn, 15.0, True), min=1e-8)
    zp = torch.clamp(torch.round(-mn / scale), 0, 15)
    q = torch.clamp(torch.round(v32 / scale[..., None]) + zp[..., None],
                    0, 15).to(torch.uint8)
    return q[..., 0::2] | (q[..., 1::2] << 4), scale, zp


def _kv_unpack4(packed: torch.Tensor, scale: torch.Tensor, zp: torch.Tensor,
                out_dtype) -> torch.Tensor:
    """Inverse of :func:`_kv_pack4`: (…, hd/2) uint8 → (…, hd)."""
    lo = (packed & 0xF).float()
    hi = (packed >> 4).float()
    q = torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)
    return ((q - zp[..., None]) * scale[..., None]).to(out_dtype)


def kv_kind(cache: Dict) -> int:
    """The cache's storage, by its dtype as in the JAX package: 8 for int8
    codes with per-token-per-head scales, 4 for nibble-packed uint4 with
    scales and zero points, 0 for float K/V."""
    return {torch.int8: 8, torch.uint8: 4}.get(cache["k"].dtype, 0)


def _kv_entries(kind: int, k: torch.Tensor, v: torch.Tensor) -> Dict:
    """The new rows of every cache tensor for k / v (B, T, KVH, hd)."""
    if kind == 4:
        kq, ks, kz = _kv_pack4(k)
        vq, vs, vz = _kv_pack4(v)
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs, "k_zp": kz,
                "v_zp": vz}
    if kind == 8:
        kq, ks = _kv_quant8(k)
        vq, vs = _kv_quant8(v)
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return {"k": k, "v": v}


def _kv_read(kind: int, cache_kv: Dict, S, dtype):
    """Float K / V (B, S', KVH, hd) of the cache's first S rows (S None:
    every row), dequantized for an int8 / int4 cache."""
    def rows(name):
        t = cache_kv[name]
        return t if S is None else t[:, :S]

    if kind == 4:
        return tuple(_kv_unpack4(rows(n), rows(n + "_scale"),
                                 rows(n + "_zp"), dtype) for n in ("k", "v"))
    if kind == 8:
        return tuple((rows(n).float() * rows(n + "_scale")[..., None]
                      ).to(dtype) for n in ("k", "v"))
    return rows("k"), rows("v")


def _attend(cfg: DecoderConfig, q, k, v, cache_kv, cache_pos,
            prefill_fresh: bool, attn_mask, attn_start,
            fused_decode: bool) -> torch.Tensor:
    """The attention of one layer (q (B, T, H, hd), k / v (B, T, KVH, hd)
    post-rope): the cache write at rows [cache_pos, cache_pos + T) and the
    read, by ``kernels.attn_decode`` where ``fused_decode``, else the
    einsum under the mask :func:`_layer_step` describes. ``cache_kv`` is
    the layer's dict of cache views (B, S, …): "k" / "v", and for an int8
    cache their per-token-per-head "k_scale" / "v_scale", for an int4 cache
    also "k_zp" / "v_zp"; the new rows are quantized as they are written
    and the attention reads the dequantized cache (a fresh prefill attends
    its own float K/V)."""
    B, T = q.shape[:2]
    mask = attn_mask
    causal = cache_kv is None and attn_mask is None
    if fused_decode:
        from ..kernels import attn_decode
        from ..parallel.sharding import tp_mesh, whole_kv_heads

        # a tensor-parallel rank plans its splits for the whole model's heads
        kw = {} if tp_mesh() is None else {
            "plan_kvh": whole_kv_heads(cfg, tp_mesh())}
        attn, _, _ = attn_decode.KERNELS["attn_decode"](
            q, k, v.contiguous(), cache_kv["k"], cache_kv["v"], cache_pos,
            cfg.head_dim**-0.5, start=attn_start, **kw)
        return attn
    if cache_kv is None:
        return L.attention(q, k, v, mask, causal=causal)
    kind = kv_kind(cache_kv)
    new = _kv_entries(kind, k, v)
    per_row = (isinstance(cache_pos, torch.Tensor) and cache_pos.ndim == 1)
    host = not per_row and not (isinstance(cache_pos, torch.Tensor)
                                and L._on_card(cache_pos))
    S = cache_kv["k"].shape[1]
    if per_row:
        # rows start_b + arange(T), start_b = pos_b clamped so the window
        # fits, as JAX's vmapped dynamic_update_slice clamps
        start = cache_pos.to(torch.long).clamp(0, S - T)
        rows = start[:, None] + torch.arange(T, device=q.device)
        for name, val in new.items():
            buf = cache_kv[name]
            idx = rows.reshape(B, T, *([1] * (val.ndim - 2))).expand(
                val.shape)
            buf.scatter_(1, idx, val.to(buf.dtype))
    elif host:  # a host int, or a position in host memory
        cache_pos = int(cache_pos)
        if cache_pos + T > S:  # JAX's window would clamp onto the last rows
            raise ValueError(f"KV write of rows [{cache_pos}, "
                             f"{cache_pos + T}) past the cache of {S}")
        for name, val in new.items():
            cache_kv[name][:, cache_pos:cache_pos + T] = val.to(
                cache_kv[name].dtype)
    else:  # rows pos + arange(T), scattered on the device
        rows = cache_pos + torch.arange(T, device=q.device)
        for name, val in new.items():
            cache_kv[name].index_copy_(1, rows, val.to(cache_kv[name].dtype))
    if prefill_fresh:
        # attend to the local T rows: causally, or by the caller's
        # (B, 1, T, T) mask (a left-padded ragged batch)
        k_all, v_all, causal = k, v, attn_mask is None
    elif attn_mask is not None:
        k_all, v_all = _kv_read(kind, cache_kv, None, q.dtype)
    elif per_row:
        # the (B, 1, T, S) mask col ≤ pos_b + t over the whole cache
        # (JAX's); V's columns no row reads (≥ pos_b + T) are zeroed, so a
        # stale tail of any value (C-w1), its scales included, adds an
        # exact 0 · 0 where the einsum's masked probabilities are 0
        cols = torch.arange(S, device=q.device)
        rows = (cache_pos.to(torch.long)[:, None]
                + torch.arange(T, device=q.device))  # (B, T)
        mask = (cols[None, None] <= rows[:, :, None])[:, None]
        if attn_start is not None:  # exclude left-pad columns
            mask = mask & (cols[None, None, None] >=
                           attn_start.reshape(-1, 1, 1, 1))
        unread = cols[None] > rows[:, -1:]  # (B, S)
        k_all, v_all = _kv_read(kind, cache_kv, None, q.dtype)
        v_all = v_all.masked_fill(unread[:, :, None, None], 0)
    else:
        # rows ≥ pos + T hold stale or unwritten KV: the mask col ≤ pos + t
        # keeps them out, over the whole cache for a position on the card
        # (JAX's formulation, no host read; V's columns ≥ pos + T zeroed, so
        # a stale tail of any value adds an exact 0 · 0, C-w1) or over the
        # written prefix where the position is on the host (a read that
        # costs no sync; the softmax and P·V sums keep the prefix's length,
        # so their f32 order)
        if host:
            S = cache_pos + T
        k_all, v_all = _kv_read(kind, cache_kv, S, q.dtype)
        rows = cache_pos + torch.arange(T, device=q.device)[:, None]
        cols = torch.arange(S, device=q.device)[None, :]
        mask = (cols <= rows)[None, None]
        if not host:  # V's unread columns zeroed, as on the per-row path
            v_all = v_all.masked_fill((cols > rows[-1:])[0, :, None, None], 0)
        if attn_start is not None:  # exclude left-pad columns
            mask = mask & (cols[None, None] >=
                           attn_start.reshape(-1, 1, 1, 1))
    return L.attention(q, k_all.to(q.dtype), v_all.to(q.dtype), mask,
                       causal=causal)


def _use_fused_decode_attn(cfg: DecoderConfig, cache: Optional[Dict], T: int,
                           prefill_fresh: bool, attn_mask) -> bool:
    """Eligibility of ``kernels.attn_decode`` (the JAX function of the same
    name): only where its built-in mask (attn_start ≤ col ≤ pos) is exactly
    what the einsum path would derive — T == 1, a live cache that is not
    being filled fresh, no caller mask — on an fp cache of the model's dtype
    with hd % 128 == 0 and H % KVH == 0. JAX's two further gates, the 12 MB
    VMEM budget and S % 8 (its 8-row write-back window), are TPU scratch
    limits, not semantics, and are not carried over. JAX's ``MQUANT_ATTN``
    default leaves decode attention to its XLA einsum after a TPU A/B; the
    port takes its kernel wherever it is eligible. A cache on the card must
    also meet the kernel's contract (``attn_decode.supports``); outside it
    the step takes the einsum, JAX's route where its own gate says no."""
    from ..kernels import attn_decode

    if attn_mask is not None or cache is None or prefill_fresh or T != 1:
        return False
    if cache["k"].dtype != cfg.dtype:
        return False
    if L._on_card(cache["k"]) and not attn_decode.supports(
            cfg.head_dim, cfg.n_heads // cfg.n_kv_heads, cache["k"].dtype):
        return False
    return cfg.head_dim % 128 == 0 and cfg.n_heads % cfg.n_kv_heads == 0


def decoder_forward(cfg: DecoderConfig, params: Dict,
                    tokens_or_embeds: torch.Tensor,
                    specs: Optional[Dict[str, SiteSpec]] = None,
                    state: Optional[Dict] = None, mode: str = "fp",
                    cache: Optional[Dict] = None,
                    positions: Optional[torch.Tensor] = None,
                    attn_mask: Optional[torch.Tensor] = None,
                    last_index=None, prefill_fresh: bool = False,
                    attn_start: Optional[torch.Tensor] = None,
                    collect_stats: bool = False,
                    collect_samples: bool = False, verify: bool = False,
                    ntk_alpha=None):
    """Full decoder forward. Returns (logits, cache, stats): ``stats`` is
    None unless ``collect_stats`` (mode "calib"), then (stats, samples),
    each site's ObserverStats stacked over the layers (leading (L,) axes)
    and, with ``collect_samples``, each static site's raw inputs (L, N, C).

    ``tokens_or_embeds``: (B, T) token ids or (B, T, hidden) embeddings.
    ``positions``: (B, T), or (3, B, T) for M-RoPE; default: the cache
    offset + arange(T), plus the cache's ``rope_delta`` when present (M-RoPE
    decode continues at max(prefill positions) + 1).
    ``attn_mask``: optional (B, 1, T, S) bool (True = attend); with
    ``prefill_fresh`` S == T and it replaces the plain causal mask (a
    left-padded ragged batch: causal and col ≥ the row's start).
    ``last_index``: compute logits only at this position — an int / 0-d
    tensor shared by all rows, or a (B,) tensor with one position per row.
    ``prefill_fresh``: the cache is empty; write it and attend to the local
    T rows causally (or by ``attn_mask``).
    ``attn_start``: optional (B,) int first attendable cache column per row
    (left-padded ragged batches: pad columns hold garbage K/V); composes with
    the derived causal mask, and goes to the fused decode kernel as its
    ``start``.
    ``verify``: the T tokens are a speculative verify window at the cache
    position (``serve.speculative``, ``serve.engine``): row j gets the
    logits that the decode step at position pos + j gives, bit for bit.
    Attention takes the decode step's route (``attn_decode`` where it would
    for T = 1) one query row at a time at position pos + j; every product
    and row reduction whose rounding may depend on its row count (the norms,
    the float products, the online Hadamard's, the head) runs on each
    step's B rows apart (``layers.per_step``); the integer products, exact
    in int32 with a per-element epilogue, take the whole window in one call.
    ``ntk_alpha``: the dynamic-NTK alpha (:func:`rope_tables`); None
    derives it from T for a prefill (no cache, or ``prefill_fresh``) and
    takes 1.0 for a decode step (decode callers pass the prefill's).
    The cache (if given; float, int8 or int4, :func:`init_cache`) is updated
    in place and returned with ``pos`` advanced by T.

    Under a tensor-parallel mesh (``parallel.sharding.set_mesh``) ``cfg``
    and ``params`` are this rank's (``sharding.local_config``,
    ``sharding.shard_params``), the cache holds its KV heads, and the
    logits come back whole on every rank (the vocabulary gathered, its
    padding dropped). Calibration and int8 / int4 KV raise there."""
    from ..parallel.sharding import refuse_under_mesh

    if collect_stats:
        refuse_under_mesh("calibration", "A14c")
    if cache is not None and kv_kind(cache):
        refuse_under_mesh("int8 / int4 KV (paths K8 / K4)", "A14b")
    specs = specs or {}
    if tokens_or_embeds.ndim == 2:
        h = params["embed"]["w"][tokens_or_embeds].to(cfg.dtype)
    else:
        h = tokens_or_embeds.to(cfg.dtype)
    B, T = h.shape[:2]
    pos0 = cache["pos"] if cache is not None else 0

    if positions is None:
        steps = torch.arange(T, device=h.device)
        if isinstance(pos0, torch.Tensor) and pos0.ndim == 1:  # per row
            positions = pos0[:, None] + steps[None]
        else:
            positions = (pos0 + steps)[None].expand(B, T)
        if cache is not None and "rope_delta" in cache:
            positions = positions + cache["rope_delta"][:, None]
    if ntk_alpha is None:
        ntk_alpha = (ntk_alpha_for(cfg, T)
                     if cache is None or prefill_fresh else 1.0)
    cos, sin = rope_tables(cfg, positions, torch.float32, ntk_alpha)

    layer_names = {"llm." + s for s in LLM_SITES}
    lstate_all = None
    if state:
        lstate_all = {k: v for k, v in state.items() if k in layer_names} or None

    fused = _use_fused_decode_attn(cfg, cache, 1 if verify else T,
                                   prefill_fresh, attn_mask)
    if attn_start is not None:  # once per step: the kernel takes it as is
        attn_start = torch.as_tensor(attn_start, device=h.device).to(
            torch.int32).reshape(-1).contiguous()
    tapes = []
    for li in range(cfg.n_layers):
        lp = layer_views(params["layers"], li)
        lst = None if lstate_all is None else layer_views(lstate_all, li)
        ckv = None if cache is None else {
            n: t[li] for n, t in cache.items() if n not in _CACHE_SCALARS}
        tape = None
        if collect_stats:
            tape = L.Tape(collect_samples)
            tapes.append(tape)
        h = _layer_step(cfg, specs, mode, h, lp, lst, ckv, pos0, cos, sin,
                        prefill_fresh, attn_mask, attn_start, fused, tape,
                        verify)

    if last_index is not None and not isinstance(last_index, torch.Tensor):
        h = h[:, int(last_index):int(last_index) + 1]  # a host index
    elif last_index is not None:  # a tensor index: no host read
        li = last_index.to(device=h.device, dtype=torch.long)
        if li.ndim == 1:
            h = torch.take_along_dim(h, li[:, None, None], dim=1)
        else:
            h = h.index_select(1, li.reshape(1))
    h = L.per_step(lambda t: L.rms_norm(t, params["ln_f"]["w"],
                                        cfg.norm_eps), h, verify)
    if cfg.tie_embeddings:
        emb = params["embed"]["w"].T.to(h.dtype)
        logits = L.per_step(lambda t: t @ emb, h, verify)
    else:
        logits = qlinear(h, params["lm_head"], "llm.lm_head",
                         specs.get("llm.lm_head"), state, mode, verify=verify)
        if logits.shape[-1] > cfg.vocab:  # a gathered, padded vocabulary
            logits = logits[..., :cfg.vocab]
    if cache is not None:
        cache = dict(cache)
        cache["pos"] = pos0 + T
    return logits, cache, L.stack_tapes(tapes)


# cache entries without a leading (L,) axis
_CACHE_SCALARS = ("pos", "rope_delta", "ntk_alpha")


def init_cache(cfg: DecoderConfig, batch: int, max_len: int, dtype=None,
               device="cuda", quantized=False) -> Dict:
    """KV cache (L, B, max_len, KVH, hd) on the card unless ``device`` says
    otherwise, its ``pos`` a 0-d int32 tensor there. ``quantized`` ∈
    {False, True / 8, 4}: bf16 (or ``dtype``) K/V; int8 codes with f32
    per-token-per-head symmetric scales ``k_scale`` / ``v_scale`` (half the
    bytes); nibble-packed uint4 codes (two per byte along hd) with f32
    per-token-per-head asymmetric scales and zero points ``k_zp`` / ``v_zp``
    (a quarter). The dtype of "k" tells them apart (:func:`kv_kind`).
    Under a tensor-parallel mesh ``cfg`` is the rank's local config (its KV
    heads) and the quantized caches raise."""
    if quantized:
        from ..parallel.sharding import refuse_under_mesh

        refuse_under_mesh("int8 / int4 KV (paths K8 / K4)", "A14b")
    dtype = dtype or cfg.dtype
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    kw = dict(device=device)
    f32 = dict(dtype=torch.float32, device=device)
    pos = torch.zeros((), dtype=torch.int32, device=device)
    if int(quantized) == 4:
        if cfg.head_dim % 2:
            raise ValueError(f"int4 KV needs an even head_dim, got "
                             f"{cfg.head_dim}")
        half = shape[:-1] + (cfg.head_dim // 2,)
        return {"k": torch.zeros(half, dtype=torch.uint8, **kw),
                "v": torch.zeros(half, dtype=torch.uint8, **kw),
                "k_scale": torch.zeros(shape[:-1], **f32),
                "v_scale": torch.zeros(shape[:-1], **f32),
                "k_zp": torch.zeros(shape[:-1], **f32),
                "v_zp": torch.zeros(shape[:-1], **f32), "pos": pos}
    if quantized:
        return {"k": torch.zeros(shape, dtype=torch.int8, **kw),
                "v": torch.zeros(shape, dtype=torch.int8, **kw),
                "k_scale": torch.zeros(shape[:-1], **f32),
                "v_scale": torch.zeros(shape[:-1], **f32), "pos": pos}
    return {"k": torch.zeros(shape, dtype=dtype, **kw),
            "v": torch.zeros(shape, dtype=dtype, **kw), "pos": pos}
