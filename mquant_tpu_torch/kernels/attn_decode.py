"""Fused one-token GQA decode attention (counterpart of
``mquant_tpu/kernels/attn_decode.py``).

One call per layer and step: the new token's K/V row is written into the
cache at row ``pos`` and q attends to the cache columns ``start ≤ col < pos``
plus the new token, carried as a separate softmax term (the JAX kernel's
algebra: m = max(max scores, s_new), denom = Σ exp + exp(s_new − m),
out = P·V + p_new·v_new). :func:`attn_decode` launches the hand-written CUDA
kernel ``mq_attn_decode`` (``csrc/attn.cu``: one launch; split-S blocks on
the tensor cores, the last block of each (batch row, KV head) merges the
partials, adds the new token and writes the row) for a CUDA tensor, or
raises; :func:`attn_decode_ref` is its plain version, taken only for a CPU
tensor. ``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch

# kernel launches (read and reset by chip_smoke.py)
LAUNCHES: Dict[str, int] = {"attn_decode": 0}

HEAD_DIM = 128  # the kernel's head width
MAX_GROUP = 16  # query heads per KV head: the rows of one m16 MMA tile
_MIN_COLS = 16  # at least this many cache columns per block
_MAX_SPLITS = 256  # the merge's shared-memory table
# arrival counters of the kernel's last-block merge, one buffer per device
# (zero between calls: the merging block resets its counter). Calls on one
# device must not overlap, so they run on one stream, as the decoder's do.
_COUNTERS: Dict[int, torch.Tensor] = {}
_COUNTERS_MIN = 1024


def _rows(x, B: int, device) -> torch.Tensor:
    """A scalar or (B,) index as a contiguous (B,) int32 tensor on
    ``device`` (a host int becomes a fill, never a host-to-device copy)."""
    if not isinstance(x, torch.Tensor):
        return torch.full((B,), int(x), dtype=torch.int32, device=device)
    t = x.to(device=device, dtype=torch.int32).reshape(-1)
    if t.numel() not in (1, B):
        raise ValueError(f"attn_decode: an index of {t.numel()} rows for a "
                         f"batch of {B}")
    return (t.expand(B) if t.numel() == 1 else t).contiguous()


def _per_row(x, B: int, device):
    """For the kernel: (None, x) for a host int, which goes by value (no
    fill kernel per layer), or ((B,) int32 tensor, 0), a no-op for a
    decode step's int32 (B,) tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return _rows(x, B, device), 0
    return None, int(x)


def _check_shapes(q, k_new, v_new, k_cache, v_cache):
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"attn_decode: q must be (B, 1, H, hd), got "
                         f"{tuple(q.shape)}")
    B, _, H, hd = q.shape
    if k_cache.ndim != 4 or k_cache.shape[0] != B or k_cache.shape[3] != hd \
            or v_cache.shape != k_cache.shape:
        raise ValueError("attn_decode: caches must be (B, S, KVH, hd) and "
                         "match q")
    KVH = k_cache.shape[2]
    if H % KVH or k_new.shape != (B, 1, KVH, hd) or \
            v_new.shape != (B, 1, KVH, hd):
        raise ValueError("attn_decode: k_new / v_new must be (B, 1, KVH, hd) "
                         "with H % KVH == 0")
    return B, H, hd, k_cache.shape[1], KVH


def attn_decode_ref(q, k_new, v_new, k_cache, v_cache, pos, scale: float,
                    start=None, plan_kvh=None):
    """Plain version of :func:`attn_decode` (``plan_kvh``, the kernel's
    split plan, changes nothing here), with the JAX kernel's math: f32
    scores over columns start ≤ col < pos, the new token as a separate
    softmax term, probabilities rounded to the cache dtype before P·V, f32
    accumulation; no value outside the columns read reaches the output. Returns (attn (B, 1, H, hd), k_cache, v_cache) with the
    caches written in place at row ``pos`` of each batch row."""
    B, H, hd, S, KVH = _check_shapes(q, k_new, v_new, k_cache, v_cache)
    G = H // KVH
    dev = q.device
    p = _rows(pos, B, dev).long()
    st = _rows(0 if start is None else start, B, dev).long()
    kn = k_new.to(k_cache.dtype).reshape(B, KVH, 1, hd)
    vn = v_new.to(v_cache.dtype).reshape(B, KVH, 1, hd)
    qg = q.reshape(B, KVH, G, hd).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * scale
    cols = torch.arange(S, device=dev)[None]
    valid = (cols >= st[:, None]) & (cols < p[:, None])  # (B, S)
    scores = scores.masked_fill(~valid[:, None, None], -1e30)
    snew = (qg * kn.float()).sum(-1, keepdim=True) * scale  # (B, KVH, G, 1)
    m = torch.maximum(scores.amax(-1, keepdim=True), snew)
    e = torch.exp(scores - m)
    en = torch.exp(snew - m)
    denom = e.sum(-1, keepdim=True) + en
    probs = (e / denom).to(v_cache.dtype).float()
    pnew = (en / denom).to(v_cache.dtype).float()
    # V's columns outside the mask weigh 0 but are zeroed too, so a NaN
    # stale tail stays out (0 · NaN is NaN) as it does in the kernel,
    # which never reads them
    v = v_cache.float().masked_fill(~valid[:, :, None, None], 0.0)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v)
    out = out + pnew * vn.float()
    rows = torch.arange(B, device=dev)
    k_cache[rows, p] = kn[:, :, 0]
    v_cache[rows, p] = vn[:, :, 0]
    return out.to(q.dtype).reshape(B, 1, H, hd), k_cache, v_cache


def supports(hd: int, G: int, dtype: torch.dtype) -> bool:
    """The kernel's contract: head_dim 128, at most ``MAX_GROUP`` query heads
    per KV head, bf16 operands. The wrapper raises on a CUDA tensor outside
    it, and ``models.llm._use_fused_decode_attn`` routes by it."""
    return hd == HEAD_DIM and 1 <= G <= MAX_GROUP and dtype == torch.bfloat16


def _check_card(q, k_new, v_new, k_cache, v_cache) -> None:
    """Raises unless the kernel takes these operands: :func:`supports`,
    one dtype, contiguous, one device."""
    name = "attn_decode"
    B, H, hd, S, KVH = _check_shapes(q, k_new, v_new, k_cache, v_cache)
    ts = (q, k_new, v_new, k_cache, v_cache)
    dtypes = {t.dtype for t in ts}
    if len(dtypes) != 1 or not supports(hd, H // KVH, q.dtype):
        raise ValueError(f"{name}: needs bf16 q, k/v and caches, head_dim == "
                         f"{HEAD_DIM} and H / KVH <= {MAX_GROUP}, got "
                         f"{sorted(map(str, dtypes))}, {hd}, {H // KVH}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: operands must be contiguous")
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"{name}: tensors on several devices")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan(B: int, KVH: int, n_cols: int, sms: int) -> int:
    """Column splits per (batch row, KV head): about one block per SM (each
    split's partial is read back by the merging block, so fewer, longer
    splits than two a SM), at least ``_MIN_COLS`` columns a block, at most
    ``_MAX_SPLITS``. ``n_cols`` bounds the columns of any row (the cache
    length where pos or start lie on the device)."""
    want = -(-sms // (B * KVH))
    return max(1, min(want, -(-n_cols // _MIN_COLS), _MAX_SPLITS))


def _split_ranges(start: int, pos: int, splits: int) -> list:
    """The kernel's columns [lo, hi) of each split of one row (csrc/attn.cu,
    decode_attn_kernel): ceil((pos − start) / splits) columns each from
    start, clipped to pos; trailing splits may be empty."""
    n = max(pos - start, 0)
    chunk = -(-n // splits)
    return [(start + s * chunk, min(pos, start + (s + 1) * chunk))
            for s in range(splits)]


def _counters(device, n: int) -> torch.Tensor:
    """The device's zeroed arrival counters (at least ``n``). A new buffer
    is made only outside CUDA-graph capture (a capture would not run its
    fill): call once eagerly before capturing."""
    buf = _COUNTERS.get(device.index)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("attn_decode: its counters are allocated at "
                               "the first call; call it once before a CUDA "
                               "graph capture")
        buf = torch.zeros(max(n, _COUNTERS_MIN), dtype=torch.int32,
                          device=device)
        _COUNTERS[device.index] = buf
    return buf


def attn_decode(q, k_new, v_new, k_cache, v_cache, pos, scale: float,
                start=None, plan_kvh=None):
    """One-token GQA decode attention with the cache write, in one launch
    (CUDA kernel ``mq_attn_decode``).

    ``q`` (B, 1, H, hd) post-rope; ``k_new`` / ``v_new`` (B, 1, KVH, hd);
    ``k_cache`` / ``v_cache`` the layer's (B, S, KVH, hd) cache views;
    ``pos`` and ``start`` a host int, a 0-d tensor or a (B,) int tensor (per
    row: the slot engine's ``pos``, a left-padded batch's ``start``).
    Returns (attn (B, 1, H, hd), k_cache, v_cache) as the JAX function does,
    but the caches are updated IN PLACE (row ``pos`` of each batch row) and
    the returned caches are the same tensors. Attention covers
    start ≤ col < pos of the cache and the new token; no other column is
    read. On CUDA: bf16, hd == 128, H / KVH ≤ 16, contiguous operands.
    ``plan_kvh``: the KV heads the column splits are planned for (default
    KVH). A tensor-parallel rank passes the whole model's, so each head's
    columns split, and its partials merge, as on one rank (bit-equal): the
    plan fills the SMs by B · KVH, and a rank's fewer heads would take more
    splits."""
    name = "attn_decode"
    B, H, hd, S, KVH = _check_shapes(q, k_new, v_new, k_cache, v_cache)
    if q.device.type == "cpu":
        return attn_decode_ref(q, k_new, v_new, k_cache, v_cache, pos, scale,
                               start)
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    _check_card(q, k_new, v_new, k_cache, v_cache)
    if isinstance(pos, int) and not 0 <= pos < S:
        raise ValueError(f"{name}: pos {pos} outside the cache of {S} rows")
    pos_t, pos_v = _per_row(pos, B, q.device)
    start_t, start_v = _per_row(0 if start is None else start, B, q.device)
    # host ints bound the columns read; device indices may reach row S
    n_cols = S if pos_t is not None or start_t is not None else pos_v - start_v
    splits = _plan(B, plan_kvh or KVH, n_cols, _sm_count(q.device.index))
    G = H // KVH
    counters = _counters(q.device, B * KVH)
    out = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    part = torch.empty((B * KVH * splits * G * (4 + hd),),
                       dtype=torch.float32, device=q.device)
    from ._build import load

    lib = load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    status = lib.mq_attn_decode(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), ptr(pos_t), ptr(start_t), out.data_ptr(),
        part.data_ptr(), counters.data_ptr(), pos_v, start_v, B, S, H, KVH,
        splits, float(scale), stream)
    LAUNCHES[name] += 1
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status}")
    return out, k_cache, v_cache


# the kernel or its plain version, looked up at call time by the decoder
# (chip_smoke.py swaps PLAIN in for its on-card reference forward)
KERNELS = {"attn_decode": attn_decode}
PLAIN = {"attn_decode": attn_decode_ref}
