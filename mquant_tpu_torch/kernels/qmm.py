"""Real integer quantized matmul for the serving path (W8A8 / W4A8)
(counterpart of ``mquant_tpu/kernels/qmm.py``).

Weight storage, as in the JAX package (``quantize_weights_real``):
  * ``w_q``      int8 (in, out) for W8; for W4 **split-half packed**
                 (in/2, out): byte row r holds nibble rows r (low) and
                 r + in/2 (high).
  * ``w_scale``  f32 (out,) per-output-channel symmetric scale.

Three hand-written CUDA kernels (``csrc/qmm.cu``) carry the int8 compute:

  * :func:`w4a8_gemv` — packed-W4 GEMV, M ≤ 32 (decode q|k|v, o, gate|up,
    down); replaces ``_qmm_pallas_w4_stacked`` / ``_qmm_pallas_w4`` (M ≤ 32).
    A stacked ``(L, in/2, out)`` weight's layer is the view ``w[l]``, so one
    kernel serves both of the TPU forms. One launch: TMA streams W once,
    ``mma.sync`` on the tensor cores takes every token row (at M = 1 the
    same kernel streams W into registers for ``__dp4a``, which the card
    runs faster there), the K splits of a channel tile meet in a thread
    block cluster (:func:`_gemv_plan`).
  * :func:`int8_gemv` — int8-weight GEMV, M ≤ 32, any K and N (the int8
    lm_head, the RMS split's K = 18943 ``down``); replaces
    ``_qmm_pallas_gemv``. :func:`w4a8_gemv`'s one launch with the int8
    bytes as the tensor cores' operands: W read once for any M ≤ 32, its
    stages loaded by TMA, 8-byte cp.async or the producer's lanes as N and
    the weight's alignment allow (:func:`int8_gemv_supports`).
  * :func:`int8_gemm` — int8 GEMM, M > 32, W4 packed or W8 (prefill, ViT,
    merger, the RMS split's K = 18943 ``down``, full-logit lm_heads);
    replaces ``_qmm_pallas_w4``'s M > 32 branch and the XLA s8 dots beside
    it. A TMA + wgmma kernel for the shapes of :func:`tma_supports`, the
    same kernel with W's tile written by threads (:func:`int8_gemm_ragged`,
    its own launch count) for any other N and packed W4 with
    (K/2) % 16 != 0.

and two more the decode probes use (``mquant_tpu_torch.scripts``):

  * :func:`w8_bf16_gemv` — bf16 x (M ≤ 8) against int8 weights converted to
    bf16 in registers, products on the tensor cores, f32 sums × per-channel
    scale → bf16 (:func:`w4a8_gemv`'s one-launch design); replaces
    ``scripts/gemv_bench.py::w8_bf16_gemv_pallas``.
  * :func:`w4_unpack_gemv` — the packed-W4 GEMV to int32 with the nibbles
    unpacked by one of the probe's variants P0-P3; replaces
    ``scripts/w4_unpack_tune.py::pallas_gemv`` (``mq_w4a8_gemv``'s one
    tensor-core launch with the unpack as a template parameter, at every
    M).

Each wrapper launches its kernel for a CUDA tensor (or raises) and takes its
plain PyTorch version (``*_ref``) only for a CPU tensor. ``LAUNCHES`` counts
the kernel launches of each wrapper. ``out_dtype=torch.int32`` returns the
raw int32 accumulator (the bit-exact check of the integer dot).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional

import torch

from ..core import quant as Q
from ..core.formats import INT8, get_format

# kernel launches per wrapper (read and reset by chip_smoke.py)
LAUNCHES: Dict[str, int] = {"w4a8_gemv": 0, "int8_gemv": 0, "int8_gemm": 0,
                            "int8_gemm_ragged": 0, "w8_bf16_gemv": 0,
                            "w4_unpack_gemv": 0, "group_epilogue": 0}

GEMV_MAX_M = 32
# the W4 GEMV's launch plan (csrc/qmm.cu, gemv_tc_kernel): 128 channels a
# block, K split in steps of 32 packed rows across at most 8 blocks (one
# thread block cluster, the portable size)
GEMV_TILE_N, GEMV_STEP_ROWS, GEMV_MAX_CLUSTER = 128, 32, 8
PROBE_MAX_M = 8  # rows of the probes' GEMVs (the JAX probes' M = 8 tile)
# w4_unpack_gemv's variants (w4_unpack_tune.py's P0-P3)
W4_VARIANTS = {0: "P0 packed-dot bound", 1: "P1 i32 mask/where",
               2: "P2 int8 arith shifts", 3: "P3 i32 shifts"}
_OUT_KIND = {torch.bfloat16: 0, torch.float32: 1, torch.int32: 2}


class ActQ:
    """Quantized activation: int8 ``q`` (..., C), ``scale`` broadcastable
    against the GEMM output (scalar or per-token (..., 1); (..., G), one per
    token and channel group, with ``groupsize``), optional integer zero
    point ``zp`` of the scale's shape (x ≈ scale · (q − zp))."""

    __slots__ = ("q", "scale", "zp", "groupsize")

    def __init__(self, q, scale, zp=None, groupsize=None):
        self.q = q
        self.scale = scale
        self.zp = zp
        self.groupsize = groupsize


def _act_int8(x: torch.Tensor, spec, site_state, p=None) -> ActQ:
    """Quantize an activation to int8 per the site spec (every configuration
    of the JAX function):

      * static per-tensor scales, sym or asym (asym codes and zero point in
        the unsigned convention, both shifted by 128 so storage is int8);
      * static per-channel scales, only where they were folded into the
        weights at realize time (the ``a_fold`` marker): per-channel codes
        round(x / s_ch) with unit dequant scale; asym needs the realize-time
        ``a_corr`` row, which the GEMM epilogue adds;
      * dynamic per-token or per-tensor scales, sym or asym;
      * dynamic per-token-per-group scales (``spec.a_groupsize``): scale
        (…, G), for the group-blocked epilogue."""
    if spec.a_static and site_state is not None and site_state.get("act") is not None:
        qp = site_state["act"]
        s = torch.as_tensor(qp.scale)

        def codes(qp):
            if qp.zero_point is None:
                return Q.quantize(x, qp, INT8, _codes_out(x)), None
            q = torch.round(x.float() / qp.scale) + qp.zero_point
            q = (torch.clamp(q, 0, 255) - 128.0).to(torch.int8)
            return q, qp.zero_point - 128.0

        if s.ndim >= 1 and s.shape[-1] == x.shape[-1] and x.shape[-1] > 1:
            if p is None or "a_fold" not in p:
                raise NotImplementedError(
                    "per-channel static activation scales require "
                    "realize-time folding into the weights (realize with the "
                    "calibrated state so the a_fold marker is stored)")
            q, zp = codes(qp)
            if zp is not None and "a_corr" not in p:
                raise NotImplementedError(
                    "per-channel asymmetric static act scales require the "
                    "realize-time a_corr row (realize with the calibrated "
                    "state)")
            return ActQ(q, torch.ones((), dtype=torch.float32,
                                      device=x.device), None)
        q, zp = codes(qp)
        return ActQ(q, qp.scale, zp)
    gs = getattr(spec, "a_groupsize", None)
    if gs:
        C = x.shape[-1]
        assert C % gs == 0, (C, gs)
        xg = x.reshape(*x.shape[:-1], C // gs, gs)
        qp = Q.dynamic_qparams(xg, INT8, axis=-1, symmetric=spec.a_symmetric,
                               clip_ratio=spec.a_clip_ratio)
        q = Q.quantize(xg, qp, INT8).reshape(x.shape)
        zp = None if qp.zero_point is None else qp.zero_point[..., 0]
        return ActQ(q, qp.scale[..., 0], zp, groupsize=gs)
    qp = Q.dynamic_qparams(x, INT8, axis=-1 if spec.a_per_token else None,
                           symmetric=spec.a_symmetric,
                           clip_ratio=spec.a_clip_ratio)
    return ActQ(Q.quantize(x, qp, INT8, _codes_out(x)), qp.scale,
                qp.zero_point)


def _codes_out(x: torch.Tensor) -> Optional[torch.Tensor]:
    """Where the codes of x (…, K) will meet the int8 GEMM (more than
    GEMV_MAX_M token rows) and K is no multiple of 16 (the RMS split's
    18943), empty int8 codes (…, K) as a view of rows padded to a multiple
    of 16 bytes, which the TMA GEMM reads in place (:func:`tma_supports`);
    else None (contiguous codes)."""
    K = x.shape[-1]
    if K % 16 == 0 or x.numel() <= GEMV_MAX_M * K:
        return None
    buf = torch.empty((*x.shape[:-1], -(-K // 16) * 16), dtype=torch.int8,
                      device=x.device)
    return buf[..., :K]


def quantize_weights_real(w: torch.Tensor, bits: int, pack: bool = True,
                          scale: Optional[torch.Tensor] = None,
                          zero: Optional[torch.Tensor] = None
                          ) -> Dict[str, Any]:
    """Offline: fp weight (in, out) → real-int storage.

    With ``scale``/``zero`` (shapes (G_or_1, out)) the codes are recovered
    losslessly as round(w / s) + z; asym codes and zero points are shifted by
    2^(b−1) so storage is int8. Without them, a per-out-channel symmetric
    minmax grid. W4 sym non-grouped codes are split-half packed."""
    wf = w.float()
    fmt = get_format(bits, signed=zero is None)
    out: Dict[str, Any] = {}
    if scale is not None:
        s = torch.as_tensor(scale, dtype=torch.float32, device=w.device)
        s2 = s if s.ndim == 2 else s.reshape(1, -1)
        G = s2.shape[0]
        n = wf.shape[0]
        srows = torch.repeat_interleave(s2, n // G, dim=0)
        q = torch.round(wf / srows)
        if zero is not None:
            off = float(2 ** (bits - 1))
            z2 = torch.as_tensor(zero, dtype=torch.float32, device=w.device)
            z2 = z2 if z2.ndim == 2 else z2.reshape(1, -1)
            q = q + torch.repeat_interleave(z2, n // G, dim=0)
            q = torch.clamp(q, fmt.qmin, fmt.qmax) - off
            out["w_zp"] = z2 - off
            q = q.to(torch.int8)
        else:
            q = torch.clamp(q, fmt.qmin, fmt.qmax).to(torch.int8)
        out["w_scale"] = s2[0] if G == 1 and zero is None else s2
        grouped = G > 1 or zero is not None
    else:
        amax = wf.abs().amax(dim=0)
        s1 = torch.clamp(amax / fmt.qmax, min=1e-8)
        q = torch.clamp(torch.round(wf / s1[None, :]), fmt.qmin,
                        fmt.qmax).to(torch.int8)
        out["w_scale"] = s1
        grouped = False
    out["w_q"] = pack_int4_split(q) if bits == 4 and pack and not grouped else q
    return out


def pack_int4_split(q: torch.Tensor) -> torch.Tensor:
    """int4 codes in int8 storage (..., in, out) → split-half packed bytes
    (..., in/2, out)."""
    half = q.shape[-2] // 2
    assert q.shape[-2] == 2 * half, q.shape
    lo = q[..., :half, :].to(torch.uint8) & 0x0F
    hi = q[..., half:, :].to(torch.uint8) & 0x0F
    return (lo | (hi << 4)).view(torch.int8)


def unpack_int4_weights(p: Dict[str, Any]) -> torch.Tensor:
    """Split-half packed (..., in/2, out) → int8 (..., in, out)."""
    u = p["w_q"]
    lo = ((u & 0x0F) ^ 8) - 8  # sign-extend the low nibble
    hi = torch.bitwise_right_shift(u, 4)  # arithmetic: int8 is signed
    return torch.cat([lo, hi], dim=-2)


# shared-input site groups that fuse into ONE decode GEMM (q/k/v on the ln1
# output, gate/up on the ln2 output)
_FUSE_GROUPS = (("q", "k", "v"), ("gate", "up"))


def pack_w4_sites(layer_params: Dict[str, Any], specs, in_dims: Dict[str, int],
                  prefix: str = "llm.", fuse_groups: bool = True
                  ) -> Dict[str, Any]:
    """Re-store 4-bit sites' int8 ``w_q`` as split-half packed bytes.

    With ``fuse_groups`` the shared-input groups (q/k/v, gate/up) are
    concatenated along the output axis into ONE packed matrix: each member
    gets ``w_q_fused``/``w_scale_fused`` (the same tensor) and drops its own
    ``w_q``; ``qlinear_group`` then runs one GEMM per group. Already-packed
    and split sites (``w_col0``: odd rows, or a tensor-parallel rank's even
    share of them) pass through untouched."""

    def packable(name, site):
        spec = specs.get(prefix + name) if specs else None
        if (spec is None or getattr(spec, "w_bits", None) != 4
                or not isinstance(site, dict)):
            return False
        wq = site.get("w_q")
        if wq is None or wq.dtype != torch.int8:
            return False
        expected = in_dims.get(name)
        return (expected is not None and wq.shape[-2] == expected
                and expected % 2 == 0 and "w_col0" not in site)

    def group_servable(group):
        sps = [specs.get(prefix + n) for n in group]
        s0 = sps[0]
        return (s0 is not None and all(s == s0 for s in sps)
                and s0.a_bits == 8 and s0.online_had is None
                and not s0.split and s0.out_bits is None)

    out = dict(layer_params)
    fused_names = set()
    if fuse_groups:
        for group in _FUSE_GROUPS:
            if not all(n in layer_params and packable(n, layer_params[n])
                       for n in group):
                continue
            if not group_servable(group):
                continue
            sites = [layer_params[n] for n in group]
            if any(s["w_scale"].ndim != sites[0]["w_scale"].ndim
                   for s in sites):
                continue
            if any(s.get("w_zp") is not None or "a_perm" in s for s in sites):
                continue
            fused = torch.cat([pack_int4_split(s["w_q"]) for s in sites], dim=-1)
            fscale = torch.cat([s["w_scale"] for s in sites], dim=-1)
            for n, s in zip(group, sites):
                d = {k: v for k, v in s.items() if k != "w_q"}
                d["w_q_fused"] = fused
                d["w_scale_fused"] = fscale
                out[n] = d
            fused_names.update(group)
    for name, site in layer_params.items():
        if name in fused_names or not packable(name, site):
            continue
        s = dict(site)
        s["w_q"] = pack_int4_split(site["w_q"])
        out[name] = s
    return out


# ---------------------------------------------------------------------------
# plain versions (exact integer dots) and the kernel wrappers
# ---------------------------------------------------------------------------


def _epilogue(acc: torch.Tensor, x_scale: torch.Tensor, w_scale: torch.Tensor,
              out_dtype: torch.dtype) -> torch.Tensor:
    """int32 acc (M, N) → (acc · x_scale) · w_scale in f32, then out_dtype
    (the order of the JAX epilogues, qmm.py:549/:577)."""
    if out_dtype == torch.int32:
        return acc
    y = (acc.float() * x_scale.reshape(-1, 1)) * w_scale.float().reshape(1, -1)
    return y.to(out_dtype)


def dequant_acc(acc: torch.Tensor, x_scale, w_scale: torch.Tensor,
                out_dtype: torch.dtype) -> torch.Tensor:
    """The kernels' fused epilogue on its own: int32 acc (…, N) with the
    per-token (…,) or per-tensor ``x_scale`` and the per-channel (N,)
    ``w_scale`` → :func:`_epilogue`'s ((acc · x_scale) · w_scale) in f32,
    then ``out_dtype``. A row-parallel site (``models.layers``) applies it
    once to the accumulators summed across its ranks."""
    N = acc.shape[-1]
    a2 = acc.reshape(-1, N)
    M = a2.shape[0]
    xs = torch.as_tensor(x_scale, dtype=torch.float32, device=acc.device)
    xs = xs.reshape(-1).expand(M) if xs.numel() == 1 else xs.reshape(M)
    return _epilogue(a2, xs, w_scale, out_dtype).reshape(acc.shape)


def _exact_dot(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) · int8 (K, N) → int32, exact. float64 carries every product
    and partial sum exactly (|acc| ≤ 127² · K < 2^53), and it runs on the CPU
    and on the card alike."""
    return (xq.double() @ w.double()).to(torch.int32)


def w4a8_gemv_ref(xq, x_scale, w_packed, w_scale, out_dtype=torch.bfloat16):
    """Plain version of :func:`w4a8_gemv`."""
    w = unpack_int4_weights({"w_q": w_packed})
    return _epilogue(_exact_dot(xq, w), x_scale, w_scale, out_dtype)


def int8_gemv_ref(xq, x_scale, w, w_scale, out_dtype=torch.bfloat16):
    """Plain version of :func:`int8_gemv`."""
    return _epilogue(_exact_dot(xq, w), x_scale, w_scale, out_dtype)


def int8_gemm_ref(xq, x_scale, w, w_scale, out_dtype=torch.bfloat16,
                  packed: bool = False):
    """Plain version of :func:`int8_gemm`."""
    if packed:
        w = unpack_int4_weights({"w_q": w})
    return _epilogue(_exact_dot(xq, w), x_scale, w_scale, out_dtype)


def w8_bf16_gemv_ref(x, w, w_scale):
    """Plain version of :func:`w8_bf16_gemv`: Σ_k x·w in float64 (every
    product of a bf16 and an int8 is exact there, and the sum rounds far
    below f32), cast to f32, × w_scale in f32, then bf16. No TF32 or
    reduced-precision flag of cuBLAS can move it."""
    acc = (x.double() @ w.double()).float()
    return (acc * w_scale.float().reshape(1, -1)).to(torch.bfloat16)


def w4_unpack_gemv_ref(xq, w_packed, variant: int):
    """Plain version of :func:`w4_unpack_gemv`, exact in float64 (|acc| ≤
    128² · K < 2^53): P1-P3 x · unpack(W), the W4 product of
    :func:`w4a8_gemv_ref`; P0 x[:, :K/2] · int8(packed bytes)."""
    _variant(variant)
    if variant == 0:
        return _exact_dot(xq[:, :w_packed.shape[0]], w_packed)
    return _exact_dot(xq, unpack_int4_weights({"w_q": w_packed}))


def _check_args(name, xq, x_scale, w, w_scale, out_dtype, packed, max_m=None,
                x_rows=False):
    """Validate a kernel call; returns (M, K, N). Raises on anything the
    kernels do not take. With ``x_rows`` xq's rows may lie at any stride
    ≥ K (unit column stride), as the TMA GEMM reads them."""
    if xq.dtype != torch.int8 or xq.ndim != 2 or not (
            xq.is_contiguous() or x_rows and xq.stride(1) == 1
            and xq.stride(0) >= xq.shape[1]):
        raise ValueError(f"{name}: xq must be contiguous int8 (M, K)"
                         + (" or rows at a stride >= K" if x_rows else ""))
    if w.dtype != torch.int8 or w.ndim != 2 or not w.is_contiguous():
        raise ValueError(f"{name}: w must be contiguous int8 2-D")
    M, K = xq.shape
    N = w.shape[1]
    if w.shape[0] != (K // 2 if packed else K) or (packed and K % 2):
        raise ValueError(f"{name}: w {tuple(w.shape)} does not match K={K} "
                         f"(packed={packed})")
    if x_scale.dtype != torch.float32 or x_scale.shape != (M,) or \
            not x_scale.is_contiguous():
        raise ValueError(f"{name}: x_scale must be contiguous f32 (M,)")
    if w_scale.dtype != torch.float32 or w_scale.shape != (N,) or \
            not w_scale.is_contiguous():
        raise ValueError(f"{name}: w_scale must be contiguous f32 (N,)")
    if out_dtype not in _OUT_KIND:
        raise ValueError(f"{name}: out_dtype {out_dtype} not supported")
    devs = {t.device for t in (xq, x_scale, w, w_scale)}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {devs}")
    if max_m is not None and M > max_m:
        raise ValueError(f"{name}: M={M} > {max_m}")
    return M, K, N


def _raise_on_status(name: str, status: int):
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def gemv_supports(M: int, K: int, N: int) -> bool:
    """The contract of the W4 GEMV kernel (``mq_w4a8_gemv``): 1 ≤ M ≤ 32
    token rows, an even K (split-half packing) and N % 16 == 0 (TMA's
    16-byte row stride; every channel quad of a block lies inside N or
    outside it). Any packed row count and any x alignment."""
    return 1 <= M <= GEMV_MAX_M and K >= 2 and K % 2 == 0 and N >= 16 \
        and N % 16 == 0


def _check_gemv(name: str, M: int, K: int, N: int, w: torch.Tensor) -> None:
    """Raises unless the W4 GEMV kernel takes the call: :func:`gemv_supports`
    and a 16-byte aligned weight (TMA's base address)."""
    if not gemv_supports(M, K, N) or w.data_ptr() % 16:
        raise ValueError(f"{name}: needs 1 <= M <= {GEMV_MAX_M}, an even K, "
                         f"N % 16 == 0 and a 16-byte aligned weight, got "
                         f"M={M}, K={K}, N={N}")


def int8_gemv_supports(M: int, K: int, N: int) -> bool:
    """The contract of the int8 GEMV kernel (``mq_int8_gemv``): 1 ≤ M ≤ 32
    token rows, any K ≥ 1 and any N ≥ 1, x's rows contiguous (stride K) at
    any alignment. Any weight alignment: the kernel streams W by TMA where
    N % 16 == 0 and the weight is 16-byte aligned, by 8-byte cp.async where
    N % 8 == 0 and it is 8-byte aligned, and by its producer warp's word
    loads otherwise, so no shape of an int8 site at M ≤ 32 is refused."""
    return 1 <= M <= GEMV_MAX_M and K >= 1 and N >= 1


def _gemv_plan(K: int, N: int, sms: int, packed: bool = True) -> tuple:
    """(channel tiles, K splits, rows per split) of the one-launch
    tensor-core GEMVs over the weight's rows (K/2 packed rows of the W4
    GEMV, K int8 rows of :func:`int8_gemv` and :func:`w8_bf16_gemv`): the
    splits of a tile form one cluster (≤ GEMV_MAX_CLUSTER blocks) and take
    whole 32-row steps, so
    that the grid gives every SM about two blocks; the last split may be
    shorter, none is empty. The plan does not depend on M: every token row
    meets each W byte in the same block."""
    R = K // 2 if packed else K
    tiles = -(-N // GEMV_TILE_N)
    steps = -(-R // GEMV_STEP_ROWS)
    splits = max(1, min(GEMV_MAX_CLUSTER, -(-2 * sms // tiles), steps))
    rps = -(-steps // splits) * GEMV_STEP_ROWS
    return tiles, -(-R // rps), rps


def _variant(variant: int) -> None:
    if variant not in W4_VARIANTS:
        raise ValueError(f"w4_unpack_gemv: variant must be one of "
                         f"{sorted(W4_VARIANTS)}, got {variant}")


def w8_bf16_gemv(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor
                 ) -> torch.Tensor:
    """y (M, N) bf16 = bf16((Σ_k x·bf16(w) in f32) · w_scale) for bf16 x
    (M ≤ 8, K), int8 w (K, N) row-major and f32 w_scale (N elements); CUDA
    kernel ``mq_w8_bf16_gemv``: one launch on :func:`_gemv_plan` over K rows,
    bf16 products on the tensor cores, f32 sums merged in a fixed order
    (deterministic). Every column is computed (the JAX probe's grid drops N
    mod its tile, ROADMAP C-w8). Any K; N % 8 == 0 and 8-byte aligned rows
    (TMA streams W where N % 16 == 0, cp.async where N % 16 == 8)."""
    name = "w8_bf16_gemv"
    if x.dtype != torch.bfloat16 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous bf16 (M, K)")
    if w.dtype != torch.int8 or w.ndim != 2 or not w.is_contiguous() or \
            w.shape[0] != x.shape[1]:
        raise ValueError(f"{name}: w must be contiguous int8 (K, N) with "
                         f"K = {x.shape[1]}, got {tuple(w.shape)}")
    M, N = x.shape[0], w.shape[1]
    if w_scale.dtype != torch.float32 or w_scale.numel() != N or \
            not w_scale.is_contiguous():
        raise ValueError(f"{name}: w_scale must be contiguous f32 with {N} "
                         "elements")
    if len({x.device, w.device, w_scale.device}) != 1:
        raise ValueError(f"{name}: tensors on several devices")
    if not 1 <= M <= PROBE_MAX_M:
        raise ValueError(f"{name}: needs 1 <= M <= {PROBE_MAX_M}, got {M}")
    if x.device.type == "cpu":
        return w8_bf16_gemv_ref(x, w, w_scale)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if N % 8 or w.data_ptr() % 8:
        raise ValueError(f"{name}: needs N % 8 == 0 and 8-byte aligned "
                         f"weight rows, got N={N}")
    from ._build import load

    K = x.shape[1]
    _, splits, rps = _gemv_plan(K, N, _sm_count(x.device.index), packed=False)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = load().mq_w8_bf16_gemv(x.data_ptr(), w.data_ptr(),
                                    w_scale.data_ptr(), out.data_ptr(), M, K,
                                    N, splits, rps, stream)
    LAUNCHES[name] += 1
    _raise_on_status(name, status)
    return out


def w4_unpack_gemv(xq: torch.Tensor, w_packed: torch.Tensor, variant: int
                   ) -> torch.Tensor:
    """int32 (M, N) for int8 xq (M ≤ 8, K), K even, and split-half packed W4
    (K/2, N) (a layer view of an (L, K/2, N) stack): variant 1-3 (P1 i32
    mask/where, P2 int8 shifts, P3 i32 shifts) give x · unpack(W), the W4
    product; variant 0 (P0) gives x[:, :K/2] · int8(packed), the probe's
    packed-stream bound. CUDA kernel ``mq_w4_unpack_gemv``: the served
    :func:`w4a8_gemv`'s one tensor-core launch (its plan, TMA ring and
    cluster K-split) with the variant's unpack in front of the products, at
    every M (no ``__dp4a`` row); every row of W is reduced (the JAX probe's
    K grid drops K/2 mod its tile, ROADMAP C-w8). N % 16 == 0."""
    name = "w4_unpack_gemv"
    _variant(variant)
    if xq.dtype != torch.int8 or xq.ndim != 2 or not xq.is_contiguous():
        raise ValueError(f"{name}: xq must be contiguous int8 (M, K)")
    M, K = xq.shape
    if w_packed.dtype != torch.int8 or w_packed.ndim != 2 or \
            not w_packed.is_contiguous() or K % 2 or \
            w_packed.shape[0] != K // 2:
        raise ValueError(f"{name}: w_packed must be contiguous int8 (K/2, N) "
                         f"for an even K = {K}, got {tuple(w_packed.shape)}")
    if xq.device != w_packed.device:
        raise ValueError(f"{name}: tensors on several devices")
    if not 1 <= M <= PROBE_MAX_M:
        raise ValueError(f"{name}: needs 1 <= M <= {PROBE_MAX_M}, got {M}")
    if xq.device.type == "cpu":
        return w4_unpack_gemv_ref(xq, w_packed, variant)
    if xq.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {xq.device}")
    N = w_packed.shape[1]
    _check_gemv(name, M, K, N, w_packed)
    from ._build import load

    acc = torch.empty((M, N), dtype=torch.int32, device=xq.device)
    _, splits, rps = _gemv_plan(K, N, _sm_count(xq.device.index))
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    status = load().mq_w4_unpack_gemv(xq.data_ptr(), w_packed.data_ptr(),
                                      acc.data_ptr(), M, K, N, splits, rps,
                                      variant, stream)
    LAUNCHES[name] += 1
    _raise_on_status(name, status)
    return acc


def w4a8_gemv(xq, x_scale, w_packed, w_scale, out_dtype=torch.bfloat16):
    """y (M, N) = ((x·W) · x_scale) · w_scale for int8 x (M ≤ 32, K) and
    split-half packed W4 (K/2, N); CUDA kernel ``mq_w4a8_gemv``, one launch
    (no workspace: ``out_dtype=torch.int32`` is the accumulator itself).
    On CUDA: :func:`gemv_supports` and a 16-byte aligned weight."""
    name = "w4a8_gemv"
    M, K, N = _check_args(name, xq, x_scale, w_packed, w_scale, out_dtype,
                          True, max_m=GEMV_MAX_M)
    if xq.device.type == "cpu":
        return w4a8_gemv_ref(xq, x_scale, w_packed, w_scale, out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {xq.device}")
    _check_gemv(name, M, K, N, w_packed)
    from ._build import load

    _, splits, rps = _gemv_plan(K, N, _sm_count(xq.device.index))
    out = torch.empty((M, N), dtype=out_dtype, device=xq.device)
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    status = load().mq_w4a8_gemv(
        xq.data_ptr(), w_packed.data_ptr(), x_scale.data_ptr(),
        w_scale.data_ptr(), out.data_ptr(), M, K, N, splits, rps,
        _OUT_KIND[out_dtype], stream)
    LAUNCHES[name] += 1
    _raise_on_status(name, status)
    return out



def int8_gemv(xq, x_scale, w, w_scale, out_dtype=torch.bfloat16):
    """y (M, N) = ((x·W) · x_scale) · w_scale for int8 x (M ≤ 32, K) and
    int8 W (K, N), any K and N (the RMS split's 18943 rows of ``down``, the
    published lm_heads' vocabularies); CUDA kernel ``mq_int8_gemv``, one
    launch on :func:`_gemv_plan` over K rows (no workspace, memset or
    atomics: ``out_dtype=torch.int32`` is the accumulator itself). On CUDA:
    :func:`int8_gemv_supports`."""
    name = "int8_gemv"
    M, K, N = _check_args(name, xq, x_scale, w, w_scale, out_dtype, False,
                          max_m=GEMV_MAX_M)
    if xq.device.type == "cpu":
        return int8_gemv_ref(xq, x_scale, w, w_scale, out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {xq.device}")
    if not int8_gemv_supports(M, K, N):
        raise ValueError(f"{name}: needs 1 <= M <= {GEMV_MAX_M}, K >= 1 and "
                         f"N >= 1, got M={M}, K={K}, N={N}")
    from ._build import load

    _, splits, rps = _gemv_plan(K, N, _sm_count(xq.device.index),
                                packed=False)
    out = torch.empty((M, N), dtype=out_dtype, device=xq.device)
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    status = load().mq_int8_gemv(
        xq.data_ptr(), w.data_ptr(), x_scale.data_ptr(), w_scale.data_ptr(),
        out.data_ptr(), M, K, N, splits, rps, _OUT_KIND[out_dtype], stream)
    LAUNCHES[name] += 1
    _raise_on_status(name, status)
    return out


def tma_supports(K: int, N: int, packed: bool) -> bool:
    """The shapes the TMA + wgmma GEMM (``mq_int8_gemm``) takes. TMA needs
    16-byte row strides: N % 16 == 0 (W's rows), and for packed W4
    (K/2) % 16 == 0. On int8 weights any K: TMA zero-fills W's rows and x's
    columns past K, so the RMS split's K = 18943 ``down`` runs here. x's
    rows must lie at a stride that is a multiple of 16 bytes, on a 16-byte
    aligned base: ``_act_int8`` writes such codes for every K that is no
    multiple of 16 (:func:`_codes_out`), and :func:`int8_gemm` copies any
    other x into padded rows once (one (M, K) copy, stated, never on the
    served path). Every served product of the 7B prefill, the ViT and the
    merger meets it; other N (the lm_heads of N = 92553 and 151666) and
    packed W4 with (K/2) % 16 != 0 do not, and :func:`int8_gemm` sends
    those to :func:`int8_gemm_ragged`."""
    return K >= 1 and N >= 16 and N % 16 == 0 and \
        (not packed or (K % 2 == 0 and (K // 2) % 16 == 0))


def ragged_supports(K: int, N: int, packed: bool) -> bool:
    """The shapes the ragged GEMM (``mq_int8_gemm_ragged``) takes: any
    K ≥ 1 and N ≥ 1, K even for packed W4 (split-half packing): every shape
    of :func:`tma_supports` and all that it refuses."""
    return K >= 1 and N >= 1 and (not packed or K % 2 == 0)


def tma_tokens(M: int, N: int, sms: int = 132) -> int:
    """Tokens per block of the TMA GEMM (blocks are 128 channels wide): 256
    (two warpgroups of 128 tokens: half the A-fragment work per product)
    unless that leaves fewer blocks than half the SMs, where 128 keeps more
    of them busy (the ViT's N = 1280, the merger's M = 256, N = 512).
    ``chip_smoke.py`` times both widths at each main-path shape."""
    blocks = -(-M // 256) * -(-N // 128)
    return 256 if 2 * blocks >= sms else 128


def _launch_gemm(name, entry, xq, x_scale, w, w_scale, out_dtype, packed,
                 M, K, N, tokens, ldx):
    """One launch of a GEMM entry: x's rows at stride ``ldx`` bytes,
    blocks of 128 channels × ``tokens`` tokens."""
    from ._build import load

    out = torch.empty((M, N), dtype=out_dtype, device=xq.device)
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    status = getattr(load(), entry)(
        xq.data_ptr(), ldx, w.data_ptr(), x_scale.data_ptr(),
        w_scale.data_ptr(), out.data_ptr(), M, K, N, int(packed),
        _OUT_KIND[out_dtype], tokens, stream)
    LAUNCHES[name] += 1
    _raise_on_status(name, status)
    return out


def _tma_rows(xq: torch.Tensor) -> torch.Tensor:
    """xq itself where its rows lie on a 16-byte aligned base at a stride
    that is a multiple of 16 bytes (TMA's contract); else one copy of it
    into such rows, the stride K rounded up to 16."""
    if xq.stride(0) % 16 == 0 and xq.data_ptr() % 16 == 0:
        return xq
    M, K = xq.shape
    return torch.empty((M, -(-K // 16) * 16), dtype=torch.int8,
                       device=xq.device)[:, :K].copy_(xq)


def _w4_planes(xq: torch.Tensor) -> torch.Tensor:
    """x (M, K) for packed W4 whose K/2 is no multiple of 16, as the ragged
    GEMM reads it: the low plane at columns [0, K/2), the high plane at
    [H, H + K/2), H = K/2 rounded up to 16, zeros between (one copy)."""
    M, K = xq.shape
    half = K // 2
    H = -(-half // 16) * 16
    x2 = torch.zeros((M, 2 * H), dtype=torch.int8, device=xq.device)
    x2[:, :half] = xq[:, :half]
    x2[:, H:H + half] = xq[:, half:]
    return x2


def _gemm_tma(xq, x_scale, w, w_scale, out_dtype, packed, tokens):
    """The TMA kernel at a given block width (``tokens`` 128 or 256), for
    timing the one :func:`tma_tokens` does not pick."""
    M, K, N = _check_args("int8_gemm", xq, x_scale, w, w_scale, out_dtype,
                          packed, x_rows=True)
    x2 = _tma_rows(xq)
    return _launch_gemm("int8_gemm", "mq_int8_gemm", x2, x_scale, w, w_scale,
                        out_dtype, packed, M, K, N, tokens,
                        ldx=x2.stride(0))


def int8_gemm(xq, x_scale, w, w_scale, out_dtype=torch.bfloat16,
              packed: bool = False):
    """int8 GEMM for M > 32 on W4 packed (K/2, N) or W8 (K, N) weights, any
    K and N, with the fused per-token × per-channel epilogue; xq's rows may
    lie at any stride ≥ K. Shapes inside :func:`tma_supports` with a 16-byte
    aligned weight run the TMA + wgmma kernel ``mq_int8_gemm``; the others
    :func:`int8_gemm_ragged` (both exact, so the route changes no bit; x
    rows padded by one copy where their stride or base is not 16-byte
    aligned)."""
    name = "int8_gemm"
    M, K, N = _check_args(name, xq, x_scale, w, w_scale, out_dtype, packed,
                          x_rows=True)
    if xq.device.type == "cpu":
        return int8_gemm_ref(xq, x_scale, w, w_scale, out_dtype, packed)
    if xq.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {xq.device}")
    if _gemm_route(K, N, packed, w.data_ptr() % 16 == 0) == name:
        return _gemm_tma(xq, x_scale, w, w_scale, out_dtype, packed,
                         tma_tokens(M, N, _sm_count(xq.device.index)))
    return int8_gemm_ragged(xq, x_scale, w, w_scale, out_dtype, packed)


def _gemm_route(K: int, N: int, packed: bool, w_aligned: bool) -> str:
    """The kernel :func:`int8_gemm` launches on the card: ``"int8_gemm"``
    (TMA) inside :func:`tma_supports` with a 16-byte aligned weight, else
    ``"int8_gemm_ragged"`` (:func:`ragged_supports` takes every shape that
    :func:`_check_args` lets through)."""
    if tma_supports(K, N, packed) and w_aligned:
        return "int8_gemm"
    return "int8_gemm_ragged"


def int8_gemm_ragged(xq, x_scale, w, w_scale, out_dtype=torch.bfloat16,
                     packed: bool = False):
    """The same GEMM for every shape of :func:`ragged_supports`
    (``mq_int8_gemm_ragged``): the TMA + wgmma kernel with W's tile written
    into shared memory by a warpgroup of threads (the aligned words that
    hold each row's bytes, shifted into place), for W rows at a stride TMA
    cannot address. x as the TMA kernel reads it (rows at any
    stride ≥ K, one copy into 16-byte rows where TMA cannot read them; for
    packed W4 with (K/2) % 16 != 0 one copy into :func:`_w4_planes`, since a
    TMA box starts on 16 bytes)."""
    name = "int8_gemm_ragged"
    M, K, N = _check_args(name, xq, x_scale, w, w_scale, out_dtype, packed,
                          x_rows=True)
    if xq.device.type == "cpu":
        return int8_gemm_ref(xq, x_scale, w, w_scale, out_dtype, packed)
    if xq.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {xq.device}")
    x2 = _w4_planes(xq) if packed and (K // 2) % 16 else _tma_rows(xq)
    return _launch_gemm(name, "mq_int8_gemm_ragged", x2, x_scale, w, w_scale,
                        out_dtype, packed, M, K, N,
                        tma_tokens(M, N, _sm_count(xq.device.index)),
                        ldx=x2.stride(0))


# ---------------------------------------------------------------------------
# the group-blocked epilogue
# ---------------------------------------------------------------------------


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fl32(a·b + c) with one rounding (an FMA) for f32 tensors, on any
    device: a·b is exact in f64, the sum is rounded to odd in f64 (the
    exact error of the f64 sum picks the neighbour with an odd last bit),
    and rounding that to f32 rounds the exact value (53 ≥ 24 + 2 bits)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def group_epilogue_ref(P, wsum, xsum, xs, xz, ws, wz, acc, g0: int, G: int,
                       u: int, out_dtype=None):
    """Plain version of :func:`group_epilogue`, the same op order with
    :func:`fma32` for the kernel's FMAs."""
    n = P.shape[0]
    Ga, Gw = xs.shape[1], ws.shape[0]
    a_acc = torch.zeros_like(acc) if g0 == 0 else acc.clone()
    uf = acc.new_full((), float(u))  # no host copy: graph-capturable
    for j in range(n):
        g = g0 + j
        gw, ga = g * Gw // G, g * Ga // G
        corr = P[j].float()
        if wz is not None:
            corr = fma32(-xsum[:, g:g + 1].float(), wz[gw][None], corr)
        if xz is not None:
            zx = xz[:, ga:ga + 1]
            corr = fma32(-zx, wsum[j].float()[None], corr)
            if wz is not None:
                corr = fma32(zx * wz[gw][None], uf, corr)
        a_acc = fma32(corr * xs[:, ga:ga + 1], ws[gw][None], a_acc)
    acc.copy_(a_acc)
    return None if out_dtype is None else a_acc.to(out_dtype)


def group_epilogue(P, wsum, xsum, xs, xz, ws, wz, acc, g0: int, G: int,
                   u: int, out_dtype=None):
    """Fold the int32 group accumulators P (n, M, N) (any row and group
    strides, unit column stride) of groups [g0, g0 + n) of G, in order, into
    the f32 accumulator ``acc`` (M, N) (read unless g0 == 0), as the scan
    body of the JAX function ``_grouped_epilogue`` rounds them on the CPU
    (its FMAs, then acc += (corr · sx) · sw). ``wsum`` (n, N) int32 group
    sums of W (with ``xz``), ``xsum`` (M, G) int32 group sums of x (with
    ``wz``), ``xs`` / ``xz`` (M, Ga) f32, ``ws`` / ``wz`` (Gw, N) f32.
    Returns acc in ``out_dtype`` (bf16 or f32) where one is given. CUDA
    kernel ``mq_group_epilogue``: one launch, one thread per output."""
    name = "group_epilogue"
    if acc.device.type == "cpu":
        return group_epilogue_ref(P, wsum, xsum, xs, xz, ws, wz, acc, g0, G,
                                  u, out_dtype)
    if acc.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {acc.device}")
    n, M, N = P.shape
    if P.dtype != torch.int32 or P.stride(2) != 1 or acc.dtype != \
            torch.float32 or not acc.is_contiguous() or acc.shape != (M, N):
        raise ValueError(f"{name}: needs int32 P (n, M, N) with unit column "
                         "stride and a contiguous f32 acc (M, N)")
    for t, shape in ((xs, (M, None)), (ws, (None, N)), (xz, (M, None)),
                     (wz, (None, N)), (xsum, (M, G))):
        if t is not None and (not t.is_contiguous() or t.ndim != 2 or any(
                d is not None and t.shape[i] != d
                for i, d in enumerate(shape))):
            raise ValueError(f"{name}: a table is not a contiguous "
                             f"{shape} tensor")
    if wsum is not None and (wsum.dtype != torch.int32 or wsum.stride(1) != 1):
        raise ValueError(f"{name}: wsum must be int32 with unit column stride")
    from ._build import load

    out = None
    kind = -1
    if out_dtype is not None:
        out = torch.empty((M, N), dtype=out_dtype, device=acc.device)
        kind = _OUT_KIND[out_dtype]
        if kind > 1:
            raise ValueError(f"{name}: out_dtype {out_dtype} not supported")

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(acc.device).cuda_stream
    status = load().mq_group_epilogue(
        P.data_ptr(), P.stride(0), P.stride(1), ptr(wsum),
        0 if wsum is None else wsum.stride(0), ptr(xsum), xs.data_ptr(),
        ptr(xz), ws.data_ptr(), ptr(wz), acc.data_ptr(), ptr(out), kind, M,
        N, G, xs.shape[1], ws.shape[0], g0, n, float(u), stream)
    LAUNCHES[name] += 1
    _raise_on_status(name, status)
    return out


def _int32_dot(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int32 x·W (exact) by the integer kernels: :func:`int8_gemv` for
    M ≤ 32 rows, else :func:`int8_gemm`; the exact plain dot on the CPU."""
    if xq.device.type == "cpu":
        return _exact_dot(xq, w)
    M, N = xq.shape[0], w.shape[1]
    xs = torch.ones((M,), dtype=torch.float32, device=xq.device)
    ws = torch.ones((N,), dtype=torch.float32, device=xq.device)
    if M <= GEMV_MAX_M:
        return KERNELS["int8_gemv"](xq.contiguous(), xs, w, ws, torch.int32)
    return KERNELS["int8_gemm"](xq, xs, w, ws, torch.int32)


def _blockdiag_route(dev: torch.device, M: int) -> bool:
    """Whether :func:`_grouped_epilogue` takes every group's accumulator
    from one block-diagonal product: M ≤ 32 rows on the card."""
    return dev.type == "cuda" and M <= GEMV_MAX_M


def _blockdiag_partials(xq2: torch.Tensor, w: torch.Tensor, G: int,
                        ones: bool):
    """Every group's int32 accumulator x_g · W_g from ONE product (W read
    once): x (M, K) laid out block-diagonally as (M·G, K), row (m, g)
    holding x[m]'s group g and zeros elsewhere; with ``ones`` one more
    block of G rows of ones gives W's group sums Σw_g. Returns (P (G, M, N)
    views, Σw (G, N) or None)."""
    M, K = xq2.shape
    N = w.shape[1]
    u = K // G
    Mp = M + ones
    xbd = torch.zeros((Mp, G, G, u), dtype=torch.int8, device=xq2.device)
    diag = torch.diagonal(xbd, dim1=1, dim2=2)  # (Mp, u, G)
    diag[:M].copy_(xq2.reshape(M, G, u).transpose(1, 2))
    if ones:
        diag[M].fill_(1)
    P = _int32_dot(xbd.view(Mp * G, K), w).view(Mp, G, N).transpose(0, 1)
    return P[:, :M], (P[:, M] if ones else None)


def _grouped_epilogue(xq2, x_scale, x_zp, a_gs, w, ws, wz, out_dtype):
    """The group-blocked integer GEMM + dequant of the configurations the
    per-channel epilogue cannot fold (grouped weight scales, weight zero
    points, activation zero points, per-token-per-group activation scales):
    over contraction groups g of the unified width u = K / lcm(Gw, Ga),

      y = Σ_g s_x[t,g]·s_w[g,n]·(acc_g − z_w·Σx_g − z_x·Σw_g + z_x·z_w·u)

    in the JAX function's order and roundings. The int32 group accumulators
    are exact: for M ≤ 32 rows (decode, the engine's rows, a verify
    window) one launch gives them all, x laid out block-diagonally as
    (M·G, K) (row (m, g) holds x[m]'s group g, zeros elsewhere; with an
    activation zero point one more block of ones gives Σw_g) so W is read
    once, and one :func:`group_epilogue` folds every group; for more rows
    (prefill) one launch per group on x's and W's K-slice and one
    epilogue launch per group into an f32 (M, N) accumulator (no (G, M, N)
    tensor). On the CPU the plain versions, group by group."""
    M, K = xq2.shape
    N = w.shape[1]
    dev = xq2.device
    Gw = ws.shape[0] if ws.ndim == 2 else 1
    Ga = K // a_gs if a_gs else 1
    G = math.lcm(Gw, Ga)
    assert K % G == 0, (K, Gw, Ga)
    u = K // G
    ws2 = ws.float().reshape(Gw, N).contiguous()
    wz2 = None if wz is None else wz.float().reshape(Gw, N).contiguous()

    def per_row(t):  # (M, Ga): JAX's broadcast of a scale / zero point
        t = torch.as_tensor(t, dtype=torch.float32, device=dev)
        if a_gs:
            return t.reshape(M, Ga).contiguous()
        t = t.reshape(-1, 1) if t.ndim else t.reshape(1, 1)
        return t.expand(M, 1).contiguous()

    xs2 = per_row(x_scale)
    xz2 = None if x_zp is None else per_row(x_zp)
    xsum = None
    if wz2 is not None:
        xsum = xq2.reshape(M, G, u).sum(-1, dtype=torch.int32).contiguous()
    acc = torch.empty((M, N), dtype=torch.float32, device=dev)
    epi = KERNELS["group_epilogue"]
    if _blockdiag_route(dev, M):
        P, wsum = _blockdiag_partials(xq2, w, G, ones=xz2 is not None)
        return epi(P, wsum, xsum, xs2, xz2, ws2, wz2, acc, 0, G, u,
                   out_dtype)
    y = None
    for g in range(G):
        wg = w[g * u:(g + 1) * u]
        P = _int32_dot(xq2[:, g * u:(g + 1) * u], wg)
        wsum = (None if xz2 is None
                else wg.sum(0, dtype=torch.int32)[None])
        y = epi(P[None], wsum, xsum, xs2, xz2, ws2, wz2, acc, g, G, u,
                out_dtype if g == G - 1 else None)
    return y


# the two ways to run the integer products: the hand-written kernels, which
# quantized_matmul_pre and the probes dispatch to, or their plain versions
# (chip_smoke.py swaps PLAIN into KERNELS for its on-card reference forward;
# on a CPU tensor both end in the plain version)
KERNELS = {"w4a8_gemv": w4a8_gemv, "int8_gemv": int8_gemv,
           "int8_gemm": int8_gemm, "int8_gemm_ragged": int8_gemm_ragged,
           "w8_bf16_gemv": w8_bf16_gemv, "w4_unpack_gemv": w4_unpack_gemv,
           "group_epilogue": group_epilogue}
PLAIN = {"w4a8_gemv": w4a8_gemv_ref, "int8_gemv": int8_gemv_ref,
         "int8_gemm": int8_gemm_ref, "int8_gemm_ragged": int8_gemm_ref,
         "w8_bf16_gemv": w8_bf16_gemv_ref,
         "w4_unpack_gemv": w4_unpack_gemv_ref,
         "group_epilogue": group_epilogue_ref}


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def grouped_route(p: Dict[str, Any], spec=None, x_zp=None,
                  a_groupsize: Optional[int] = None) -> bool:
    """Whether :func:`quantized_matmul_pre` serves the site ``p`` (one layer's
    or stacked) through :func:`_grouped_epilogue`: weight zero points,
    grouped weight scales (as many dims as ``w_q``), or an activation with a
    zero point or per-group scales. The activation's side is read from
    ``x_zp`` / ``a_groupsize`` as :func:`_act_int8` returned them, or, with
    ``spec``, ahead of any call: asymmetric activations that are not folded
    into the weights (``a_fold``), or ``a_groupsize``."""
    if p.get("w_zp") is not None or p["w_scale"].ndim == p["w_q"].ndim:
        return True
    if spec is not None:
        return bool(spec.a_groupsize) or (
            spec.a_bits is not None and not spec.a_symmetric
            and "a_fold" not in p)
    return x_zp is not None or a_groupsize is not None


def quantized_matmul(x: torch.Tensor, p: Dict[str, Any], spec,
                     site_state: Optional[Dict[str, Any]] = None,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y = dequant(int8(x) @ int_w) with fused scales. Bias NOT added here."""
    out_dtype = out_dtype or x.dtype
    aq = _act_int8(x, spec, site_state, p)
    y = quantized_matmul_pre(aq.q, aq.scale, p, out_dtype, x_zp=aq.zp,
                             a_groupsize=aq.groupsize)
    if "a_corr" in p:
        y = y + p["a_corr"].to(y.dtype)
    return y


def quantized_matmul_pre(xq: torch.Tensor, x_scale, p: Dict[str, Any],
                         out_dtype: torch.dtype,
                         x_zp: Optional[torch.Tensor] = None,
                         a_groupsize: Optional[int] = None) -> torch.Tensor:
    """GEMM + dequant for an already int8-quantized activation (..., K).

    Routing (the JAX function's): an ``a_perm`` leaf (act_order × group
    storage) gathers x first; grouped weight scales, zero points or
    per-group activation scales take :func:`_grouped_epilogue` (packed W4
    unpacked first); else packed W4 with ≤ 32 tokens → :func:`w4a8_gemv`;
    int8 weights with ≤ 32 tokens → :func:`int8_gemv` (any K and N,
    :func:`int8_gemv_supports`); more tokens → :func:`int8_gemm` (W4
    packed or W8), each looked up in ``KERNELS`` at call time."""
    ap = p.get("a_perm")
    if ap is not None:
        # act_order × group_size storage: W's rows in permuted layout, so
        # gather the (elementwise-quantized) activation to match
        xq = xq.index_select(-1, ap.to(device=xq.device, dtype=torch.long))
    lead = xq.shape[:-1]
    K = xq.shape[-1]
    if grouped_route(p, x_zp=x_zp, a_groupsize=a_groupsize):
        w = (unpack_int4_weights(p) if p["w_q"].shape[-2] * 2 == K
             else p["w_q"])
        y = _grouped_epilogue(xq.reshape(-1, K), x_scale, x_zp, a_groupsize,
                              w, p["w_scale"], p.get("w_zp"), out_dtype)
        return y.reshape(*lead, y.shape[-1])
    x2 = xq.reshape(-1, K)  # a view where xq's rows are padded (_codes_out)
    M = x2.shape[0]
    xs = torch.as_tensor(x_scale, dtype=torch.float32, device=xq.device)
    xs = xs.reshape(-1).expand(M).contiguous() if xs.numel() == 1 else \
        xs.reshape(M).contiguous()
    w = p["w_q"]
    ws = p["w_scale"].float().contiguous()
    packed = w.shape[-2] * 2 == K
    if M <= GEMV_MAX_M:
        fn = KERNELS["w4a8_gemv"] if packed else KERNELS["int8_gemv"]
        y = fn(x2.contiguous(), xs, w, ws, out_dtype)
    else:
        if x2.stride(-1) != 1:
            x2 = x2.contiguous()
        y = KERNELS["int8_gemm"](x2, xs, w, ws, out_dtype, packed=packed)
    return y.reshape(*lead, y.shape[-1])
