"""Online Hadamard transform, the fused MLP tail and the norm → int8 pass
(counterpart of ``mquant_tpu/kernels/fwht.py``).

The Kronecker two-matmul form: with n = K·m, y = (hadK ⊗ H_m) x is
hadK @ (X · H_m) for X = x viewed (K, m). JAX runs :func:`online_hadamard`
on XLA, outside Pallas, so here it is two ``torch.matmul`` calls. Block mode
(I ⊗ H₁₂₈) is the m = 128, K = 1 case: one (…, 128) @ (128, 128) product.

Five hand-written CUDA kernels (``csrc/fwht.cu``), each for rows of n = K·128
with K ≤ 160 (18944 = 148·128; pow2 n up to 16384):

  * :func:`fused_swiglu_had_quant` — silu(g)·u → hadK ⊗ H₁₂₈ → static
    per-tensor int8 in one pass over the row (the prefill tail before the
    full-Hadamard ``down``); replaces ``_tail_kernel`` /
    ``fused_swiglu_had_quant``.
  * :func:`had_quant` — the same pipeline on one bf16 input; replaces
    ``_had_quant_kernel`` / ``had_quant``.
  * :func:`fwht_two_matmul` — the transform in f32 throughout, bf16 or f32
    in and out (the hadK factor on wgmma with exact products, as
    c · sign(hadK) against three bf16 terms of the f32 intermediate);
    replaces ``_fwht_kernel`` / ``fwht_pallas``.
  * :func:`rms_norm_quant` — RMSNorm → static int8 in one pass (any n with
    n % 16 == 0); replaces ``_rms_quant_kernel`` / ``rms_norm_quant``.
  * :func:`dequant_swiglu_had_quant` — the int8 MLP's epilogue: int32 gate
    and up accumulators × per-channel scales → silu(g)·u → the tail's
    Hadamard and int8; replaces the kernel of
    ``scripts/mlp_variants.py::mlp_int8_fused_epilogue`` (the tail kernel
    reading int32 rows).

No served JAX path reaches the last four; ``scripts/prefill_probe.py`` and
``scripts/mlp_variants.py`` do, and so do their ports in
``mquant_tpu_torch.scripts``. The quantizers take the code range
``[qmin, qmax]`` (default [−128, 127]; −128 ≤ qmin ≤ qmax ≤ 127) as the JAX
kernels do.

Each wrapper launches its kernel for a CUDA tensor (or raises) and takes its
plain PyTorch version (``*_ref``) only for a CPU tensor. ``LAUNCHES`` counts
the kernel launches of each wrapper.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict

import numpy as np
import torch

from ..transform import hadamard as H
from .qmm import _sm_count

# kernel launches per wrapper (read and reset by chip_smoke.py)
LAUNCHES: Dict[str, int] = {"fused_swiglu_had_quant": 0, "had_quant": 0,
                            "fwht_two_matmul": 0, "rms_norm_quant": 0,
                            "dequant_swiglu_had_quant": 0}

# the Hadamard kernels' row tile: (TAIL_MAX_K, TAIL_M), the hadK axis
# zero-padded to TAIL_MAX_K (148 → 160 for n = 18944)
TAIL_M, TAIL_MAX_K = 128, 160
# the tail kernel's shared memory (csrc/fwht.cu): of a block's 232,448 bytes,
# the token's X and Y1 tiles (192 × 128 bf16 each) and H₁₂₈ (128 × 128 bf16)
# stay, 1024 bytes go to alignment; the rest, less TAIL_MAX_SLOTS mbarriers,
# is the ring of g / u slots
TAIL_FIXED_BYTES = 2 * 192 * 128 * 2 + 128 * 128 * 2
TAIL_MAX_SLOTS = 8
TAIL_STAGE_BYTES = 232448 - TAIL_FIXED_BYTES - 1024 - 8 * TAIL_MAX_SLOTS
# fwht's: the three bf16 planes of Y1 (TAIL_MAX_K × 128 each) stay, and for
# bf16 outputs their staging (3 warpgroups × 64 rows × 256 bytes); the rest,
# less the alignment and the mbarriers, is its ring of x rows
FWHT_STAGE_BYTES = (232448 - 3 * TAIL_MAX_K * 128 * 2 - 1024
                    - 8 * TAIL_MAX_SLOTS)
FWHT_OUT_STAGE_BYTES = 3 * 64 * 256


def _pow2_split(n: int) -> tuple[int, int]:
    """n = a·b, both pow2, b ≥ a, b ≥ 128 when possible."""
    p = n.bit_length() - 1
    bp = max(p - p // 2, min(7, p))
    b = 1 << bp
    return n // b, b


@functools.lru_cache(maxsize=None)
def _factors(n: int):
    """numpy (A, B, K): x (…, K, m) → A over K, B over m (both orthonormal)."""
    hadK, K = H.get_hadK(n)
    m = n // K
    if K > 1:
        Hm = H.hadamard_matrix(m) / math.sqrt(m)
        return (np.asarray(hadK, np.float32), np.asarray(Hm, np.float32), K)
    a, b = _pow2_split(n)
    Ha = H.hadamard_matrix(a) / math.sqrt(a)
    Hb = H.hadamard_matrix(b) / math.sqrt(b)
    return (np.asarray(Ha, np.float32), np.asarray(Hb, np.float32), a)


@functools.lru_cache(maxsize=None)
def _factor_tensors(n: int, dtype: torch.dtype, device: torch.device):
    A_np, B_np, K = _factors(n)
    return (torch.from_numpy(A_np).to(device=device, dtype=dtype),
            torch.from_numpy(B_np).to(device=device, dtype=dtype), K)


@contextlib.contextmanager
def _f32_sums():
    """cuBLAS's reduced-precision reduction of bf16 products (on by default
    in PyTorch) off for the calls inside, restored after."""
    flags = torch.backends.cuda.matmul
    prev = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        flags.allow_bf16_reduced_precision_reduction = prev


def online_hadamard(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal Hadamard transform along the last axis (n = K·2^p).

    bf16 inputs run bf16 matmuls (f32 sums, rounded to bf16 between the two
    products), as the JAX version does; cuBLAS keeps their split-K sums in
    f32 too, whatever its global flag says (:func:`_f32_sums`). f32 inputs
    run in f32."""
    n = x.shape[-1]
    dt = x.dtype if x.dtype in (torch.bfloat16, torch.float32,
                                torch.float64) else torch.float32
    A, B, K = _factor_tensors(n, dt, x.device)
    m = n // K
    xr = x.to(dt).reshape(*x.shape[:-1], K, m)
    with _f32_sums():
        t = torch.matmul(xr, B)
        out = torch.matmul(A, t) if K > 1 else t  # A = [[1]] when K == 1
    return out.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _quantize_static(y: torch.Tensor, scale, qmin: int = -128,
                     qmax: int = 127) -> torch.Tensor:
    """round(y · (1/scale)) half to even, clipped to [qmin, qmax], int8
    (1/scale in f32 once, as the TPU kernels do)."""
    inv = 1.0 / torch.as_tensor(scale, dtype=torch.float32, device=y.device)
    return torch.clamp(torch.round(y * inv), qmin, qmax).to(torch.int8)


def _had_quant_bf16(x: torch.Tensor, scale, qmin: int = -128,
                    qmax: int = 127) -> torch.Tensor:
    """The TPU kernels' Hadamard → int8 on a bf16 x (…, n): the m-axis product
    (bf16 operands, f32 sums) rounded to bf16, the K-axis product in f32."""
    n = x.shape[-1]
    A, B, K = _factor_tensors(n, torch.bfloat16, x.device)
    # bf16 values held in f32: exact products and f32 sums, whatever
    # cuBLAS's reduced-precision or TF32 flags say
    t = torch.matmul(x.reshape(*x.shape[:-1], K, n // K).float(), B.float())
    y = torch.matmul(A.float(), t.to(torch.bfloat16).float())
    return _quantize_static(y, scale, qmin, qmax).reshape(x.shape)


def _swiglu_bf16(gf: torch.Tensor, uf: torch.Tensor) -> torch.Tensor:
    """(g · sigmoid(g)) · u in f32, rounded to bf16 (the tail kernels' x)."""
    return ((gf * torch.sigmoid(gf)) * uf).to(torch.bfloat16)


def fused_swiglu_had_quant_ref(g: torch.Tensor, u: torch.Tensor, scale,
                               qmin: int = -128, qmax: int = 127
                               ) -> torch.Tensor:
    """Plain version of :func:`fused_swiglu_had_quant`, at the TPU kernel's
    rounding points: silu(g)·u in f32, rounded to bf16, then
    :func:`had_quant_ref`'s pipeline."""
    return _had_quant_bf16(_swiglu_bf16(g.float(), u.float()), scale, qmin,
                           qmax)


def had_quant_ref(x: torch.Tensor, scale, qmin: int = -128,
                  qmax: int = 127) -> torch.Tensor:
    """Plain version of :func:`had_quant` (``_had_quant_kernel``): x rounded
    to bf16; X·H_m with bf16 operands and f32 sums, rounded to bf16; the hadK
    product in f32; then round(y · (1/scale)) half to even, clipped to
    [qmin, qmax]."""
    return _had_quant_bf16(x.to(torch.bfloat16), scale, qmin, qmax)


def dequant_swiglu_had_quant_ref(g: torch.Tensor, u: torch.Tensor, g_scale,
                                 u_scale, scale, qmin: int = -128,
                                 qmax: int = 127) -> torch.Tensor:
    """Plain version of :func:`dequant_swiglu_had_quant`, at the TPU kernel's
    rounding points (mlp_variants.py:159-170): gf = f32(g) · g_scale and
    uf = f32(u) · u_scale per channel, silu(gf)·uf in f32 rounded to bf16,
    then :func:`had_quant_ref`'s pipeline."""
    gs = torch.as_tensor(g_scale, dtype=torch.float32, device=g.device)
    us = torch.as_tensor(u_scale, dtype=torch.float32, device=u.device)
    return _had_quant_bf16(_swiglu_bf16(g.float() * gs.reshape(-1),
                                        u.float() * us.reshape(-1)),
                           scale, qmin, qmax)


def fwht_two_matmul_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`fwht_two_matmul` (``_fwht_kernel``): the
    two-factor form (pow2 n: ``_pow2_split``'s Ha ⊗ Hb) on x without an
    intermediate rounding, cast to x's dtype once. Computed in float64 from
    the f32 factors, so that no TF32 or reduced-precision flag of cuBLAS can
    change it; the f32 kernel is held to it within 1e-5 of its largest
    magnitude."""
    n = x.shape[-1]
    A, B, K = _factor_tensors(n, torch.float32, x.device)
    t = torch.matmul(x.reshape(*x.shape[:-1], K, n // K).double(), B.double())
    return torch.matmul(A.double(), t).reshape(x.shape).to(x.dtype)


def rms_norm_quant_ref(x: torch.Tensor, w: torch.Tensor, scale,
                       eps: float = 1e-6, qmin: int = -128,
                       qmax: int = 127) -> torch.Tensor:
    """Plain version of :func:`rms_norm_quant` (``_rms_quant_kernel``):
    y = x · rsqrt(mean(x²) + eps) · w in f32, then round(y · (1/scale)) half
    to even, clipped to [qmin, qmax]. Unlike quantize(rms_norm(x, w)), y is
    never rounded to x's dtype (ROADMAP C-w7)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return _quantize_static(xf * torch.rsqrt(var + eps) * w.float(), scale,
                            qmin, qmax)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _tail_factors(n: int, device: torch.device):
    """The tail kernels' operands: hadK zero-padded to (TAIL_MAX_K,
    TAIL_MAX_K) and H_m transposed, both bf16 — the matrices the plain
    version uses."""
    A, B, K = _factor_tensors(n, torch.bfloat16, device)
    A_pad = torch.zeros((TAIL_MAX_K, TAIL_MAX_K), dtype=torch.bfloat16,
                        device=device)
    A_pad[:K, :K] = A
    return A_pad, B.t().contiguous()


@functools.lru_cache(maxsize=None)
def _sign_factor(n: int):
    """(sign(A), c) with A = c · sign(A) for the K-axis factor A of n, c one
    f32 value (every Hadamard construction's hadK, and Sylvester's H_a for
    pow2 n); None where |A| takes more than one value (the seeded random
    orthogonal block of K = 156)."""
    A = _factors(n)[0]
    c = np.float32(abs(A[0, 0]))
    if not np.all(np.abs(A) == c):
        return None
    return np.sign(A).astype(np.float32), float(c)


@functools.lru_cache(maxsize=None)
def _fwht_factors(n: int, device: torch.device):
    """(factor, c, hm): the kernel's operands. For A = c · sign(A),
    ``mq_fwht``'s sign(A) zero-padded to (TAIL_MAX_K, TAIL_MAX_K) bf16
    (exact) and c; else ``mq_fwht_dense``'s Aᵀ (K, TAIL_MAX_K) f32
    zero-padded and c = None. hm: the f32 entry 1/√128 of the m-axis
    factor."""
    _, B, K = _factors(n)
    hm = float(B[0, 0])
    sf = _sign_factor(n)
    if sf is not None:
        S = torch.zeros((TAIL_MAX_K, TAIL_MAX_K), dtype=torch.bfloat16,
                        device=device)
        S[:K, :K] = torch.from_numpy(sf[0])
        return S, sf[1], hm
    A, _, _ = _factor_tensors(n, torch.float32, device)
    At = torch.zeros((K, TAIL_MAX_K), dtype=torch.float32, device=device)
    At[:, :K] = A.t()
    return At, None, hm


def _rows(name: str, t: torch.Tensor, n: int) -> torch.Tensor:
    """(T, n) view of t with unit column stride and 16-byte aligned rows;
    raises otherwise."""
    t2 = t.reshape(-1, n)
    if (t2.stride(-1) != 1 or (t2.stride(0) * t2.element_size()) % 16
            or t2.data_ptr() % 16 or t2.stride(0) >= 2**31):
        raise ValueError(f"{name}: rows must be 16-byte aligned with unit "
                         f"column stride, got strides {tuple(t2.stride())}")
    return t2


def _on_card(name: str, x: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version serves it), True for a
    CUDA tensor; raises for any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return True


def tail_supports(n: int, dtype: torch.dtype = torch.bfloat16) -> bool:
    """The Hadamard tail kernel's row contract: n = K·128 with K ≤ TAIL_MAX_K
    (its row tile; pow2 n above 16384 splits with m ≥ 256, n = 96 has
    m = 8), and bf16 or f32 rows (f32 g, u enter silu as they are, an f32 x
    is rounded to bf16: the TPU kernels' casts). The wrappers of
    :func:`fused_swiglu_had_quant` and :func:`had_quant` raise on a CUDA
    tensor outside it, and ``models.llm._use_fused_tail`` routes by it."""
    if dtype not in (torch.bfloat16, torch.float32) or n < TAIL_M or \
            n % TAIL_M:
        return False
    try:
        K = _factors(n)[2]
    except ValueError:  # no Hadamard construction of n
        return False
    return n // K == TAIL_M and K <= TAIL_MAX_K


def _hadamard_K(name: str, n: int) -> int:
    """K of n = K·128 with K ≤ TAIL_MAX_K (the kernels' row tile); raises for
    any other n (:func:`tail_supports`'s row rule)."""
    if not tail_supports(n):
        raise ValueError(f"{name}: needs n = K·{TAIL_M} with K ≤ "
                         f"{TAIL_MAX_K}, got n = {n}")
    return _factors(n)[2]


def _check_tail(name: str, n: int, dtype: torch.dtype) -> int:
    """K of the bf16 or f32 rows of n = K·128 that the tail kernel takes;
    raises exactly where :func:`tail_supports` says no."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: the kernel takes bf16 or f32, got {dtype}")
    return _hadamard_K(name, n)


def _tail_plan(T: int, K: int, sub_bytes: int, sms: int) -> tuple:
    """(blocks, sub-rows per chunk, ring slots) of the tail kernel for T
    token rows of K 128-wide sub-rows, each ``sub_bytes`` of input (g and u
    together). One persistent block per SM, at most T: block b takes tokens
    b, b + blocks, b + 2·blocks, ... A token's row comes through the ring
    in chunks of ``cs`` sub-rows; of the chunk sizes whose slots fit
    TAIL_STAGE_BYTES, the one that keeps the largest share of the next
    token's row in flight while this token's products run (all of it where
    one slot holds a row: bf16 pairs, one f32 or bf16 input; 5 of 8
    chunks for int32 or f32 pairs at K = 148), with the fewest chunks."""
    best = None
    for want in range(1, TAIL_MAX_SLOTS + 1):
        cs = -(-K // want)
        nch = -(-K // cs)
        slots = min(nch, TAIL_MAX_SLOTS, TAIL_STAGE_BYTES // (cs * sub_bytes))
        if slots and (best is None or slots * best[2] > best[1] * nch):
            best = (cs, slots, nch)
    if best is None:
        raise ValueError(f"tail: a {sub_bytes}-byte sub-row does not fit the "
                         "ring")
    return min(T, sms), best[0], best[1]


def _fwht_plan(T: int, n: int, elem_bytes: int, sms: int) -> tuple:
    """(blocks, ring slots) of ``mq_fwht`` for T rows of n elements of
    ``elem_bytes``: one persistent block per SM, at most T, and as many
    whole-row slots as the ring holds (at most TAIL_MAX_SLOTS): f32 rows in
    FWHT_STAGE_BYTES, bf16 rows beside the output staging. Every row of the
    contract fits one slot (n = 160·128: 81,920 bytes in f32, 40,960 in
    bf16)."""
    ring = FWHT_STAGE_BYTES - (FWHT_OUT_STAGE_BYTES if elem_bytes == 2 else 0)
    return min(T, sms), min(TAIL_MAX_SLOTS, ring // (n * elem_bytes))


def _scale(name: str, scale, device) -> torch.Tensor:
    """The per-tensor scale as one f32 on ``device``; a Python number is
    filled in there (no host copy, so a CUDA graph can capture the call)."""
    s = (torch.as_tensor(scale, dtype=torch.float32, device=device)
         if isinstance(scale, torch.Tensor) else
         torch.full((), float(scale), dtype=torch.float32, device=device))
    if s.numel() != 1:
        raise ValueError(f"{name}: scale must be per tensor, got "
                         f"{tuple(s.shape)}")
    return s


def _code_range(name: str, qmin: int, qmax: int) -> tuple[int, int]:
    """(qmin, qmax) as ints; raises unless −128 ≤ qmin ≤ qmax ≤ 127."""
    if not -128 <= qmin <= qmax <= 127:
        raise ValueError(f"{name}: needs -128 <= qmin <= qmax <= 127, got "
                         f"[{qmin}, {qmax}]")
    return int(qmin), int(qmax)


def _finish(name: str, status: int):
    LAUNCHES[name] += 1
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status}")


def fused_swiglu_had_quant(g: torch.Tensor, u: torch.Tensor, scale,
                           qmin: int = -128, qmax: int = 127) -> torch.Tensor:
    """int8 (…, n) = clip(round(((hadK ⊗ H₁₂₈) · silu(g)·u) / scale), qmin,
    qmax) for bf16 or f32 g, u (…, n) and a per-tensor ``scale``; CUDA
    kernel ``mq_fused_swiglu_had_quant``. Takes n = K·128 with K ≤ 160
    (n = 18944: K = 148) and rows with unit column stride (g and u may be
    the two halves of one fused gate|up output)."""
    name = "fused_swiglu_had_quant"
    qmin, qmax = _code_range(name, qmin, qmax)
    if g.shape != u.shape or g.dtype != u.dtype or g.device != u.device:
        raise ValueError(f"{name}: g {tuple(g.shape)} {g.dtype} {g.device} "
                         f"and u {tuple(u.shape)} {u.dtype} {u.device} differ")
    if not _on_card(name, g):
        return fused_swiglu_had_quant_ref(g, u, scale, qmin, qmax)
    n = g.shape[-1]
    K = _check_tail(name, n, g.dtype)
    s = _scale(name, scale, g.device)
    g2, u2 = _rows(name, g, n), _rows(name, u, n)
    T = g2.shape[0]
    out = torch.empty((T, n), dtype=torch.int8, device=g.device)
    if T == 0:
        return out.reshape(g.shape)
    from ._build import load

    A_pad, B_t = _tail_factors(n, g.device)
    plan = _tail_plan(T, K, 2 * TAIL_M * g.element_size(),
                      _sm_count(g.device.index))
    stream = torch.cuda.current_stream(g.device).cuda_stream
    _finish(name, load().mq_fused_swiglu_had_quant(
        g2.data_ptr(), u2.data_ptr(), g2.stride(0), u2.stride(0),
        A_pad.data_ptr(), B_t.data_ptr(), s.data_ptr(), out.data_ptr(), T, K,
        qmin, qmax, int(g.dtype == torch.float32), *plan, stream))
    return out.reshape(g.shape)


def had_quant(x: torch.Tensor, scale, qmin: int = -128,
              qmax: int = 127) -> torch.Tensor:
    """int8 (…, n) = clip(round(((hadK ⊗ H₁₂₈) · bf16(x)) / scale), qmin,
    qmax) for bf16 or f32 x (…, n) and a per-tensor ``scale``; CUDA kernel
    ``mq_had_quant`` (the tail kernel reading x instead of silu(g)·u).
    n = K·128 with K ≤ 160, rows with unit column stride."""
    name = "had_quant"
    qmin, qmax = _code_range(name, qmin, qmax)
    if not _on_card(name, x):
        return had_quant_ref(x, scale, qmin, qmax)
    n = x.shape[-1]
    K = _check_tail(name, n, x.dtype)
    s = _scale(name, scale, x.device)
    x2 = _rows(name, x, n)
    T = x2.shape[0]
    out = torch.empty((T, n), dtype=torch.int8, device=x.device)
    if T == 0:
        return out.reshape(x.shape)
    from ._build import load

    A_pad, B_t = _tail_factors(n, x.device)
    plan = _tail_plan(T, K, TAIL_M * x.element_size(),
                      _sm_count(x.device.index))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _finish(name, load().mq_had_quant(
        x2.data_ptr(), x2.stride(0), A_pad.data_ptr(), B_t.data_ptr(),
        s.data_ptr(), out.data_ptr(), T, K, qmin, qmax,
        int(x.dtype == torch.float32), *plan, stream))
    return out.reshape(x.shape)


def _channel_scale(name: str, s: torch.Tensor, n: int, device) -> torch.Tensor:
    """``s`` as a contiguous f32 (n,) view on ``device``; raises otherwise."""
    if (not isinstance(s, torch.Tensor) or s.dtype != torch.float32
            or s.numel() != n or s.device != device or not s.is_contiguous()):
        raise ValueError(f"{name}: channel scales must be contiguous f32 "
                         f"with {n} elements on {device}")
    return s.reshape(n)


def dequant_swiglu_had_quant(g: torch.Tensor, u: torch.Tensor,
                             g_scale: torch.Tensor, u_scale: torch.Tensor,
                             scale, qmin: int = -128, qmax: int = 127
                             ) -> torch.Tensor:
    """int8 (…, n) = clip(round(((hadK ⊗ H₁₂₈) · x) / scale), qmin, qmax)
    with x = bf16(silu(gf)·uf), gf = f32(g)·g_scale, uf = f32(u)·u_scale,
    for int32 g, u (…, n) (the gate and up GEMMs' raw sums), f32 per-channel
    ``g_scale``, ``u_scale`` (n elements, already × the activation scale)
    and a per-tensor ``scale``; CUDA kernel ``mq_dequant_swiglu_had_quant``
    (the tail kernel reading int32 rows). n = K·128 with K ≤ 160; rows with
    unit column stride (g and u may be the two halves of one fused int32
    gate|up output)."""
    name = "dequant_swiglu_had_quant"
    qmin, qmax = _code_range(name, qmin, qmax)
    if g.shape != u.shape or g.device != u.device:
        raise ValueError(f"{name}: g {tuple(g.shape)} {g.device} and u "
                         f"{tuple(u.shape)} {u.device} differ")
    if not _on_card(name, g):
        return dequant_swiglu_had_quant_ref(g, u, g_scale, u_scale, scale,
                                            qmin, qmax)
    n = g.shape[-1]
    K = _hadamard_K(name, n)
    if g.dtype != torch.int32 or u.dtype != torch.int32:
        raise ValueError(f"{name}: the kernel takes int32 g and u, got "
                         f"{g.dtype}, {u.dtype}")
    gs = _channel_scale(name, g_scale, n, g.device)
    us = _channel_scale(name, u_scale, n, g.device)
    s = _scale(name, scale, g.device)
    g2, u2 = _rows(name, g, n), _rows(name, u, n)
    T = g2.shape[0]
    out = torch.empty((T, n), dtype=torch.int8, device=g.device)
    if T == 0:
        return out.reshape(g.shape)
    from ._build import load

    A_pad, B_t = _tail_factors(n, g.device)
    plan = _tail_plan(T, K, 2 * TAIL_M * 4, _sm_count(g.device.index))
    stream = torch.cuda.current_stream(g.device).cuda_stream
    _finish(name, load().mq_dequant_swiglu_had_quant(
        g2.data_ptr(), u2.data_ptr(), g2.stride(0), u2.stride(0),
        gs.data_ptr(), us.data_ptr(), A_pad.data_ptr(), B_t.data_ptr(),
        s.data_ptr(), out.data_ptr(), T, K, qmin, qmax, *plan, stream))
    return out.reshape(g.shape)


def fwht_two_matmul(x: torch.Tensor) -> torch.Tensor:
    """(hadK ⊗ H₁₂₈) x along the last axis in f32 throughout, returned in x's
    dtype (bf16 or f32); CUDA kernel ``mq_fwht``: the H₁₂₈ factor as an f32
    butterfly, the hadK = c · sign(hadK) factor on wgmma with exact bf16
    products (the f32 Y1 as three bf16 terms) and f32 sums, times c; no
    TF32. The one hadK that is no scaled sign matrix (K = 156, a random
    orthogonal block) runs ``mq_fwht_dense`` (f32 FMA). n = K·128 with
    K ≤ 160, rows with unit column stride. Unlike :func:`online_hadamard`
    on bf16, no rounding between the two factors."""
    name = "fwht_two_matmul"
    if not _on_card(name, x):
        return fwht_two_matmul_ref(x)
    n = x.shape[-1]
    K = _hadamard_K(name, n)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: the kernel takes bf16 or f32, got "
                         f"{x.dtype}")
    x2 = _rows(name, x, n)
    T = x2.shape[0]
    out = torch.empty((T, n), dtype=x.dtype, device=x.device)
    if T == 0:
        return out.reshape(x.shape)
    from ._build import load

    F, c, hm = _fwht_factors(n, x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    is_f32 = int(x.dtype == torch.float32)
    if c is None:
        status = load().mq_fwht_dense(x2.data_ptr(), x2.stride(0),
                                      F.data_ptr(), hm, out.data_ptr(), T, K,
                                      is_f32, stream)
    else:
        plan = _fwht_plan(T, n, x.element_size(), _sm_count(x.device.index))
        status = load().mq_fwht(x2.data_ptr(), x2.stride(0), F.data_ptr(), c,
                                hm, out.data_ptr(), T, K, is_f32, *plan,
                                stream)
    _finish(name, status)
    return out.reshape(x.shape)


def rms_norm_quant(x: torch.Tensor, w: torch.Tensor, scale,
                   eps: float = 1e-6, qmin: int = -128,
                   qmax: int = 127) -> torch.Tensor:
    """int8 (…, n) = clip(round(x · rsqrt(mean(x²) + eps) · w / scale), qmin,
    qmax) in f32 for bf16 x (…, n), bf16 w (n,) and a per-tensor ``scale``;
    CUDA kernel ``mq_rms_norm_quant``. n % 16 == 0, rows with unit column
    stride."""
    name = "rms_norm_quant"
    qmin, qmax = _code_range(name, qmin, qmax)
    if not _on_card(name, x):
        return rms_norm_quant_ref(x, w, scale, eps, qmin, qmax)
    n = x.shape[-1]
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the kernel takes bf16 x and w, got "
                         f"{x.dtype}, {w.dtype}")
    if w.shape != (n,) or not w.is_contiguous() or w.device != x.device:
        raise ValueError(f"{name}: w must be contiguous ({n},) on {x.device}, "
                         f"got {tuple(w.shape)} on {w.device}")
    if n % 16:
        raise ValueError(f"{name}: needs n % 16 == 0, got n = {n}")
    s = _scale(name, scale, x.device)
    x2 = _rows(name, x, n)
    T = x2.shape[0]
    out = torch.empty((T, n), dtype=torch.int8, device=x.device)
    if T == 0:
        return out.reshape(x.shape)
    from ._build import load

    stream = torch.cuda.current_stream(x.device).cuda_stream
    _finish(name, load().mq_rms_norm_quant(
        x2.data_ptr(), x2.stride(0), w.data_ptr(), s.data_ptr(),
        out.data_ptr(), T, n, float(eps), qmin, qmax, stream))
    return out.reshape(x.shape)


# the kernels or their plain versions, looked up at call time by
# models/llm.py::_mlp_tail and the probes (chip_smoke.py swaps PLAIN into
# KERNELS for a reference run)
KERNELS = {"fused_swiglu_had_quant": fused_swiglu_had_quant,
           "had_quant": had_quant, "fwht_two_matmul": fwht_two_matmul,
           "rms_norm_quant": rms_norm_quant,
           "dequant_swiglu_had_quant": dequant_swiglu_had_quant}
PLAIN = {"fused_swiglu_had_quant": fused_swiglu_had_quant_ref,
         "had_quant": had_quant_ref, "fwht_two_matmul": fwht_two_matmul_ref,
         "rms_norm_quant": rms_norm_quant_ref,
         "dequant_swiglu_had_quant": dequant_swiglu_had_quant_ref}
