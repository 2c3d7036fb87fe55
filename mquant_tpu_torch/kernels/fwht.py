"""Online Hadamard transform and the fused MLP tail (counterpart of
``mquant_tpu/kernels/fwht.py``).

The Kronecker two-matmul form: with n = K·m, y = (hadK ⊗ H_m) x is
hadK @ (X · H_m) for X = x viewed (K, m). JAX runs :func:`online_hadamard`
on XLA, outside Pallas, so here it is two ``torch.matmul`` calls. Block mode
(I ⊗ H₁₂₈) is the m = 128, K = 1 case: one (…, 128) @ (128, 128) product.

One hand-written CUDA kernel (``csrc/fwht.cu``):

  * :func:`fused_swiglu_had_quant` — silu(g)·u → hadK ⊗ H₁₂₈ → static
    per-tensor int8 in one pass over the row (the prefill tail before the
    full-Hadamard ``down``); replaces ``_tail_kernel`` /
    ``fused_swiglu_had_quant``.

The wrapper launches the kernel for a CUDA tensor (or raises) and takes its
plain PyTorch version (``fused_swiglu_had_quant_ref``) only for a CPU tensor.
``LAUNCHES`` counts its kernel launches.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict

import numpy as np
import torch

from ..transform import hadamard as H

# kernel launches per wrapper (read and reset by chip_smoke.py)
LAUNCHES: Dict[str, int] = {"fused_swiglu_had_quant": 0}

# the tail kernel's row tile: (TAIL_MAX_K, TAIL_M), the hadK axis zero-padded
# to a multiple of 16 (148 → 160 for n = 18944)
TAIL_M, TAIL_MAX_K = 128, 160


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
# fused MLP tail: swiglu → Hadamard → static int8
# ---------------------------------------------------------------------------


def fused_swiglu_had_quant_ref(g: torch.Tensor, u: torch.Tensor, scale
                               ) -> torch.Tensor:
    """Plain version of :func:`fused_swiglu_had_quant`, at the TPU kernel's
    rounding points: silu(g)·u in f32, rounded to bf16; the m-axis product
    (bf16 operands, f32 sums) rounded to bf16; the K-axis product in f32;
    then round(y · (1/scale)) half to even, clipped to [−128, 127]."""
    n = g.shape[-1]
    A, B, K = _factor_tensors(n, torch.bfloat16, g.device)
    gf, uf = g.float(), u.float()
    x = ((gf * torch.sigmoid(gf)) * uf).to(torch.bfloat16)
    # bf16 values held in f32: exact products and f32 sums, whatever
    # cuBLAS's reduced-precision or TF32 flags say
    t = torch.matmul(x.reshape(*g.shape[:-1], K, n // K).float(), B.float())
    y = torch.matmul(A.float(), t.to(torch.bfloat16).float())
    inv = 1.0 / torch.as_tensor(scale, dtype=torch.float32, device=g.device)
    q = torch.clamp(torch.round(y * inv), -128, 127)
    return q.to(torch.int8).reshape(g.shape)


@functools.lru_cache(maxsize=None)
def _tail_factors(n: int, device: torch.device):
    """The kernel's operands: hadK zero-padded to (TAIL_MAX_K, TAIL_MAX_K)
    and H_m transposed, both bf16 — the matrices the plain version uses."""
    A, B, K = _factor_tensors(n, torch.bfloat16, device)
    A_pad = torch.zeros((TAIL_MAX_K, TAIL_MAX_K), dtype=torch.bfloat16,
                        device=device)
    A_pad[:K, :K] = A
    return A_pad, B.t().contiguous()


def _rows(name: str, t: torch.Tensor, n: int) -> torch.Tensor:
    """(T, n) view of t with unit column stride and 16-byte aligned rows;
    raises otherwise."""
    t2 = t.reshape(-1, n)
    if (t2.stride(-1) != 1 or t2.stride(0) % 8 or t2.data_ptr() % 16
            or t2.stride(0) >= 2**31):
        raise ValueError(f"{name}: rows must be 16-byte aligned with unit "
                         f"column stride, got strides {tuple(t2.stride())}")
    return t2


def fused_swiglu_had_quant(g: torch.Tensor, u: torch.Tensor, scale
                           ) -> torch.Tensor:
    """int8 (…, n) = clip(round(((hadK ⊗ H₁₂₈) · silu(g)·u) / scale)) for bf16
    g, u (…, n) and a per-tensor ``scale``; CUDA kernel
    ``mq_fused_swiglu_had_quant``. Takes n = K·128 with K ≤ 160 (n = 18944:
    K = 148) and rows with unit column stride (g and u may be the two halves
    of one fused gate|up output)."""
    name = "fused_swiglu_had_quant"
    if g.shape != u.shape or g.dtype != u.dtype or g.device != u.device:
        raise ValueError(f"{name}: g {tuple(g.shape)} {g.dtype} {g.device} "
                         f"and u {tuple(u.shape)} {u.dtype} {u.device} differ")
    if g.device.type == "cpu":
        return fused_swiglu_had_quant_ref(g, u, scale)
    if g.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {g.device}")
    n = g.shape[-1]
    K = _factors(n)[2]
    if g.dtype != torch.bfloat16 or n // K != TAIL_M or K > TAIL_MAX_K:
        raise ValueError(f"{name}: needs bf16 and n = K·{TAIL_M} with K ≤ "
                         f"{TAIL_MAX_K}, got {g.dtype}, n = {n} = {K}·{n // K}")
    s = torch.as_tensor(scale, dtype=torch.float32, device=g.device)
    if s.numel() != 1:
        raise ValueError(f"{name}: scale must be per tensor, got "
                         f"{tuple(s.shape)}")
    g2, u2 = _rows(name, g, n), _rows(name, u, n)
    T = g2.shape[0]
    out = torch.empty((T, n), dtype=torch.int8, device=g.device)
    if T == 0:
        return out.reshape(g.shape)
    from ._build import load

    lib = load()
    A_pad, B_t = _tail_factors(n, g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    status = lib.mq_fused_swiglu_had_quant(
        g2.data_ptr(), u2.data_ptr(), g2.stride(0), u2.stride(0),
        A_pad.data_ptr(), B_t.data_ptr(), s.data_ptr(), out.data_ptr(), T, K,
        stream)
    LAUNCHES[name] += 1
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status}")
    return out.reshape(g.shape)


# the kernel or its plain version, looked up at call time by
# models/llm.py::_mlp_tail (chip_smoke.py swaps PLAIN into KERNELS for a
# reference run)
KERNELS = {"fused_swiglu_had_quant": fused_swiglu_had_quant}
PLAIN = {"fused_swiglu_had_quant": fused_swiglu_had_quant_ref}
