"""GPTQ: Hessian-based error-compensated weight quantization (counterpart
of ``mquant_tpu/gptq/core.py``).

Weights are laid out (in, out): the walk quantizes input rows in order and
propagates each row's error to the later rows through the upper Cholesky
factor U of H⁻¹ (H⁻¹ = UᵀU). Within a 128-row block the walk is row by
row; across blocks the error moves in one (rows, 128) × (128, out)
product. Per-output-channel scales (per input-row group with
``group_size``) are fixed from the weight before the walk; ``act_order``
walks the rows by decreasing diag(H) (a stable sort).

The JAX package factors H on the TPU with its own blocked loops, which
replace a slow native lowering; here ``torch.linalg.cholesky_ex`` and
``solve_triangular`` do it. A factorization that fails fills U with NaN, so
the walk's result is not finite and the NaN guard returns the
round-to-nearest weight and grid instead (the RTN fallback), on the device
and without a host read. The grids divide by the format's range as the
JAX package's jitted walk does (``recip``), so the scales are bit-equal.
"""

from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional

import torch

from ..core import quant as Q
from ..core.formats import get_format

BLOCK = 128


class GPTQResult(NamedTuple):
    w: torch.Tensor  # fake-quantized weight (in, out), the input's dtype
    scale: torch.Tensor  # (groups or 1, out) per-out-channel scales
    used_fallback: torch.Tensor  # 0-d bool: RTN fallback taken
    zero: Optional[torch.Tensor] = None  # (groups or 1, out) asym zero points
    perm: Optional[torch.Tensor] = None  # (in,) act_order permutation:
    # permuted row i holds original row perm[i]


def accumulate_hessian(h: Optional[torch.Tensor], x: torch.Tensor
                       ) -> torch.Tensor:
    """H += 2 XᵀX over a batch of activations x (..., in), in f32 (the
    reference's running-mean normalization rescales H uniformly, which
    cancels in the algorithm)."""
    xf = x.reshape(-1, x.shape[-1]).float()
    hh = 2.0 * (xf.T @ xf)
    return hh if h is None else h + hh


def _hinv_cholesky(H: torch.Tensor, percdamp: float) -> torch.Tensor:
    """Upper-triangular U with H⁻¹ = UᵀU, by the reversal identity
    U = J · chol(J H J)⁻¹ · J (J the exchange matrix): one Cholesky and one
    triangular inverse. Dead inputs (diag 0) get a unit diagonal; the
    damping adds percdamp · mean |diag| to every diagonal entry. A failed
    factorization gives an all-NaN U."""
    n = H.shape[-1]
    H = H.float()
    diag = torch.diagonal(H)
    dead = diag == 0
    H = H + torch.diag(dead.float())
    damp = percdamp * diag.abs().mean()
    H = H + damp * torch.eye(n, dtype=torch.float32, device=H.device)
    Hr = H.flip(0, 1)
    L, info = torch.linalg.cholesky_ex(Hr)
    eye = torch.eye(n, dtype=torch.float32, device=H.device)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    U = Linv.flip(0, 1)
    return torch.where(info == 0, U, torch.full_like(U, float("nan")))


def gptq_quantize_matrix(W: torch.Tensor, H: torch.Tensor, bits: int,
                         percdamp: float = 0.01, act_order: bool = False,
                         group_size: Optional[int] = None,
                         mse_clip: bool = False, sym: bool = True,
                         seconds: Optional[Dict[str, float]] = None
                         ) -> GPTQResult:
    """act_order permutation → factorization of the (permuted) Hessian →
    the row walk. ``seconds`` (optional) accumulates the device seconds of
    the factorization ("factor") and of the walk ("walk"), synchronizing
    around each."""
    def tick():
        if seconds is not None and W.is_cuda:
            torch.cuda.synchronize(W.device)
        return time.perf_counter()

    t0 = tick()
    if act_order:  # most salient inputs first
        perm = torch.argsort(-torch.diagonal(H), stable=True)
        Hp = H[perm][:, perm]
    else:
        perm, Hp = None, H
    U = _hinv_cholesky(Hp, percdamp)
    t1 = tick()
    res = _gptq_walk(W, torch.diagonal(Hp), U, perm, bits=bits,
                     group_size=group_size, mse_clip=mse_clip, sym=sym)
    if seconds is not None:
        t2 = tick()
        seconds["factor"] = seconds.get("factor", 0.0) + t1 - t0
        seconds["walk"] = seconds.get("walk", 0.0) + t2 - t1
    return res


def _quantize_rows_block(Wb, Eb, Ub, scale, zero, qmin, qmax):
    """Quantize one block's rows in order, in place: Wb (B, out) ends as
    the quantized rows and Eb as the scaled errors; Ub (B, B) is the
    block's slice of U; scale / zero (out,) or per row (B, out), zero the
    asym zero point in integer units (None: symmetric)."""
    for i in range(Wb.shape[0]):
        w = Wb[i]
        s = scale if scale.ndim == 1 else scale[i]
        if zero is None:
            q = torch.clamp(torch.round(w / s), qmin, qmax) * s
        else:
            z = zero if zero.ndim == 1 else zero[i]
            q = (torch.clamp(torch.round(w / s) + z, qmin, qmax) - z) * s
        e = (w - q) / Ub[i, i]
        Wb[i + 1:] -= Ub[i, i + 1:, None] * e[None, :]
        Wb[i] = q
        Eb[i] = e


class _BlockGraph:
    """:func:`_quantize_rows_block` over one full block, captured once in a
    CUDA graph on static buffers and replayed for each block of a matrix
    (eager, each row costs about ten launches). Replays run the captured
    kernels, so the result equals the eager walk's."""

    def __init__(self, out: int, scale_shape, asym: bool, qmin: int,
                 qmax: int, device):
        f32 = dict(dtype=torch.float32, device=device)
        self.W = torch.zeros((BLOCK, out), **f32)
        self.E = torch.zeros((BLOCK, out), **f32)
        self.U = torch.eye(BLOCK, **f32)
        self.S = torch.ones(scale_shape, **f32)
        self.Z = torch.zeros(scale_shape, **f32) if asym else None

        def walk():
            _quantize_rows_block(self.W, self.E, self.U, self.S, self.Z,
                                 qmin, qmax)

        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):  # warm-up off the capture
            walk()
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            walk()

    def __call__(self, Wb, Ub, scale, zero) -> torch.Tensor:
        """Walks the block ``Wb`` in place; returns the block's errors."""
        self.W.copy_(Wb)
        self.U.copy_(Ub)
        self.S.copy_(scale)
        if zero is not None:
            self.Z.copy_(zero)
        self.graph.replay()
        Wb.copy_(self.W)
        return self.E


def _gptq_walk(W: torch.Tensor, diag: torch.Tensor, U: torch.Tensor,
               perm: Optional[torch.Tensor], bits: int,
               group_size: Optional[int], mse_clip: bool, sym: bool,
               graph: bool = True) -> GPTQResult:
    """The row walk over W (in, out) given the (permuted) Hessian's
    diagonal and U; returns the result in the original row order. On the
    card the full blocks replay one CUDA graph (:class:`_BlockGraph`)
    unless ``graph`` is False."""
    fmt = get_format(bits, signed=sym)
    Win = W.float()
    n, out = Win.shape
    if perm is not None:
        Win = Win[perm]
    Win = torch.where((diag == 0)[:, None], 0.0, Win)  # dead inputs → 0

    if group_size is None:
        qp = Q.weight_qparams(Win, fmt, per_channel=True, symmetric=sym,
                              mse_clip=mse_clip, recip=True)
        scales = qp.scale.reshape(1, out)
        zeros = None if qp.zero_point is None else qp.zero_point.reshape(
            1, out)
    else:
        g = n // group_size
        qp = Q.weight_qparams(Win.reshape(g, group_size, out), fmt,
                              symmetric=sym, mse_clip=mse_clip,
                              reduce_axes=(-2,), recip=True)
        scales = qp.scale.reshape(g, out)
        zeros = None if qp.zero_point is None else qp.zero_point.reshape(
            g, out)

    def rows_of(table, row0, rows):
        """The block's (out,) row, or its rows' (rows, out) group rows."""
        if table is None or group_size is None:
            return None if table is None else table[0]
        gidx = torch.clamp((row0 + torch.arange(rows, device=W.device))
                           // group_size, max=table.shape[0] - 1)
        return table[gidx]

    Wq = Win.clone()
    Eb = torch.empty((BLOCK, out), dtype=torch.float32, device=W.device)
    blocks = None
    if graph and W.is_cuda and n >= BLOCK:
        blocks = _BlockGraph(out, rows_of(scales, 0, BLOCK).shape,
                             zeros is not None, fmt.qmin, fmt.qmax, W.device)
    for row0 in range(0, n, BLOCK):
        r1 = min(row0 + BLOCK, n)
        args = (Wq[row0:r1], U[row0:r1, row0:r1],
                rows_of(scales, row0, r1 - row0),
                rows_of(zeros, row0, r1 - row0))
        if blocks is not None and r1 - row0 == BLOCK:
            E = blocks(*args)
        else:
            E = Eb[:r1 - row0]
            _quantize_rows_block(args[0], E, *args[1:], fmt.qmin, fmt.qmax)
        if r1 < n:  # the later rows take the block's error
            Wq[r1:] -= U[row0:r1, r1:].T @ E

    if perm is not None:
        Wq = Wq[torch.argsort(perm)]

    # the NaN guard: RTN weight and grid where the walk is not finite
    bad = ~torch.isfinite(Wq).all()
    qp_rtn = Q.weight_qparams(W.float(), fmt, per_channel=True,
                              symmetric=sym, mse_clip=mse_clip, recip=True)
    Wq = torch.where(bad, Q.fake_quantize(W.float(), qp_rtn, fmt), Wq)
    g = scales.shape[0]
    scales = torch.where(bad, qp_rtn.scale.reshape(1, out).expand(g, out),
                         scales)
    if zeros is not None:
        zeros = torch.where(bad, qp_rtn.zero_point.reshape(1, out).expand(
            g, out), zeros)
    return GPTQResult(w=Wq.to(W.dtype), scale=scales, used_fallback=bad,
                      zero=zeros, perm=perm)
