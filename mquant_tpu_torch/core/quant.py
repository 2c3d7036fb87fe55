"""Quantization primitives (counterpart of ``mquant_tpu/core/quant.py``).

Plain functions on tensors. The op order follows the JAX package exactly, so
integer codes are bit-equal: ``quantize`` multiplies by ``1/scale`` (while
``kernels.qmm.quantize_weights_real`` divides, as its JAX twin does), and
``torch.round`` rounds half to even like ``jnp.round``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .formats import IntFormat, get_format


class QuantParams(NamedTuple):
    """Static quantization parameters of one tensor site. ``zero_point`` is
    None for symmetric quantization."""

    scale: torch.Tensor
    zero_point: Optional[torch.Tensor] = None


def _over(x: torch.Tensor, c: float, recip: bool) -> torch.Tensor:
    """x / c, or x · fl32(1 / c) with ``recip``: the rounding XLA gives a
    division by a constant inside a jitted JAX function (it multiplies by
    the reciprocal), as in the JAX package's GPTQ walk."""
    if recip:
        return x * float(np.float32(1.0) / np.float32(c))
    return x / c


def scales_from_minmax(xmin: torch.Tensor, xmax: torch.Tensor, fmt: IntFormat,
                       symmetric: bool = True, eps: float = 1e-8,
                       recip: bool = False) -> QuantParams:
    """(min, max) statistics → (scale, zero_point); the range is widened to
    include 0 so that zero is exactly representable. ``recip``: divide by
    the format's range as a jitted JAX caller does (:func:`_over`)."""
    xmin = torch.clamp(xmin.float(), max=0.0)
    xmax = torch.clamp(xmax.float(), min=0.0)
    if symmetric:
        amax = torch.maximum(xmin.abs(), xmax.abs())
        return QuantParams(scale=torch.clamp(_over(amax, fmt.qmax, recip),
                                             min=eps))
    scale = torch.clamp(_over(xmax - xmin, fmt.qmax - fmt.qmin, recip),
                        min=eps)
    zero_point = torch.clamp(torch.round(fmt.qmin - xmin / scale),
                             fmt.qmin, fmt.qmax)
    return QuantParams(scale=scale, zero_point=zero_point)


def quantize(x: torch.Tensor, qp: QuantParams, fmt: IntFormat,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantize to integers in the format's storage dtype (no dequant); into
    ``out`` (x's shape, the storage dtype, any strides) where given."""
    inv = 1.0 / torch.as_tensor(qp.scale, dtype=torch.float32,
                                device=x.device)
    q = torch.round(x.float() * inv)
    if qp.zero_point is not None:
        q = q + qp.zero_point
    q = torch.clamp(q, fmt.qmin, fmt.qmax)
    return q.to(fmt.storage_dtype) if out is None else out.copy_(q)


def dequantize(q: torch.Tensor, qp: QuantParams,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    qf = q.float()
    if qp.zero_point is not None:
        qf = qf - qp.zero_point
    return (qf * qp.scale).to(out_dtype)


def fake_quantize(x: torch.Tensor, qp: QuantParams, fmt: IntFormat
                  ) -> torch.Tensor:
    """quantize → dequantize, preserving the input dtype."""
    return dequantize(quantize(x, qp, fmt), qp, out_dtype=x.dtype)


def dynamic_qparams(x: torch.Tensor, fmt: IntFormat, axis=None,
                    symmetric: bool = True, clip_ratio: float = 1.0
                    ) -> QuantParams:
    """Per-call quantization params: ``axis=None`` per tensor, ``axis=-1``
    (kept) per token."""
    xf = x.float()
    if axis is None:
        xmin, xmax = xf.min(), xf.max()
    else:
        xmin = xf.amin(dim=axis, keepdim=True)
        xmax = xf.amax(dim=axis, keepdim=True)
    return scales_from_minmax(xmin * clip_ratio, xmax * clip_ratio, fmt,
                              symmetric)


def dynamic_fake_quant(x: torch.Tensor, bits: int = 8, per_token: bool = True,
                       symmetric: bool = True, clip_ratio: float = 1.0,
                       groupsize: Optional[int] = None) -> torch.Tensor:
    """One-shot dynamic fake quantization of an activation (…, T, C): one
    scale per token (``per_token``) or per tensor, in x's dtype. Per-group
    scales (``groupsize``) are not ported (ROADMAP A1)."""
    if groupsize is not None and groupsize > 0:
        raise NotImplementedError("per-token-per-group dynamic activations "
                                  "are not ported (ROADMAP A1)")
    fmt = get_format(bits, signed=symmetric)
    qp = dynamic_qparams(x, fmt, axis=-1 if per_token else None,
                         symmetric=symmetric, clip_ratio=clip_ratio)
    return fake_quantize(x, qp, fmt)


# ---------------------------------------------------------------------------
# weight quantization with optional MSE clip search
# ---------------------------------------------------------------------------


def weight_qparams(w: torch.Tensor, fmt: IntFormat, per_channel: bool = True,
                   symmetric: bool = True, mse_clip: bool = False,
                   clip_grid: int = 80, max_shrink: float = 0.8,
                   norm: float = 2.4, reduce_axes=None,
                   recip: bool = False) -> QuantParams:
    """Quantization params of a weight laid out (…, in, out): one scale per
    output channel (``per_channel``; every axis but the last reduced, or
    ``reduce_axes``, e.g. (-2,) for a stacked (L, in, out) weight) or one
    per tensor. ``mse_clip`` runs the MSE grid search over the shrinks
    1 − i·max_shrink/clip_grid, i < clip_grid, with error Σ |fq(w) − w|^norm
    per channel, as one batched computation over the grid (the JAX
    function's vmap); the first shrink of least error wins. ``recip``:
    constant divisions round as inside a jitted JAX function
    (:func:`_over`)."""
    wf = w.float()
    if reduce_axes is not None:
        axis = tuple(reduce_axes)
    else:
        axis = tuple(range(wf.ndim - 1)) if per_channel else None
    if axis is None:
        xmin, xmax = wf.min(), wf.max()
    else:
        xmin = wf.amin(dim=axis, keepdim=True)
        xmax = wf.amax(dim=axis, keepdim=True)
    if not mse_clip:
        return scales_from_minmax(xmin, xmax, fmt, symmetric, recip=recip)

    shrinks = 1.0 - (_over(torch.arange(clip_grid, dtype=torch.float32,
                                        device=wf.device), clip_grid, recip)
                     * max_shrink)
    grid = shrinks.reshape((clip_grid,) + (1,) * wf.ndim)
    qp = scales_from_minmax(xmin * grid, xmax * grid, fmt, symmetric,
                            recip=recip)
    e = (fake_quantize(wf, qp, fmt) - wf).abs() ** norm  # (grid, …, in, out)
    if axis is None:
        errs = e.reshape(clip_grid, -1).sum(-1)
    else:
        errs = e.sum(dim=tuple(a % wf.ndim + 1 for a in axis), keepdim=True)
    best = shrinks[errs.argmin(dim=0)]
    return scales_from_minmax(xmin * best, xmax * best, fmt, symmetric,
                              recip=recip)


def rtn_quantize_weight(w: torch.Tensor, bits: int, per_channel: bool = True,
                        symmetric: bool = True, mse_clip: bool = False,
                        reduce_axes=None):
    """Round-to-nearest weight quantization → (integer codes, params)."""
    fmt = get_format(bits, signed=symmetric)
    qp = weight_qparams(w, fmt, per_channel=per_channel, symmetric=symmetric,
                        mse_clip=mse_clip, reduce_axes=reduce_axes)
    return quantize(w, qp, fmt), qp


def rtn_fake_quant_weight(w: torch.Tensor, bits: int,
                          per_channel: bool = True, symmetric: bool = True,
                          mse_clip: bool = False, reduce_axes=None
                          ) -> torch.Tensor:
    """Round-to-nearest fake quantization of a weight, in w's dtype."""
    fmt = get_format(bits, signed=symmetric)
    qp = weight_qparams(w, fmt, per_channel=per_channel, symmetric=symmetric,
                        mse_clip=mse_clip, reduce_axes=reduce_axes)
    return fake_quantize(w, qp, fmt)
