"""Quantization primitives (counterpart of ``mquant_tpu/core/quant.py``).

Plain functions on tensors. The op order follows the JAX package exactly, so
integer codes are bit-equal: ``quantize`` multiplies by ``1/scale`` (while
``kernels.qmm.quantize_weights_real`` divides, as its JAX twin does), and
``torch.round`` rounds half to even like ``jnp.round``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .formats import IntFormat


class QuantParams(NamedTuple):
    """Static quantization parameters of one tensor site. ``zero_point`` is
    None for symmetric quantization."""

    scale: torch.Tensor
    zero_point: Optional[torch.Tensor] = None


def scales_from_minmax(xmin: torch.Tensor, xmax: torch.Tensor, fmt: IntFormat,
                       symmetric: bool = True, eps: float = 1e-8
                       ) -> QuantParams:
    """(min, max) statistics → (scale, zero_point); the range is widened to
    include 0 so that zero is exactly representable."""
    xmin = torch.clamp(xmin.float(), max=0.0)
    xmax = torch.clamp(xmax.float(), min=0.0)
    if symmetric:
        amax = torch.maximum(xmin.abs(), xmax.abs())
        return QuantParams(scale=torch.clamp(amax / fmt.qmax, min=eps))
    scale = torch.clamp((xmax - xmin) / (fmt.qmax - fmt.qmin), min=eps)
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
