"""Observers as functional reductions (counterpart of
``mquant_tpu/observe/observers.py``).

An observer is three plain functions over a small stats tuple:

    stats = init_stats(spec, channels)
    stats = update(spec, stats, activation)     # folded over the batches
    qp    = finalize(spec, stats, fmt, sample)  # → QuantParams

``merge`` folds one batch's (possibly layer-stacked) stats into running
stats. omse and ptf need a representative last batch (``sample``) to
finalize. The arithmetic follows the JAX functions op for op.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..core.formats import IntFormat
from ..core.quant import QuantParams, scales_from_minmax

OBSERVER_KINDS = ("minmax", "ema", "percentile", "omse", "ptf")


@dataclasses.dataclass(frozen=True)
class ObserverSpec:
    """Static description of one observer site."""

    kind: str = "minmax"  # one of OBSERVER_KINDS
    per_channel: bool = False  # False → per-tensor
    symmetric: bool = True
    ema_sigma: float = 0.01
    percentile_alpha: float = 0.99999

    def __post_init__(self):
        if self.kind not in OBSERVER_KINDS:
            raise ValueError(f"unknown observer kind {self.kind!r}")
        if self.kind == "percentile" and self.per_channel:
            raise ValueError("percentile observer is per-tensor only")


class ObserverStats(NamedTuple):
    """Running statistics: min / max, scalars or (C,) (with a leading (L,)
    axis once stacked over layers), and the update count ``n``."""

    min: torch.Tensor
    max: torch.Tensor
    n: torch.Tensor  # int32


def init_stats(spec: ObserverSpec, channels: Optional[int] = None,
               device="cuda") -> ObserverStats:
    shape = (channels,) if (spec.per_channel and channels is not None) else ()
    return ObserverStats(
        min=torch.zeros(shape, dtype=torch.float32, device=device),
        max=torch.zeros(shape, dtype=torch.float32, device=device),
        n=torch.zeros((), dtype=torch.int32, device=device))


def _reduce_minmax(spec: ObserverSpec, x: torch.Tensor,
                   mask: Optional[torch.Tensor]):
    """Per-update (min, max) over every axis but the channel (last) axis;
    ``mask`` (broadcastable to x's leading axes, 1 = valid token) keeps
    padded tokens out."""
    xf = x.float()
    if mask is not None:
        m = torch.broadcast_to(mask[..., None], xf.shape).bool()
        big = torch.finfo(torch.float32).max
        xmin_src = torch.where(m, xf, big)
        xmax_src = torch.where(m, xf, -big)
    else:
        xmin_src = xmax_src = xf
    if spec.per_channel:
        axes = tuple(range(xf.ndim - 1))
        return xmin_src.amin(dim=axes), xmax_src.amax(dim=axes)
    return xmin_src.min(), xmax_src.max()


def _quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(x, q)`` of a flat tensor (linear interpolation
    between the sorted neighbours); ``torch.quantile`` refuses more than
    2²⁴ values."""
    s = torch.sort(x).values
    pos = q * (s.numel() - 1)
    lo = int(pos)
    hi = min(lo + 1, s.numel() - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def update(spec: ObserverSpec, stats: ObserverStats, x: torch.Tensor,
           mask: Optional[torch.Tensor] = None) -> ObserverStats:
    """Fold one activation batch into the running stats. minmax and
    percentile widen the first range to include 0; ema / omse / ptf take
    the first batch raw."""
    if spec.kind == "percentile":
        xf = x.float().reshape(-1)
        if mask is not None:
            m = torch.broadcast_to(mask[..., None], x.shape).reshape(-1).bool()
            # padded entries become the batch median: quantiles ~unbiased
            med = _quantile(torch.where(m, xf, 0.0), 0.5)
            xf = torch.where(m, xf, med)
        cur_max = _quantile(xf, spec.percentile_alpha)
        cur_min = _quantile(xf, 1.0 - spec.percentile_alpha)
    else:
        cur_min, cur_max = _reduce_minmax(spec, x, mask)

    first = stats.n == 0
    while first.ndim < cur_min.ndim:
        first = first[..., None]
    clamp0 = spec.kind in ("minmax", "percentile")
    first_min = torch.clamp(cur_min, max=0.0) if clamp0 else cur_min
    first_max = torch.clamp(cur_max, min=0.0) if clamp0 else cur_max
    if spec.kind in ("ema", "percentile"):
        sigma = spec.ema_sigma
        new_min = torch.where(first, first_min,
                              stats.min + sigma * (cur_min - stats.min))
        new_max = torch.where(first, first_max,
                              stats.max + sigma * (cur_max - stats.max))
    else:  # minmax / omse / ptf: running extrema
        new_min = torch.where(first, first_min,
                              torch.minimum(cur_min, stats.min))
        new_max = torch.where(first, first_max,
                              torch.maximum(cur_max, stats.max))
    return ObserverStats(min=new_min, max=new_max, n=stats.n + 1)


def merge(spec: ObserverSpec, a: ObserverStats, b: ObserverStats
          ) -> ObserverStats:
    """Merge batch-local stats ``b`` into running stats ``a``: ema /
    percentile take ``b`` as one update, the others elementwise extrema."""
    a_empty, b_empty = a.n == 0, b.n == 0
    while a_empty.ndim < a.min.ndim:  # stacked n (L,) vs (L, C) extrema
        a_empty = a_empty[..., None]
    while b_empty.ndim < b.min.ndim:
        b_empty = b_empty[..., None]
    if spec.kind in ("ema", "percentile"):
        sigma = spec.ema_sigma
        new_min = torch.where(a_empty, b.min, a.min + sigma * (b.min - a.min))
        new_max = torch.where(a_empty, b.max, a.max + sigma * (b.max - a.max))
    else:
        new_min = torch.where(a_empty, b.min, torch.minimum(a.min, b.min))
        new_max = torch.where(a_empty, b.max, torch.maximum(a.max, b.max))
    new_min = torch.where(b_empty, a.min, new_min)
    new_max = torch.where(b_empty, a.max, new_max)
    return ObserverStats(min=new_min, max=new_max, n=a.n + b.n)


# ---------------------------------------------------------------------------
# finalize
# ---------------------------------------------------------------------------

# the reference observers clamp scales at float32 eps
_REF_EPS = float(torch.finfo(torch.float32).eps)


def _fake_quant_affine(x, scale, zero_point, fmt: IntFormat):
    q = torch.clamp(torch.round(x / scale) + zero_point, fmt.qmin, fmt.qmax)
    return (q - zero_point) * scale


def _affine_params(xmin, xmax, fmt: IntFormat) -> QuantParams:
    """Asymmetric: the scale spans [min, max] over the whole integer range;
    the zero point is rounded and clamped into it."""
    scale = torch.clamp((xmax - xmin) / float(fmt.qmax - fmt.qmin),
                        min=_REF_EPS)
    zp = torch.clamp(fmt.qmin - torch.round(xmin / scale), fmt.qmin, fmt.qmax)
    return QuantParams(scale=scale, zero_point=zp)


def _symmetric_scale(spec: ObserverSpec, stats: ObserverStats,
                     fmt: IntFormat) -> QuantParams:
    """The kinds' symmetric conventions differ: ema takes
    max(−min, max) / ((qmax − qmin) / 2); minmax / percentile
    max(|min / qmin|, |max / qmax|)."""
    if spec.kind == "ema":
        amax = torch.maximum(-stats.min, stats.max)
        scale = amax / (float(fmt.qmax - fmt.qmin) / 2.0)
    else:
        scale = torch.maximum(torch.abs(stats.min / fmt.qmin),
                              torch.abs(stats.max / fmt.qmax))
    return QuantParams(scale=torch.clamp(scale, min=_REF_EPS),
                       zero_point=None)


def _finalize_omse(spec, stats, fmt, sample):
    """90-step shrink search of the L2 reconstruction loss, all shrinks at
    once (the JAX function's vmap); symmetric specs search zero-point-free
    scales."""
    x = sample.float()
    shrinks = 1.0 - torch.arange(90, dtype=torch.float32,
                                 device=x.device) * 0.01

    def params_for(shrink):
        if spec.symmetric:
            return scales_from_minmax(stats.min * shrink, stats.max * shrink,
                                      fmt, True)
        return _affine_params(stats.min * shrink, stats.max * shrink, fmt)

    grid = shrinks.reshape((90,) + (1,) * stats.min.ndim)
    qp = params_for(grid)
    zp = qp.zero_point if qp.zero_point is not None else torch.zeros_like(
        qp.scale)
    lead = (1,) * x.ndim
    scale = qp.scale.reshape(qp.scale.shape[:1] + lead[:x.ndim - stats.min.ndim]
                             + qp.scale.shape[1:])
    zp = zp.reshape(scale.shape)
    xq = _fake_quant_affine(x[None], scale, zp, fmt)
    scores = (x[None] - xq).abs().pow(2.0).reshape(90, -1).mean(dim=1)
    return params_for(shrinks[torch.argmin(scores)])


def _finalize_ptf(spec, stats, fmt, sample):
    """Power-of-two-factor per-channel scales (FQ-ViT): one per-tensor base
    scale, a per-channel multiplier in {1, 2, 4, 8} by L2 loss, all four at
    once."""
    x = sample.float()  # (..., C)
    qp8 = _affine_params(stats.min.min(), stats.max.max(), fmt)
    scale8, zp = qp8.scale, qp8.zero_point
    scale1 = scale8 / 8.0
    mult = torch.tensor([1.0, 2.0, 4.0, 8.0], device=x.device)
    cand = (scale1 * mult).reshape((4,) + (1,) * x.ndim)
    xq = _fake_quant_affine(x[None], cand, zp, fmt)
    axes = tuple(range(1, x.ndim))
    scores = (xq - x[None]).abs().pow(2.0).mean(dim=axes)  # (4, C)
    scale = scale1 * mult[torch.argmin(scores, dim=0)]
    return QuantParams(scale=scale,
                       zero_point=torch.broadcast_to(zp, scale.shape))


def finalize(spec: ObserverSpec, stats: ObserverStats, fmt: IntFormat,
             sample: Optional[torch.Tensor] = None) -> QuantParams:
    """Stats → static (scale, zero_point). omse / ptf need ``sample``, a
    representative final batch."""
    if spec.kind in ("minmax", "ema", "percentile"):
        if spec.symmetric:
            return _symmetric_scale(spec, stats, fmt)
        return _affine_params(stats.min, stats.max, fmt)
    if sample is None:
        raise ValueError(f"{spec.kind} observer requires a `sample` batch to "
                         "finalize")
    if spec.kind == "omse":
        return _finalize_omse(spec, stats, fmt, sample)
    return _finalize_ptf(spec, stats, fmt, sample)
