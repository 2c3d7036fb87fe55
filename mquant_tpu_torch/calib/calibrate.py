"""Static activation calibration (counterpart of
``mquant_tpu/calib/calibrate.py``).

Three phases: each calibration forward (mode "calib", stats collected)
returns per-site ObserverStats, stacked over layers for the decoder and ViT
blocks, which :func:`merge_stats` folds into running stats; the last batch
may also return raw samples for omse / ptf; :func:`finalize_state` turns
the stats into static QuantParams, ``{site: {"act": QuantParams}}``, the
``state`` the fake and real modes read. Separate vision / merger / LLM
scale sets (MSQ) follow from the site names' prefixes.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

from ..core import quant as Q
from ..core.formats import get_format
from ..models.layers import SiteSpec
from ..observe import observers as O


def merge_stats(specs: Dict[str, SiteSpec],
                running: Optional[Dict[str, O.ObserverStats]],
                batch: Dict[str, O.ObserverStats]
                ) -> Dict[str, O.ObserverStats]:
    """Fold one batch's (possibly layer-stacked) stats into the running
    stats."""
    if running is None:
        return batch
    out = dict(running)
    for name, b in batch.items():
        a = running.get(name)
        out[name] = b if a is None else O.merge(specs[name].observer_spec(),
                                                a, b)
    return out


def finalize_state(specs: Dict[str, SiteSpec],
                   stats: Dict[str, O.ObserverStats],
                   samples: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Dict[str, Dict[str, Q.QuantParams]]:
    """Stats → static quant state {site: {"act": QuantParams}}. Stacked
    (L, ...) stats finalize elementwise (minmax / ema / percentile) or layer
    by layer (omse / ptf, on their samples). Output quantizers' ``#out``
    stats are not ported (``qlinear`` refuses ``out_bits``)."""
    state: Dict[str, Dict[str, Q.QuantParams]] = {}
    for name, st in stats.items():
        spec = specs[name]
        if spec.a_bits is None:
            continue
        fmt = get_format(spec.a_bits, signed=spec.a_symmetric)
        ospec = spec.observer_spec()
        needs_sample = ospec.kind in ("omse", "ptf")
        sample = (samples or {}).get(name) if needs_sample else None
        if st.n.ndim > 0 and needs_sample:  # stacked over layers
            if sample is None:
                raise ValueError(f"{name}: {ospec.kind} requires samples")
            per = [O.finalize(ospec, O.ObserverStats(st.min[i], st.max[i],
                                                     st.n[i]), fmt, sample[i])
                   for i in range(st.n.shape[0])]
            qp = Q.QuantParams(
                torch.stack([p.scale for p in per]),
                None if per[0].zero_point is None
                else torch.stack([p.zero_point for p in per]))
        else:
            qp = O.finalize(ospec, st, fmt, sample)
        state[name] = {"act": qp}
    return state


def calibrate(forward_with_stats: Callable[..., Tuple[Any, Tuple[Dict, Dict]]],
              batches: Iterable[tuple], specs: Dict[str, SiteSpec]
              ) -> Dict[str, Dict[str, Q.QuantParams]]:
    """The calibration loop. ``forward_with_stats(*batch,
    collect_samples=bool)`` returns ``(_, (stats, samples))``, e.g. a
    partial of ``qwen2vl_forward`` with mode="calib" and
    collect_stats=True; the final batch also collects samples when an omse
    / ptf site needs them."""
    batches = list(batches)
    needs_samples = any(s.observer in ("omse", "ptf") for s in specs.values())
    running: Optional[Dict] = None
    samples = None
    for i, b in enumerate(batches):
        last = i == len(batches) - 1
        _, (stats, smp) = forward_with_stats(
            *b, collect_samples=last and needs_samples)
        running = merge_stats(specs, running, stats)
        if last and needs_samples:
            samples = smp
    return finalize_state(specs, running or {}, samples)
