"""Quantization diagnostics (counterpart of
``mquant_tpu/utils/diagnostics.py``): activation capture and a per-site
summary of its distribution, the per-site quantization configuration with
its calibrated scale range, and the end-to-end logit error with
quantization on per subsystem (vision only, LLM only, all)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def capture_activations(forward_with_stats, *batch) -> Dict[str, np.ndarray]:
    """Per-site input activations of one batch, on the host.
    ``forward_with_stats``: a forward with mode "calib" and collect_stats
    set, taking ``collect_samples``; a layer-stacked site gives (L,
    tokens, C)."""
    _, (_, samples) = forward_with_stats(*batch, collect_samples=True)
    return {k: v.detach().float().cpu().numpy() for k, v in samples.items()}


def activation_summary(samples: Dict[str, np.ndarray]) -> str:
    """A table of absmax, the 99.9% quantile of |x|, rms and kurtosis per
    site: which sites carry outliers."""
    lines = [f"{'site':24s} {'absmax':>10s} {'q99.9':>10s} {'rms':>10s} "
             f"{'kurt':>8s}"]
    for name in sorted(samples):
        x = np.asarray(samples[name]).astype(np.float64).ravel()
        absmax = np.abs(x).max()
        q = np.quantile(np.abs(x), 0.999)
        rms = np.sqrt((x ** 2).mean())
        kurt = ((x - x.mean()) ** 4).mean() / max((x.var()) ** 2, 1e-12)
        lines.append(f"{name:24s} {absmax:10.3f} {q:10.3f} {rms:10.4f} "
                     f"{kurt:8.1f}")
    return "\n".join(lines)


def quant_config_report(specs: Dict, state: Optional[Dict] = None) -> str:
    """Per-site weight and activation settings, transforms and calibrated
    activation scales (min..max over the layers)."""
    lines = [f"{'site':24s} {'W':>4s} {'A':>10s} {'transform':>12s} "
             f"{'act scale':>18s}"]
    for name in sorted(specs):
        s = specs[name]
        a = ("-" if s.a_bits is None else
             f"a{s.a_bits}{'s' if s.a_static else 'd'}"
             f"{'' if s.a_symmetric else 'z'}")
        tr = []
        if s.online_had:
            tr.append(f"had:{s.online_had}")
        if s.split:
            tr.append("split")
        sc = ""
        st = (state or {}).get(name, {})
        if st and st.get("act") is not None:
            scale = st["act"].scale.detach().float().cpu().numpy()
            sc = (f"{scale.min():.2e}" if scale.size == 1
                  else f"{scale.min():.2e}..{scale.max():.2e}")
        w = "-" if s.w_bits is None else f"w{s.w_bits}"
        lines.append(f"{name:24s} {w:>4s} {a:>10s} "
                     f"{','.join(tr) or '-':>12s} {sc:>18s}")
    return "\n".join(lines)


def quant_error_report(cfg, params_fp: Dict, params_q: Dict, batch: dict,
                       specs: Dict, state: Optional[Dict] = None
                       ) -> Dict[str, float]:
    """‖y − y_fp‖ / ‖y_fp‖ of the logits with quantization on for the
    vision sites only, the LLM sites only, and all."""
    from ..pipeline import batch_forward

    def run(p, sp, mode):
        out, _, _ = batch_forward(cfg, p, batch, specs=sp, state=state,
                                  mode=mode)
        return out

    ref = run(params_fp, None, "fp")
    out = {}
    for label, pred in (("visual_only", lambda k: not k.startswith("llm.")),
                        ("llm_only", lambda k: k.startswith("llm.")),
                        ("all", lambda k: True)):
        sp = {k: v for k, v in specs.items() if pred(k)}
        y = run(params_q, sp, "fake")
        out[label] = float(torch.linalg.vector_norm(y - ref)
                           / (torch.linalg.vector_norm(ref) + 1e-9))
    return out
