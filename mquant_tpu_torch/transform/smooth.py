"""SmoothQuant-style migration of activation outliers into the weights
(counterpart of ``mquant_tpu/transform/smooth.py``).

Each input channel j of a norm-fed site group gets the scale

    s_j = amax_x[j]^alpha / amax_w[j]^(1 - alpha)

folded as 1/s into the preceding RMSNorm weight and as s into the group's
weights: the float forward is unchanged while the activations flatten. It
runs before rotation (which mixes channels), on the decoder's groups
ln1 → q/k/v and ln2 → gate/up.

The arithmetic is float64, as the JAX module's numpy: the scales with
numpy's ``pow`` on the host, the weights' products and the norms' quotients
(exactly rounded IEEE operations, the same on any device) a layer at a time
on the weights' device, then rounded to the weights' dtype. The smoothed
weights are the JAX function's bit for bit.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().double().cpu().numpy()
    return np.asarray(x, np.float64)


def _wmax(w: torch.Tensor) -> np.ndarray:
    """max |w| over the output axis, (L, H), in float64 (exact)."""
    return w.detach().abs().amax(dim=-1).double().cpu().numpy()


def smooth_scales(act_amax, weights: Sequence, alpha: float,
                  eps: float = 1e-5) -> np.ndarray:
    """Per-input-channel migration scales (L, H) of one norm-fed group:
    ``act_amax`` (L, H) at the group's shared input, ``weights`` its (L,
    H, out) weights; clipped away from 0 so degenerate channels become
    no-ops."""
    a = np.maximum(_f64(act_amax), eps)
    wmax = np.maximum.reduce([_wmax(w) for w in weights])
    wmax = np.maximum(wmax, eps)
    s = a ** alpha / wmax ** (1.0 - alpha)
    return np.maximum(s, eps)


def smooth_decoder(llm_params: Dict, act_amax: Dict[str, np.ndarray],
                   alpha: float = 0.5) -> Dict:
    """Migration on the decoder's two norm-fed groups. ``act_amax``:
    {"attn": (L, H) amax of the ln1 output, "mlp": (L, H) of the ln2
    output} (:func:`collect_llm_channel_amax`). Returns new params."""
    layers = dict(llm_params["layers"])
    for ln_name, sites, key in (("ln1", ("q", "k", "v"), "attn"),
                                ("ln2", ("gate", "up"), "mlp")):
        s = smooth_scales(act_amax[key], [layers[n]["w"] for n in sites],
                          alpha)
        ln = layers[ln_name]["w"]
        s_t = torch.from_numpy(s).to(ln.device)
        layers[ln_name] = dict(layers[ln_name],
                               w=(ln.double() / s_t).to(ln.dtype))
        for n in sites:
            w = layers[n]["w"]
            out = torch.empty_like(w)
            for li in range(w.shape[0]):  # a layer at a time: float64 copies
                out[li] = (w[li].double() * s_t[li, :, None]).to(w.dtype)
            layers[n] = dict(layers[n], w=out)
    return dict(llm_params, layers=layers)


def collect_llm_channel_amax(cfg, params: Dict, calib_batches,
                             a_bits: int = 8) -> Dict[str, np.ndarray]:
    """Per-channel activation |max| (float64, on the host) at the decoder's
    norm-fed inputs, from one calibration pass with per-channel minmax
    observers on llm.q (the ln1 output, shared by k / v) and llm.gate (the
    ln2 output, shared by up)."""
    from ..models.layers import SiteSpec
    from ..pipeline import calibrate_activations

    qmax = 2 ** (a_bits - 1) - 1
    spec = SiteSpec(a_bits=a_bits, a_static=True, a_per_channel=True,
                    observer="minmax")
    tmp = {"llm.q": spec, "llm.gate": spec}
    state = calibrate_activations(cfg, params, tmp, calib_batches)
    return {key: _f64(state[site]["act"].scale) * qmax
            for key, site in (("attn", "llm.q"), ("mlp", "llm.gate"))}
