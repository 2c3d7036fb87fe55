"""Sensitivity-based mixed-precision weight bits and the lm_head width gate
(counterpart of ``mquant_tpu/utils/autobits.py``).

Each quant site's sensitivity is the end-to-end relative logit error when
only that site's weights are round-to-nearest quantized at the low width
(one forward per site on a calibration batch); the most damaging sites are
then promoted to the high width by a greedy benefit-per-element knapsack
under a budget of average bits per weight. The result overrides the
sites' ``w_bits`` in the spec dict, which GPTQ, calibration, realization
and serving read. The head gate fake-quantizes only the lm_head at each
width and keeps the low one iff its head-only perplexity ratio stays under
a budget. Forwards run in mode "fake" with :func:`transform_only_specs`,
so the online Hadamard and RMS split folded into the rotated weights stay
applied.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

# spec prefix → params top key ("vis.fc1" lives under params["vit"])
_PREFIX_TO_TOP = {"vis": "vit"}

# the head-only perplexity-ratio budget: a W4 head is accepted iff its ratio
# stays under this (shared with ``bench.resolve_bench_head``)
HEAD_GATE_DEFAULT = 1.002


def _find_site_arrays(tree, local: str) -> List[torch.Tensor]:
    """Every weight tensor under dict entries named ``local`` (any depth)."""
    found = []
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == local and isinstance(v, dict):
                w = v.get("w", v.get("w_q"))
                if w is not None:
                    found.append(w)
            else:
                found.extend(_find_site_arrays(v, local))
    return found


def site_weight_elems(params: Dict, specs: Dict) -> Dict[str, int]:
    """Weight elements per quant site (a layer-stacked site counts all its
    layers: one SiteSpec governs the stack)."""
    elems = {}
    for name in specs:
        prefix, local = name.split(".", 1)
        top = params.get(_PREFIX_TO_TOP.get(prefix, prefix))
        if top is None:
            continue
        arrs = _find_site_arrays(top, local)
        if arrs:
            elems[name] = int(sum(a.numel() for a in arrs))
    return elems


def _map_site_weights(tree, local: str, fn):
    """Copy of ``tree`` with every ``local`` site's "w" replaced by fn(w)."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k == local and isinstance(v, dict) and v.get("w") is not None:
            out[k] = {**v, "w": fn(v["w"])}
        else:
            out[k] = _map_site_weights(v, local, fn)
    return out


def transform_only_specs(specs: Dict) -> Dict:
    """The specs with all quantization off but the runtime transforms
    (online Hadamard, RMS split) kept: after rotation they are part of the
    model's math."""
    return {n: dataclasses.replace(s, w_bits=None, a_bits=None,
                                   out_bits=None)
            for n, s in specs.items()}


def _rtn(bits: int):
    """Per-output-channel symmetric minmax fake quantization at ``bits``
    (the offline RTN grid: the input axis reduced, a stacked (L, in, out)
    weight keeping per-layer-per-column scales), in the weight's dtype."""
    from ..core import quant as Q
    from ..core.formats import get_format

    fmt = get_format(bits, signed=True)

    def fq(w):
        qp = Q.weight_qparams(w, fmt, per_channel=True, symmetric=True,
                              reduce_axes=(-2,))
        return Q.fake_quantize(w, qp, fmt).to(w.dtype)

    return fq


def _fake_forward(cfg, batch: dict, specs: Dict):
    from ..pipeline import batch_forward

    tspecs = transform_only_specs(specs)

    def run(p):
        out, _, _ = batch_forward(cfg, p, batch, specs=tspecs, mode="fake")
        return out

    return run


def site_sensitivities(cfg, params: Dict, specs: Dict, batch: dict,
                       low_bits: int = 4) -> Dict[str, float]:
    """‖y_q − y‖ / ‖y‖ of the logits with only that site's weights
    fake-quantized at ``low_bits`` (per-output-channel minmax, float
    activations), for every site with weight bits."""
    run = _fake_forward(cfg, batch, specs)
    fq = _rtn(low_bits)
    ref = run(params)
    denom = float(torch.linalg.vector_norm(ref.float())) + 1e-9
    sens = {}
    for name, spec in specs.items():
        if spec.w_bits is None:
            continue
        prefix, local = name.split(".", 1)
        top_key = _PREFIX_TO_TOP.get(prefix, prefix)
        if top_key not in params:
            continue
        probe = dict(params)
        probe[top_key] = _map_site_weights(params[top_key], local, fq)
        y = run(probe)
        del probe
        sens[name] = float(torch.linalg.vector_norm((y - ref).float())) / denom
    return sens


def allocate_bits(sens: Dict[str, float], elems: Dict[str, int],
                  target_avg_bits: float, low: int = 4,
                  high: int = 8) -> Dict[str, int]:
    """Greedy knapsack: every site starts at ``low``; promote to ``high``
    in descending sensitivity-per-element order while the promoted extra
    bits keep the average ≤ ``target_avg_bits``."""
    names = [n for n in sens if n in elems]
    total = sum(elems[n] for n in names)
    bits = {n: low for n in names}
    if not names or target_avg_bits <= low:
        return bits
    budget = (min(target_avg_bits, high) - low) * total
    per_elem_cost = high - low
    for n in sorted(names, key=lambda n: sens[n] / max(elems[n], 1),
                    reverse=True):
        cost = elems[n] * per_elem_cost
        if cost <= budget:
            bits[n] = high
            budget -= cost
    return bits


def autobits_specs(cfg, params: Dict, specs: Dict, batch: dict,
                   target_avg_bits: float, low: int = 4, high: int = 8
                   ) -> Tuple[Dict, Dict[str, float], Dict[str, int]]:
    """(specs with w_bits overridden, sensitivities, allocation). Run after
    rotation and before GPTQ / calibration, which read the returned specs."""
    sens = site_sensitivities(cfg, params, specs, batch, low_bits=low)
    elems = site_weight_elems(params, specs)
    bits = allocate_bits(sens, elems, target_avg_bits, low=low, high=high)
    new_specs = dict(specs)
    for name, b in bits.items():
        new_specs[name] = dataclasses.replace(specs[name], w_bits=b)
    return new_specs, sens, bits


def head_quantized_decoder(dec_params: Dict, bits: int) -> Dict:
    """Decoder-tree copy (lm_head at top level) with only the lm_head
    weights round-to-nearest fake-quantized at ``bits`` (per-output-channel
    symmetric minmax), in the weights' dtype."""
    return _map_site_weights(dec_params, "lm_head", _rtn(bits))


def head_quantized_params(params: Dict, bits: int) -> Dict:
    """VLM-params copy with only the lm_head fake-quantized at ``bits``."""
    return {**params, "llm": head_quantized_decoder(params["llm"], bits)}


def ppl_ratio_from_logits(lf: torch.Tensor, lq: torch.Tensor) -> float:
    """exp(mean(CE(p_f, q) − H(p_f))) over the rows of full-precision
    logits ``lf`` and quantized logits ``lq`` (1.0 = no degradation)."""
    lf, lq = lf.float(), lq.float()
    pf = torch.softmax(lf, -1)
    ce_q = -(pf * torch.log_softmax(lq, -1)).sum(-1)
    ce_f = -(pf * torch.log_softmax(lf, -1)).sum(-1)
    return float(torch.exp((ce_q - ce_f).mean()))


def decide_head_bits(cfg, params: Dict, specs: Dict, batch: dict,
                     low: int = 4, high: int = 8,
                     gate: float = HEAD_GATE_DEFAULT
                     ) -> Tuple[int, Dict[int, float]]:
    """The lm_head's width: the perplexity ratio of quantizing only the
    head at ``low`` and at ``high``; ``low`` iff its ratio stays under
    ``gate``. Returns (bits, {bits: ratio})."""
    run = _fake_forward(cfg, batch, specs)
    lf = run(params)
    ratios = {b: ppl_ratio_from_logits(lf, run(head_quantized_params(
        params, b))) for b in (low, high)}
    return (low if ratios[low] <= gate else high), ratios


def rtn_apply_bits(params: Dict, bits: Dict[str, int]) -> Dict:
    """Params copy with each site's weights fake-quantized at its allocated
    width (the probe's grid): a quick what-if of an allocation."""
    out = dict(params)
    for name, b in bits.items():
        prefix, local = name.split(".", 1)
        top_key = _PREFIX_TO_TOP.get(prefix, prefix)
        if top_key in out:
            out[top_key] = _map_site_weights(out[top_key], local, _rtn(b))
    return out


def allocation_report(sens: Dict[str, float], elems: Dict[str, int],
                      bits: Dict[str, int]) -> str:
    lines = [f"{'site':24s} {'sens':>10s} {'Melems':>8s} {'bits':>5s}"]
    for n in sorted(bits, key=lambda n: sens.get(n, 0.0), reverse=True):
        lines.append(f"{n:24s} {sens.get(n, 0.0):10.4f} "
                     f"{elems.get(n, 0) / 1e6:8.2f} {bits[n]:5d}")
    total = sum(elems.get(n, 0) for n in bits)
    avg = (sum(elems.get(n, 0) * b for n, b in bits.items()) / total
           if total else 0.0)
    lines.append(f"{'average':24s} {'':>10s} {total / 1e6:8.2f} {avg:5.2f}")
    return "\n".join(lines)
