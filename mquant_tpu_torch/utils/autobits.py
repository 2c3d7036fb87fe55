"""The lm_head width gate (counterpart of the head-gate part of
``mquant_tpu/utils/autobits.py``): fake-quantize only the lm_head at a bit
width and compare the head-only perplexity ratio against a budget. The
site-sensitivity allocator of the JAX module is not ported yet.
"""

from __future__ import annotations

from typing import Dict

import torch

# the head-only perplexity-ratio budget: a W4 head is accepted iff its ratio
# stays under this (shared with ``bench.resolve_bench_head``)
HEAD_GATE_DEFAULT = 1.002


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


def head_quantized_decoder(dec_params: Dict, bits: int) -> Dict:
    """Decoder-tree copy (lm_head at top level) with only the lm_head
    weights round-to-nearest fake-quantized at ``bits`` (per-output-channel
    symmetric minmax), in the weights' dtype."""
    from ..core import quant as Q
    from ..core.formats import get_format

    fmt = get_format(bits, signed=True)

    def fq(w):
        qp = Q.weight_qparams(w, fmt, per_channel=True, symmetric=True,
                              reduce_axes=(-2,) if w.ndim == 3 else None)
        return Q.fake_quantize(w, qp, fmt).to(w.dtype)

    return _map_site_weights(dec_params, "lm_head", fq)


def ppl_ratio_from_logits(lf: torch.Tensor, lq: torch.Tensor) -> float:
    """exp(mean(CE(p_f, q) − H(p_f))) over the rows of full-precision
    logits ``lf`` and quantized logits ``lq`` (1.0 = no degradation)."""
    lf, lq = lf.float(), lq.float()
    pf = torch.softmax(lf, -1)
    ce_q = -(pf * torch.log_softmax(lq, -1)).sum(-1)
    ce_f = -(pf * torch.log_softmax(lf, -1)).sum(-1)
    return float(torch.exp((ce_q - ce_f).mean()))
