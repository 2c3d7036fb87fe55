"""GPTQ driver for the stacked decoder, stage-sequential (counterpart of
``mquant_tpu/gptq/driver.py``, its resident mode).

Layers go in order; within a layer the site groups go in dependency order
[q, k, v] → [o] → [gate, up] → [down], each group's Hessian taken on its
inputs re-derived with the groups before it already quantized; then the
quantized layer produces the next layer's inputs. The caller hands in the
decoder-input hidden states (embedding + vision splice). Activations stay
in floating point (the activation quantizers are stripped), while the
online Hadamard and the RMS split are on, so ``down``'s Hessian sees its
serving-time input. The whole model stays on its device; the quantized
weights go into new stacked tensors one layer at a time. The JAX
package's host-streaming modes for 16 GB chips are not ported (ROADMAP
A10).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from ..models import layers as L
from ..models.layers import SiteSpec, qlinear
from ..models.llm import DecoderConfig, layer_views, rope_tables
from . import core as C

STAGES = ("qkv", "o", "gu", "down", "next")


def _strip_act_quant(specs: Dict[str, SiteSpec]) -> Dict[str, SiteSpec]:
    """The specs with activation quantization off (transforms kept)."""
    return {k: dataclasses.replace(v, a_bits=None, a_static=False)
            for k, v in (specs or {}).items()}


def make_stage_fn(cfg: DecoderConfig, specs: Dict[str, SiteSpec],
                  stage: str):
    """One layer replayed up to ``stage``'s input: "qkv" the post-ln1
    input, "o" the attention output, "gu" the post-ln2 input, "down" the
    post-Hadamard swiglu, "next" the layer's output."""
    specs = _strip_act_quant(specs)

    def site(nm):
        return specs.get("llm." + nm)

    def f(lp, h, cos, sin, mask):
        B, T, _ = h.shape
        hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        x1 = L.rms_norm(h, lp["ln1"]["w"], cfg.norm_eps)
        if stage == "qkv":
            return x1
        q = qlinear(x1, lp["q"], "llm.q", site("q"), None, "fake")
        k = qlinear(x1, lp["k"], "llm.k", site("k"), None, "fake")
        v = qlinear(x1, lp["v"], "llm.v", site("v"), None, "fake")
        q, k = L.apply_rope(q.reshape(B, T, H, hd), k.reshape(B, T, KV, hd),
                            cos, sin)
        attn = L.attention(q, k, v.reshape(B, T, KV, hd), mask).reshape(
            B, T, H * hd)
        if stage == "o":
            return attn
        h2 = h + qlinear(attn, lp["o"], "llm.o", site("o"), None, "fake")
        x2 = L.rms_norm(h2, lp["ln2"]["w"], cfg.norm_eps)
        if stage == "gu":
            return x2
        g = qlinear(x2, lp["gate"], "llm.gate", site("gate"), None, "fake")
        u = qlinear(x2, lp["up"], "llm.up", site("up"), None, "fake")
        a = L.swiglu(g, u)
        dspec = site("down")
        if dspec is not None and dspec.online_had is not None:
            a = L._online_hadamard(a, dspec)
        if stage == "down":
            return a
        nohad = (dataclasses.replace(dspec, online_had=None) if dspec
                 else None)
        return h2 + qlinear(a, lp["down"], "llm.down", nohad, None, "fake")

    return f


@dataclasses.dataclass
class GPTQConfig:
    """The reference CLI's knobs (--percdamp --act_order --w_groupsize
    --w_clip, --w_asym); --llm_w_rtn goes to
    ``transform.recipes.rtn_quantize_decoder`` instead."""

    percdamp: float = 0.01
    act_order: bool = False
    group_size: Optional[int] = None
    mse_clip: bool = False
    sym: bool = True


def _track(report, name, fb):
    if fb is None:
        return
    report["sites"] += 1
    if fb:
        report["fallbacks"].append(name)


def gptq_quantize_decoder(cfg: DecoderConfig, params: Dict,
                          hidden_batches: List[torch.Tensor],
                          specs: Dict[str, SiteSpec],
                          gcfg: GPTQConfig = GPTQConfig()) -> tuple:
    """GPTQ every spec'd decoder weight. ``hidden_batches``: the
    decoder-input embeddings (B, T, hidden) per batch, at arange RoPE
    positions (as the JAX pipeline calls its driver; ROADMAP C-w16).
    Returns (params, report): report["fallbacks"] names the
    sites whose factorization failed (RTN taken), report["sites"] counts
    the GPTQ'd sites, report["qparams"] = {site: (scale (L, G, out), zero
    (L, G, out) or None, perm (L, in) or None)}, the exact grids of the
    fake-quantized weights (perm only under act_order × group_size), and
    report["seconds"] the device seconds of the Hessians' stage replays
    ("hessian"), the factorizations ("factor") and the walks ("walk")."""
    nL = cfg.n_layers
    stage_fns = {s: make_stage_fn(cfg, specs, s) for s in STAGES}
    seconds: Dict[str, float] = {"hessian": 0.0}
    dev = hidden_batches[0].device

    def tick():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    pre = []
    for h in hidden_batches:
        B, T, _ = h.shape
        pos = torch.arange(T, device=dev)[None].expand(B, T)
        cos, sin = rope_tables(cfg, pos, torch.float32)
        pre.append((cos, sin, L.causal_mask(T, T, device=dev)))

    def quantize_site(lp, name, H):
        """(lp, used_fallback, (scale, zero, perm)) — the exact grid the
        fake-quantized weight lies on — or (lp, None, None) for a site
        without weight bits."""
        spec = specs.get("llm." + name)
        if spec is None or spec.w_bits is None:
            return lp, None, None
        site_p = dict(lp[name])
        w = site_p["w"].float()
        res = C.gptq_quantize_matrix(
            w, H, bits=spec.w_bits, percdamp=gcfg.percdamp,
            act_order=gcfg.act_order, group_size=gcfg.group_size,
            mse_clip=gcfg.mse_clip, sym=gcfg.sym, seconds=seconds)
        site_p["w"] = res.w.to(lp[name]["w"].dtype)
        perm = res.perm if (gcfg.act_order and gcfg.group_size) else None
        return ({**lp, name: site_p}, bool(res.used_fallback),
                (res.scale, res.zero, perm))

    def hessian(lp, hb, stage, drop_col0=False):
        t0 = tick()
        Hs = None
        for h, (cos, sin, mask) in zip(hb, pre):
            x = stage_fns[stage](lp, h, cos, sin, mask)
            Hs = C.accumulate_hessian(Hs, x[..., 1:] if drop_col0 else x)
        seconds["hessian"] += tick() - t0
        return Hs

    report = {"fallbacks": [], "sites": 0, "qparams": []}
    hb = hidden_batches
    out_w: Dict[str, torch.Tensor] = {}
    for li in range(nL):
        lp = layer_views(params["layers"], li)
        layer_qps = {}
        Hq = hessian(lp, hb, "qkv")
        for s in ("q", "k", "v"):
            lp, fb, layer_qps[s] = quantize_site(lp, s, Hq)
            _track(report, f"L{li}.{s}", fb)
        del Hq
        lp, fb, layer_qps["o"] = quantize_site(lp, "o", hessian(lp, hb, "o"))
        _track(report, f"L{li}.o", fb)
        Hg = hessian(lp, hb, "gu")
        for s in ("gate", "up"):
            lp, fb, layer_qps[s] = quantize_site(lp, s, Hg)
            _track(report, f"L{li}.{s}", fb)
        del Hg
        # down: on the post-Hadamard input; under the RMS split col0 stays
        # float and the Hessian covers rows 1..
        dspec = specs.get("llm.down")
        split = dspec is not None and dspec.split and "w_col0" in lp["down"]
        lp, fb, layer_qps["down"] = quantize_site(
            lp, "down", hessian(lp, hb, "down", drop_col0=split))
        _track(report, f"L{li}.down", fb)
        if li < nL - 1:
            hb = [stage_fns["next"](lp, h, cos, sin, mask)
                  for h, (cos, sin, mask) in zip(hb, pre)]
        report["qparams"].append(layer_qps)
        for s, qps in layer_qps.items():
            if qps is None:
                continue
            if li == 0:
                out_w[s] = torch.empty_like(params["layers"][s]["w"])
            out_w[s][li].copy_(lp[s]["w"])

    qps_stacked = {}
    for name in report["qparams"][0]:
        entries = [lq[name] for lq in report["qparams"]]
        if entries[0] is None:
            qps_stacked[name] = None
            continue
        qps_stacked[name] = tuple(
            None if entries[0][i] is None
            else torch.stack([e[i] for e in entries]) for i in range(3))
    report["qparams"] = qps_stacked
    report["seconds"] = seconds
    layers = dict(params["layers"])
    for s, w in out_w.items():
        layers[s] = {**layers[s], "w": w}
    return {**params, "layers": layers}, report
