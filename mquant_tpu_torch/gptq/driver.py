"""GPTQ drivers for the stacked decoder and the vision tower,
stage-sequential (counterpart of ``mquant_tpu/gptq/driver.py``).

Layers go in order; within a layer the site groups go in dependency order
([q, k, v] → [o] → [gate, up] → [down] in the decoder, [q, k, v] → [o] →
[fc1] → [fc2] in a ViT block), each group's Hessian taken on its inputs
re-derived with the groups before it already quantized; then the
quantized layer produces the next layer's inputs. The caller hands in the
first layer's inputs (the decoder's embeddings with the vision splice, the
ViT's patch-embed output). Activations stay in floating point (the
activation quantizers are stripped), while the online Hadamard and the RMS
split are on, so ``down``'s (``fc2``'s) Hessian sees its serving-time
input.

The decoder's weights either stay on the device, the quantized ones going
into new stacked tensors a layer at a time, or (``stream_from_host``) live
in host memory and go to the device a layer at a time; with
``realize_on_device`` each finished layer becomes integer serving storage
that stays on the device. That is how a decoder larger than the card (72B:
~145 GB in bf16) is GPTQ'd on one 80 GB card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from ..models import layers as L
from ..models.layers import SiteSpec, qlinear
from ..models.llm import DecoderConfig, _apply_rope, layer_views, rope_tables
from ..models.vision import VIT_SITES
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
        q, k = _apply_rope(cfg, q.reshape(B, T, H, hd),
                           k.reshape(B, T, KV, hd), cos, sin)
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


def _layer_to(tree, li: int, dev):
    """Layer ``li`` of a host-stacked tree, copied to ``dev``."""
    if isinstance(tree, dict):
        return {k: _layer_to(v, li, dev) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree[li].to(dev, non_blocking=True)
    return tree


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def _realize_layer(lp: Dict, specs: Dict[str, SiteSpec], layer_qps: Dict
                   ) -> Dict:
    """One finished layer → integer storage (one int8 code a byte, the
    GPTQ grid passed through so the codes are the walk's; act_order ×
    group_size rows stored permuted with ``a_perm``), other leaves kept."""
    from ..kernels.qmm import quantize_weights_real

    store = {}
    for name, site in lp.items():
        spec = specs.get("llm." + name)
        if (isinstance(site, dict) and "w" in site and spec is not None
                and spec.w_bits is not None):
            s = {k: v for k, v in site.items() if k != "w"}
            scale, zero, perm = layer_qps.get(name) or (None, None, None)
            w = site["w"]
            if perm is not None:
                w = w[perm]
                s["a_perm"] = perm.to(torch.int32)
            s.update(quantize_weights_real(w, spec.w_bits, pack=False,
                                           scale=scale, zero=zero))
            store[name] = s
        else:
            store[name] = site
    return store


def _stack_sites(layers: List[Dict]) -> Dict:
    """Per-layer trees → stacked, site by site, dropping each site's
    per-layer tensors as it goes (the footprint never doubles)."""

    def stack(vals):
        if isinstance(vals[0], dict):
            return {k: stack([v[k] for v in vals]) for k in vals[0]}
        if vals[0] is None or not isinstance(vals[0], torch.Tensor):
            return vals[0]
        return torch.stack(vals)

    stacked = {}
    for name in list(layers[0]):
        stacked[name] = stack([nl.pop(name) for nl in layers])
    return stacked


def gptq_quantize_decoder(cfg: DecoderConfig, params: Dict,
                          hidden_batches: List[torch.Tensor],
                          specs: Dict[str, SiteSpec],
                          gcfg: GPTQConfig = GPTQConfig(),
                          progress=None, stream_from_host: bool = False,
                          realize_on_device: bool = False) -> tuple:
    """GPTQ every spec'd decoder weight. ``hidden_batches``: the
    decoder-input embeddings (B, T, hidden) per batch, at arange RoPE
    positions (as the JAX pipeline calls its driver; ROADMAP C-w16).
    Returns (params, report): report["fallbacks"] names the
    sites whose factorization failed (RTN taken), report["sites"] counts
    the GPTQ'd sites, report["qparams"] = {site: (scale (L, G, out), zero
    (L, G, out) or None, perm (L, in) or None)}, the exact grids of the
    fake-quantized weights (perm only under act_order × group_size), and
    report["seconds"] the device seconds of the Hessians' stage replays
    ("hessian"), the factorizations ("factor") and the walks ("walk").

    ``stream_from_host``: ``params["layers"]`` lives in host memory
    (pinned, for fast copies); each layer goes to the embeddings' device while it
    is quantized and comes back; the returned layers are host-stacked.
    With ``realize_on_device`` too, each finished layer becomes integer
    storage (:func:`_realize_layer`) that stays on the device: the
    returned layers are the device's serving storage, no weight comes
    back. ``progress(l, L)`` is called after each layer.

    This is a library API: ``run_pipeline`` loads the whole model onto the
    device and GPTQs it resident; a caller with a decoder larger than the
    device (Qwen2-VL-72B on one 80 GB card) keeps its layers on the host
    and calls this function itself."""
    if realize_on_device and not stream_from_host:
        raise ValueError("realize_on_device needs stream_from_host")
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
    new_layers: List[Dict] = []
    for li in range(nL):
        lp = (_layer_to(params["layers"], li, dev) if stream_from_host
              else layer_views(params["layers"], li))
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
        if stream_from_host and realize_on_device:
            new_layers.append(_realize_layer(lp, specs, layer_qps))
        elif stream_from_host:  # back to the host; the device copy goes
            new_layers.append(_to_host(lp))
        else:
            for s, qps in layer_qps.items():
                if qps is None:
                    continue
                if li == 0:
                    out_w[s] = torch.empty_like(params["layers"][s]["w"])
                out_w[s][li].copy_(lp[s]["w"])
        del lp
        if progress:
            progress(li, nL)

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
    if stream_from_host:
        return {**params, "layers": _stack_sites(new_layers)}, report
    layers = dict(params["layers"])
    for s, w in out_w.items():
        layers[s] = {**layers[s], "w": w}
    return {**params, "layers": layers}, report


# ---------------------------------------------------------------------------
# the vision tower
# ---------------------------------------------------------------------------

VIT_STAGES = ("qkv", "o", "fc1", "fc2", "next")


def make_vit_stage_fn(cfg, specs: Dict[str, SiteSpec], stage: str,
                      prefix: str = "vis"):
    """One ViT block replayed up to ``stage``'s input: "qkv" the post-ln1
    input, "o" the attention output, "fc1" the post-ln2 input, "fc2" the
    activated fc1 output after fc2's online Hadamard, "next" the block's
    output."""
    from ..models.vision import _act, _norm

    specs = _strip_act_quant(specs)

    def site(nm):
        return specs.get(f"{prefix}.{nm}")

    def f(bp, h, cos, sin):
        B, T, _ = h.shape
        hd, H = cfg.head_dim, cfg.n_heads
        x1 = _norm(cfg, h, bp["ln1"])
        if stage == "qkv":
            return x1
        q = qlinear(x1, bp["q"], f"{prefix}.q", site("q"), None, "fake")
        k = qlinear(x1, bp["k"], f"{prefix}.k", site("k"), None, "fake")
        v = qlinear(x1, bp["v"], f"{prefix}.v", site("v"), None, "fake")
        q, k, v = (t.reshape(B, T, H, hd) for t in (q, k, v))
        if cos is not None:
            q, k = L.apply_rope(q, k, cos, sin)
        a = L.attention(q, k, v).reshape(B, T, H * hd)
        if stage == "o":
            return a
        a = qlinear(a, bp["o"], f"{prefix}.o", site("o"), None, "fake")
        if cfg.layerscale and "ls1" in bp:
            a = a * bp["ls1"]["w"].to(a.dtype)
        h2 = h + a
        x2 = _norm(cfg, h2, bp["ln2"])
        if stage == "fc1":
            return x2
        y = _act(cfg, qlinear(x2, bp["fc1"], f"{prefix}.fc1", site("fc1"),
                              None, "fake"))
        fspec = site("fc2")
        if stage == "fc2":
            if fspec is not None and fspec.online_had is not None:
                y = L._online_hadamard(y, fspec)
            return y
        y = qlinear(y, bp["fc2"], f"{prefix}.fc2", fspec, None, "fake")
        if cfg.layerscale and "ls2" in bp:
            y = y * bp["ls2"]["w"].to(y.dtype)
        return h2 + y

    return f


def gptq_quantize_vit(cfg, vit_params: Dict, feat_batches: List[torch.Tensor],
                      specs: Dict[str, SiteSpec],
                      grids: Optional[List[torch.Tensor]] = None,
                      gcfg: GPTQConfig = GPTQConfig(), prefix: str = "vis"
                      ) -> tuple:
    """GPTQ the vision tower's blocks. ``feat_batches``: the first block's
    inputs per batch (``vision.vit_preamble``'s output: the patch embed's,
    after a CLIP tower's ln_pre and ``fc_sub_mean``); ``grids`` their (B, T, 2)
    patch coordinates for a rotary tower. Returns (vit_params, report)
    with the decoder driver's "fallbacks" and "sites"."""
    from ..models.vision import rot2d_tables

    stage_fns = {s: make_vit_stage_fn(cfg, specs, s, prefix)
                 for s in VIT_STAGES}
    pre = []
    for i, h in enumerate(feat_batches):
        cos = sin = None
        if cfg.rotary_2d and grids is not None:
            cos, sin = rot2d_tables(grids[i], cfg.head_dim)
        pre.append((cos, sin))

    def quantize_site(bp, name, H):
        spec = specs.get(f"{prefix}.{name}")
        if spec is None or spec.w_bits is None:
            return bp, None
        sp = dict(bp[name])
        res = C.gptq_quantize_matrix(
            sp["w"].float(), H, bits=spec.w_bits, percdamp=gcfg.percdamp,
            act_order=gcfg.act_order, group_size=gcfg.group_size,
            mse_clip=gcfg.mse_clip, sym=gcfg.sym)
        sp["w"] = res.w.to(bp[name]["w"].dtype)
        return {**bp, name: sp}, bool(res.used_fallback)

    report = {"fallbacks": [], "sites": 0}
    hb = feat_batches
    out_w: Dict[str, torch.Tensor] = {}
    groups = (("qkv", ("q", "k", "v")), ("o", ("o",)), ("fc1", ("fc1",)),
              ("fc2", ("fc2",)))
    for li in range(cfg.n_layers):
        bp = layer_views(vit_params["blocks"], li)
        fc2_spec = specs.get(f"{prefix}.fc2")
        fc2_split = (fc2_spec is not None and fc2_spec.split
                     and "w_col0" in bp["fc2"])
        for stage, names in groups:
            Hs = None
            for h, (cos, sin) in zip(hb, pre):
                x = stage_fns[stage](bp, h, cos, sin)
                if stage == "fc2" and fc2_split:
                    x = x[..., 1:]  # the RMS split: col0 stays float
                Hs = C.accumulate_hessian(Hs, x)
            for nm in names:
                bp, fb = quantize_site(bp, nm, Hs)
                _track(report, f"{prefix}L{li}.{nm}", fb)
            del Hs
        if li < cfg.n_layers - 1:
            hb = [stage_fns["next"](bp, h, cos, sin)
                  for h, (cos, sin) in zip(hb, pre)]
        for nm in VIT_SITES:
            spec = specs.get(f"{prefix}.{nm}")
            if spec is None or spec.w_bits is None:
                continue
            if li == 0:
                out_w[nm] = torch.empty_like(vit_params["blocks"][nm]["w"])
            out_w[nm][li].copy_(bp[nm]["w"])
    blocks = dict(vit_params["blocks"])
    for nm, w in out_w.items():
        blocks[nm] = {**blocks[nm], "w": w}
    return {**vit_params, "blocks": blocks}, report
