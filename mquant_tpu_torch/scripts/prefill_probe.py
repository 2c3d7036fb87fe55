"""Per-segment breakdown of one W4A8 prefill layer at Qwen2-VL-7B widths
(port of ``scripts/prefill_probe.py``): where the time of a T-token prefill
layer goes, and each fused kernel beside the chain it replaces.

Every segment is one step h → h′ of h's shape. ``--chain`` steps, each
feeding the next, are captured in one CUDA graph and replayed between CUDA
events (median of replays); each line gives device ms per step beside the
card's name and power limit. Weights are seeded random int8 with a
per-channel scale of 2e-4 and a static activation scale of 0.05, as in the
JAX probe. Then each fused segment is held against its unfused twin on the
same input (:func:`check_twins`).

    python -m mquant_tpu_torch.scripts.prefill_probe [--T 1024] [--chain 16]
        [--device cuda]

With ``--device cpu`` every segment runs ``--chain`` steps through the
kernels' plain versions, untimed (a CPU time is no device number).

Differences from the JAX probe: the int8 products go through the port's
``qmm.int8_gemm`` (the GEMM it serves with); ``attn flash`` calls
``flash_attn`` directly (the JAX probe lowers ``MQUANT_FLASH_MIN_T``; the
port has no such knob); the fused q|k|v and gate|up matrices are the
concatenations of the separate ones, so that fused and separate segments
compute the same function, and the fused q|k|v segment returns what the
separate one does (JAX's returns q alone); the tail's fully fused line runs
(JAX defines ``seg_tail_fullfused`` but never calls it); a ``hadamard fwht
kernel`` line times ``fwht_two_matmul`` beside ``online_hadamard``; the
``HQ_TILE`` knob is gone (the kernel has one tile); and ``full layer``
runs one ``random_init`` layer through ``llm._layer_step`` (JAX's
``seg_full_layer_real`` refers to names that its script never defines).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from .. import random_init as R
from ..core.formats import INT8
from ..core.quant import QuantParams, quantize
from ..kernels import flash_attn, fwht, qmm
from ..models import layers as L
from ..models import llm
from ..serve.generate import prepare_w4_resident

SCALE, W_SCALE = 0.05, 2e-4


@dataclasses.dataclass(frozen=True)
class ProbeConfig:
    """Widths of the probed layer (Qwen2-VL-7B by default); ``hidden`` must
    equal ``heads · head_dim`` (the attention segments map h onto heads)."""

    T: int = 1024
    hidden: int = 3584
    inter: int = 18944
    heads: int = 28
    kv_heads: int = 4
    head_dim: int = 128

    def width(self, kind: str) -> int:
        return {"hidden": self.hidden, "inter": self.inter,
                "attn": self.heads * self.head_dim}[kind]


class Probe:
    """The probe's weights and tables on one device, and its segments (each
    ``h (1, T, width) → same shape``)."""

    def __init__(self, cfg: ProbeConfig, device="cuda", seed: int = 0):
        if cfg.hidden != cfg.heads * cfg.head_dim:
            raise ValueError(f"hidden {cfg.hidden} != heads · head_dim "
                             f"{cfg.heads * cfg.head_dim}")
        self.cfg = c = cfg
        self.dev = dev = torch.device(device)
        self.gen = g = torch.Generator(device=dev).manual_seed(seed)

        def mk(i, o):
            return {"w_q": torch.randint(-127, 128, (i, o), generator=g,
                                         device=dev, dtype=torch.int8),
                    "w_scale": torch.full((o,), W_SCALE, device=dev)}

        qd, kvd = c.heads * c.head_dim, c.kv_heads * c.head_dim
        w = {"q": mk(c.hidden, qd), "k": mk(c.hidden, kvd),
             "v": mk(c.hidden, kvd), "g": mk(c.hidden, c.inter),
             "u": mk(c.hidden, c.inter), "d": mk(c.inter, c.hidden)}
        for name, parts in (("qkv", "qkv"), ("gu", "gu")):
            w[name] = {k: torch.cat([w[p][k] for p in parts], dim=-1)
                       for k in ("w_q", "w_scale")}
        self.w = w
        self.scale = torch.tensor(SCALE, device=dev)
        self.qp = QuantParams(self.scale)
        self.xs = torch.full((c.T,), SCALE, device=dev)  # s8mm's x scale
        self.ln = torch.ones((c.hidden,), dtype=torch.bfloat16, device=dev)
        self.dcfg = llm.DecoderConfig(
            vocab=16, hidden=c.hidden, n_layers=1, n_heads=c.heads,
            n_kv_heads=c.kv_heads, intermediate=c.inter)
        pos = torch.arange(c.T, device=dev)[None]
        self.cos, self.sin = llm.rope_tables(self.dcfg, pos, torch.float32)
        self.mask = L.causal_mask(c.T, c.T, device=dev)
        # one W4A8 layer as the serving path holds it (block Hadamard)
        params, state = R.init_w4a8(self.dcfg, g, dev)
        self.specs = R.llm_specs()
        layers = prepare_w4_resident(self.dcfg, params, self.specs,
                                     "real")["layers"]
        self.lp = llm.layer_views(layers, 0)
        self.lstate = llm.layer_views(
            {k: v for k, v in state.items()
             if k in {"llm." + s for s in llm.LLM_SITES}}, 0)

    # -- helpers -------------------------------------------------------------

    def input(self, kind: str) -> torch.Tensor:
        """Seeded N(0, 1) bf16 input (1, T, width)."""
        return torch.randn((1, self.cfg.T, self.cfg.width(kind)),
                           generator=self.gen, device=self.dev
                           ).to(torch.bfloat16)

    def quant(self, x):
        return quantize(x, self.qp, INT8)

    def s8mm(self, xq, w, out_dt=torch.bfloat16):
        """int8 x (…, K) · int8 W → (acc · 0.05) · w_scale, by the port's int8
        GEMM."""
        x2 = xq.reshape(-1, xq.shape[-1])
        y = qmm.KERNELS["int8_gemm"](x2, self.xs[:x2.shape[0]], w["w_q"],
                                     w["w_scale"], out_dt)
        return y.reshape(*xq.shape[:-1], y.shape[-1])

    def _down(self, q8):
        """down GEMM of the tail's codes, zero-padded back to the input's
        width."""
        return F.pad(self.s8mm(q8, self.w["d"]),
                     (0, self.cfg.inter - self.cfg.hidden))

    def _qkv(self, q, k, v):
        pad = (0, (self.cfg.heads - self.cfg.kv_heads) * self.cfg.head_dim)
        return q + F.pad(k, pad) + F.pad(v, pad)

    def _heads(self, h):
        c = self.cfg
        B, T = h.shape[:2]
        q = h.reshape(B, T, c.heads, c.head_dim)
        kv = h[..., :c.kv_heads * c.head_dim].reshape(B, T, c.kv_heads,
                                                      c.head_dim)
        q, k = L.apply_rope(q, kv, self.cos, self.sin)
        return q, k, kv

    # -- the tail's int8 codes, three ways ---------------------------------

    def codes_unfused(self, h):
        """swiglu → online Hadamard (bf16 between and after the products) →
        quantize: the serving path's unfused chain."""
        return self.quant(fwht.online_hadamard(L.swiglu(h, h * 0.5)))

    def codes_had_quant(self, h):
        return fwht.KERNELS["had_quant"](L.swiglu(h, h * 0.5), self.scale)

    def codes_fullfused(self, h):
        return fwht.KERNELS["fused_swiglu_had_quant"](h, h * 0.5, self.scale)

    # -- segments ------------------------------------------------------------

    def identity(self, h):
        return h + 1.0

    def tail_unfused(self, h):
        return self._down(self.codes_unfused(h))

    def tail_had_quant(self, h):
        return self._down(self.codes_had_quant(h))

    def tail_fullfused(self, h):
        return self._down(self.codes_fullfused(h))

    def norm_quant_unfused(self, h):
        return self.quant(L.rms_norm(h, self.ln)).to(torch.bfloat16)

    def norm_quant_fused(self, h):
        return fwht.KERNELS["rms_norm_quant"](h, self.ln, self.scale).to(
            torch.bfloat16)

    def quantize(self, h):
        return self.quant(h).to(torch.bfloat16)

    def rmsnorm(self, h):
        return L.rms_norm(h, self.ln)

    def hadamard(self, h):
        return fwht.online_hadamard(h)

    def hadamard_fwht(self, h):
        return fwht.KERNELS["fwht_two_matmul"](h)

    def qkv_separate(self, h):
        xq = self.quant(h)
        return self._qkv(*(self.s8mm(xq, self.w[n]) for n in "qkv"))

    def qkv_fused(self, h):
        c = self.cfg
        qkv = self.s8mm(self.quant(h), self.w["qkv"])
        kvd = c.kv_heads * c.head_dim
        return self._qkv(*qkv.split([c.heads * c.head_dim, kvd, kvd], -1))

    def mlp_separate(self, h):
        xq = self.quant(h)
        a = L.swiglu(self.s8mm(xq, self.w["g"]), self.s8mm(xq, self.w["u"]))
        return self.s8mm(self.quant(a), self.w["d"])

    def mlp_fused(self, h):
        gu = self.s8mm(self.quant(h), self.w["gu"])
        a = L.swiglu(gu[..., :self.cfg.inter], gu[..., self.cfg.inter:])
        return self.s8mm(self.quant(a), self.w["d"])

    def attn_einsum(self, h):
        q, k, v = self._heads(h)
        return L.attention(q, k, v, self.mask).reshape(h.shape)

    def attn_flash(self, h):
        q, k, v = self._heads(h)
        out = flash_attn.KERNELS["flash_attn_causal"](
            q.contiguous(), k.contiguous(), v.contiguous(),
            self.cfg.head_dim**-0.5)
        return out.reshape(h.shape)

    def full_layer(self, h):
        return llm._layer_step(self.dcfg, self.specs, "real", h, self.lp,
                               self.lstate, None, 0, self.cos, self.sin,
                               False)


# (label, Probe method, input width); {H} / {I}: the hidden / intermediate
# widths; "pallas" in the JAX labels is "kernel" here
SEGMENTS = (
    ("identity (fixed overhead)", "identity", "hidden"),
    ("tail unfused (sw+had+q+down)", "tail_unfused", "inter"),
    ("tail had_quant kernel", "tail_had_quant", "inter"),
    ("tail fullfused kernel", "tail_fullfused", "inter"),
    ("norm+quant unfused", "norm_quant_unfused", "hidden"),
    ("norm+quant fused kernel", "norm_quant_fused", "hidden"),
    ("quantize (T,{H})", "quantize", "hidden"),
    ("rmsnorm (T,{H})", "rmsnorm", "hidden"),
    ("hadamard (T,{I})", "hadamard", "inter"),
    ("hadamard fwht kernel (T,{I})", "hadamard_fwht", "inter"),
    ("qkv separate (s8)", "qkv_separate", "hidden"),
    ("qkv fused    (s8)", "qkv_fused", "hidden"),
    ("mlp separate (s8)", "mlp_separate", "hidden"),
    ("mlp fused gu (s8)", "mlp_fused", "hidden"),
    ("attn core einsum (bf16)", "attn_einsum", "attn"),
    ("attn core flash  (bf16)", "attn_flash", "attn"),
    ("full layer (real, block Hadamard)", "full_layer", "hidden"),
)

# the kernels the segments launch on the card
KERNELS = ("rms_norm_quant", "had_quant", "fwht_two_matmul",
           "fused_swiglu_had_quant", "int8_gemm", "flash_attn_causal")

# fused tail codes against the unfused chain's: ±1, under the fraction of
# tests/test_kernels.py::TestFusedTail (the chain rounds to bf16 where the
# kernels keep f32); the fused norm+quant against quantize(rms_norm) rounds y
# to bf16 first (ROADMAP C-w7), the same kind of difference
CODES_MAX_FRAC = 0.08
TWIN_RTOL = 1e-2  # float twins: max |Δ| ≤ TWIN_RTOL · max |twin|


def label(cfg: ProbeConfig, text: str) -> str:
    return text.format(H=cfg.hidden, I=cfg.inter)


def run(probe: Probe, chain: int, timed: bool,
        log: Callable[[str], None] = print) -> Dict[str, Optional[float]]:
    """Every segment: ``chain`` steps timed as one CUDA graph (``timed``,
    on the card) or run eagerly (untimed), then one eager step from the
    same input whose output must keep the input's shape and stay finite.
    Returns {label: device ms per step, or None when untimed}."""
    from .timing import cuda_ms

    out: Dict[str, Optional[float]] = {}
    for text, meth, kind in SEGMENTS:
        step = getattr(probe, meth)
        h0 = probe.input(kind)
        state = [h0]

        def chained(_i, step=step, state=state):
            state[0] = step(state[0]).to(h0.dtype)

        ms = None
        if timed:
            ms = cuda_ms(chained, chain)
        else:
            for i in range(chain):
                chained(i)
        y = step(h0)
        if y.shape != h0.shape or not bool(torch.isfinite(y.float()).all()):
            raise AssertionError(f"{text}: output {tuple(y.shape)} for input "
                                 f"{tuple(h0.shape)}, or not finite")
        name = label(probe.cfg, text)
        out[name] = ms
        log(f"{name:34s}: " + ("not timed (CPU)" if ms is None
                               else f"{ms:.4f} ms"))
    return out


def _codes(a, b, what: str) -> str:
    d = (a.int() - b.int()).abs()
    worst, frac = int(d.max()), float((d > 0).float().mean())
    if a.shape != b.shape or worst > 1 or frac > CODES_MAX_FRAC:
        raise AssertionError(f"{what}: codes differ by up to {worst} in a "
                             f"fraction {frac}")
    return f"codes within {worst}, {frac:.6f} of them differ"


def _close(a, b, what: str) -> str:
    a, b = a.float(), b.float()
    err, mag = float((a - b).abs().max()), float(b.abs().max())
    if a.shape != b.shape or not bool(torch.isfinite(a).all()) or \
            err > TWIN_RTOL * mag:
        raise AssertionError(f"{what}: max |d| {err} against max |twin| {mag}")
    return f"max |d| {err:.4g} of max |twin| {mag:.4g}"


def _equal(a, b, what: str) -> str:
    if not torch.equal(a, b):
        raise AssertionError(f"{what}: outputs differ")
    return "equal"


# (fused, twin, input width, Probe methods compared, comparison); the tails
# are compared in code space, before the down GEMM
TWINS = (
    ("tail had_quant kernel", "tail unfused", "inter", "codes_had_quant",
     "codes_unfused", _codes),
    ("tail fullfused kernel", "tail unfused", "inter", "codes_fullfused",
     "codes_unfused", _codes),
    ("norm+quant fused kernel", "norm+quant unfused", "hidden",
     "norm_quant_fused", "norm_quant_unfused", _codes),
    ("hadamard fwht kernel", "hadamard", "inter", "hadamard_fwht",
     "hadamard", _close),
    ("qkv fused", "qkv separate", "hidden", "qkv_fused", "qkv_separate",
     _equal),
    ("mlp fused gu", "mlp separate", "hidden", "mlp_fused", "mlp_separate",
     _equal),
    ("attn core flash", "attn core einsum", "attn", "attn_flash",
     "attn_einsum", _close),
)


def check_twins(probe: Probe, log: Callable[[str], None] = print):
    """Each fused segment against its unfused twin on one seeded input:
    q|k|v and gate|up equal, flash and the f32 Hadamard within TWIN_RTOL,
    int8 codes within ±1 and CODES_MAX_FRAC. Raises on a failure."""
    for fused, twin, kind, a, b, cmp in TWINS:
        h = probe.input(kind)
        what = f"{fused} vs {twin}"
        got = cmp(getattr(probe, a)(h), getattr(probe, b)(h), what)
        log(f"twin {what}: {got}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--T", type=int, default=ProbeConfig.T)
    ap.add_argument("--chain", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    timed = torch.device(args.device).type == "cuda"
    if timed:
        from .timing import card_line

        print(card_line(), flush=True)
    probe = Probe(ProbeConfig(T=args.T), args.device)
    print(f"T={args.T} chain={args.chain} device={args.device}", flush=True)
    with torch.no_grad():
        run(probe, args.chain, timed,
            log=lambda s: print(s, flush=True))
        check_twins(probe, log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
