"""The 7B MLP block (gate, up, swiglu, down, with the online Hadamard and
the int8 quantizers) at prefill, T = 1024 tokens of (1, T, 3584), across
arithmetic variants (port of ``scripts/mlp_variants.py``): bf16, int8 (s8
products through ``qmm.int8_gemm`` with int32 output) and fp8 (e4m3 casts of
the int8 codes through ``torch._scaled_mm`` with unit scales), at the
intermediate width 18944 and padded to 19968, without and with the online
Hadamard (hadK₁₄₈ ⊗ H₁₂₈, or hadK₁₅₆ ⊗ H₁₂₈ at 19968). With ``--proto`` the
two epilogue prototypes follow: the bf16 elementwise epilogue, and the fused
epilogue through the port's kernel ``fwht.dequant_swiglu_had_quant``
(int32 g, u → scales → silu·u → Hadamard → int8 in [−127, 127], one pass),
the counterpart of ``mlp_int8_fused_epilogue``'s Pallas kernel.

``--chain`` steps h → mlp(h) are captured in one CUDA graph and replayed
between CUDA events (median of replays); each line prints device ms per MLP
beside the card's name and power limit. Weights are seeded random as in the
JAX script (bf16 normal × 0.02; int8 in [−127, 127] with a per-channel scale
of 0.01; activation scale 0.05). The unfused quantizer divides by 0.05, the
fused kernel multiplies by 1 / 0.05 = 20.0 in f32, as the two JAX versions
do (they can differ at rounding ties). The JAX probe's Pallas row tile
(``TT``) has no counterpart: the kernel takes one token row per block.

    python -m mquant_tpu_torch.scripts.mlp_variants [--T 1024] [--chain 96]
        [--proto] [--device cuda]

With ``--device cpu`` every line runs its chain eagerly through the
kernels' plain versions (fp8 as an f32 product of the e4m3 values), untimed.
With ``--proto``, :func:`check_fused` then holds the fused MLP against the
unfused one on one input.
"""

from __future__ import annotations

import argparse
import functools
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..kernels import fwht, qmm

T, HD = 1024, 3584
CHAIN = 96
SCALE = 0.05  # static activation scale
W_SCALE = 0.01  # per-channel weight scale
FP8 = torch.float8_e4m3fn


def mk_bf16(I: int, hidden: int, g: torch.Generator, device):
    def w(i, o):
        return (torch.randn((i, o), generator=g, device=device) * 0.02).to(
            torch.bfloat16)

    return {"g": w(hidden, I), "u": w(hidden, I), "d": w(I, hidden)}


def mk_int8(I: int, hidden: int, g: torch.Generator, device):
    def q(i, o):
        return (torch.randint(-127, 128, (i, o), generator=g, device=device,
                              dtype=torch.int8),
                torch.full((o,), W_SCALE, device=device))

    (wg, gs), (wu, us), (wd, ds) = q(hidden, I), q(hidden, I), q(I, hidden)
    return {"g": wg, "gs": gs, "u": wu, "us": us, "d": wd, "ds": ds}


def mk_fp8(ws8: Dict[str, torch.Tensor]):
    """The int8 weights cast to e4m3 (as the JAX script does), stored column
    major, the layout ``torch._scaled_mm`` takes for its second operand."""
    return {k: (v.float().to(FP8).t().contiguous().t()
                if v.dtype == torch.int8 else v) for k, v in ws8.items()}


def _q8(x, s=SCALE):
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)


def _s8(xq, w):
    """int8 xq (…, K) · w (K, N) → int32, by the port's int8 GEMM (its raw
    sums)."""
    x2 = xq.reshape(-1, xq.shape[-1])
    y = qmm.KERNELS["int8_gemm"](
        x2, torch.ones((x2.shape[0],), device=xq.device), w,
        torch.ones((w.shape[1],), device=w.device), torch.int32)
    return y.reshape(*xq.shape[:-1], w.shape[1])


def _f8(xq8, w8):
    """f32 xq8 (…, K) · w8 (K, N), both e4m3: ``torch._scaled_mm`` with unit
    scales on the card, the f32 product of the e4m3 values on the CPU."""
    x2 = xq8.reshape(-1, xq8.shape[-1])
    if x2.device.type == "cpu":
        y = x2.float() @ w8.float()
    else:
        one = torch.ones((), device=x2.device)
        y = torch._scaled_mm(x2, w8, scale_a=one, scale_b=one,
                             out_dtype=torch.float32)
    return y.reshape(*xq8.shape[:-1], w8.shape[1])


def mlp_bf16(h, ws):
    g = h @ ws["g"]
    u = h @ ws["u"]
    return (F.silu(g) * u) @ ws["d"]


def mlp_int8(h, ws, had=True):
    xq = _q8(h)
    gf = _s8(xq, ws["g"]).float() * (SCALE * ws["gs"])
    uf = _s8(xq, ws["u"]).float() * (SCALE * ws["us"])
    a = (F.silu(gf) * uf).to(torch.bfloat16)
    if had:
        a = fwht.online_hadamard(a)
    return _s8(_q8(a), ws["d"]).float() * (SCALE * ws["ds"])


def mlp_fp8(h, ws, had=True):
    xq = _q8(h).float().to(FP8)
    gf = _f8(xq, ws["g"]) * (SCALE * ws["gs"])
    uf = _f8(xq, ws["u"]) * (SCALE * ws["us"])
    a = (F.silu(gf) * uf).to(torch.bfloat16)
    if had:
        a = fwht.online_hadamard(a)
    return _f8(_q8(a).float().to(FP8), ws["d"]) * (SCALE * ws["ds"])


def mlp_int8_bf16ew(h, ws):
    """int8 products, bf16 elementwise epilogue (dequant, silu, mul in bf16),
    online Hadamard."""
    xq = _q8(h)
    gf = _s8(xq, ws["g"]).to(torch.bfloat16) * (SCALE * ws["gs"]).to(
        torch.bfloat16)
    uf = _s8(xq, ws["u"]).to(torch.bfloat16) * (SCALE * ws["us"]).to(
        torch.bfloat16)
    a = fwht.online_hadamard(F.silu(gf) * uf)
    return _s8(_q8(a), ws["d"]).float() * (SCALE * ws["ds"])


def mlp_int8_fused_epilogue(h, ws):
    """int8 products and one fused pass from the int32 gate / up sums to the
    int8 codes of ``down``'s input (``dequant_swiglu_had_quant``, codes in
    [−127, 127])."""
    xq = _q8(h)
    aq = fwht.KERNELS["dequant_swiglu_had_quant"](
        _s8(xq, ws["g"]), _s8(xq, ws["u"]), SCALE * ws["gs"],
        SCALE * ws["us"], SCALE, qmin=-127, qmax=127)
    return _s8(aq, ws["d"]).float() * (SCALE * ws["ds"])


# (label, mlp, weight kind, intermediate width)
LINES = (
    ("bf16  I=18944        ", mlp_bf16, "bf16", 18944),
    ("bf16  I=19968 (pad)  ", mlp_bf16, "bf16", 19968),
    ("int8  I=18944 nohad  ", functools.partial(mlp_int8, had=False), "int8",
     18944),
    ("int8  I=18944 +had148", mlp_int8, "int8", 18944),
    ("int8  I=19968 +had156", mlp_int8, "int8", 19968),
    ("fp8   I=18944 nohad  ", functools.partial(mlp_fp8, had=False), "fp8",
     18944),
    ("fp8   I=18944 +had148", mlp_fp8, "fp8", 18944),
    ("fp8   I=19968 +had156", mlp_fp8, "fp8", 19968),
)
PROTO_LINES = (
    ("int8 bf16-elementwise+had148", mlp_int8_bf16ew, "int8", 18944),
    ("int8 fused epilogue kernel  ", mlp_int8_fused_epilogue, "int8", 18944),
)


class Weights:
    """Seeded weights by (kind, intermediate width), made at first use; the
    fp8 set is the int8 set's cast."""

    def __init__(self, hidden: int = HD, device="cuda", seed: int = 0):
        self.hidden, self.dev = hidden, torch.device(device)
        self.gen = torch.Generator(device=self.dev).manual_seed(seed)
        self.sets: Dict[tuple, dict] = {}

    def get(self, kind: str, I: int) -> dict:
        if (kind, I) not in self.sets:
            if kind == "bf16":
                ws = mk_bf16(I, self.hidden, self.gen, self.dev)
            elif kind == "int8":
                ws = mk_int8(I, self.hidden, self.gen, self.dev)
            else:
                ws = mk_fp8(self.get("int8", I))
            self.sets[(kind, I)] = ws
        return self.sets[(kind, I)]


def run(weights: Weights, t: int = T, chain: int = CHAIN, proto: bool = False,
        timed: bool = True, log: Callable[[str], None] = print
        ) -> Dict[str, Optional[float]]:
    """Every line (and with ``proto`` the prototypes): ``chain`` steps
    h → mlp(h) in bf16 from a seeded N(0, 1) h (1, t, hidden), timed as one
    CUDA graph or run eagerly (``timed=False``), then one step from the
    seeded h, whose output must keep h's shape and stay finite (the bf16
    chain itself overflows after a few steps, as the JAX one does: the MLP
    squares the scale of h). Returns {label: device ms per MLP, or None when
    untimed}."""
    from .timing import cuda_ms

    log(f"T={t} chain={chain}")
    out: Dict[str, Optional[float]] = {}
    for label, mlp, kind, I in LINES + (PROTO_LINES if proto else ()):
        ws = weights.get(kind, I)
        h0 = torch.randn((1, t, weights.hidden), generator=weights.gen,
                         device=weights.dev).to(torch.bfloat16)
        state = [h0]

        def chained(_i, mlp=mlp, ws=ws, state=state):
            state[0] = mlp(state[0], ws).to(torch.bfloat16)

        ms = cuda_ms(chained, chain) if timed else None
        if not timed:
            for i in range(chain):
                chained(i)
        y = mlp(h0, ws)
        if y.shape != h0.shape or not bool(torch.isfinite(y.float()).all()):
            raise AssertionError(f"{label}: output {tuple(y.shape)} for "
                                 f"{tuple(h0.shape)}, or not finite")
        out[label] = ms
        log(f"{label}: " + ("not timed (CPU)" if ms is None
                            else f"{ms:.3f} ms/mlp"))
    return out


TWIN_RTOL = 1e-2  # max |Δ| ≤ TWIN_RTOL · max |twin|


def check_fused(weights: Weights, t: int = T,
                log: Callable[[str], None] = print):
    """The fused epilogue's MLP against the unfused int8 +had148 MLP on one
    seeded h: within TWIN_RTOL of the largest magnitude (the unfused chain
    rounds the Hadamard's output to bf16 and divides by 0.05, so some codes
    land one step apart). Raises otherwise."""
    ws = weights.get("int8", 18944)
    h = torch.randn((1, t, weights.hidden), generator=weights.gen,
                    device=weights.dev).to(torch.bfloat16)
    got, twin = mlp_int8_fused_epilogue(h, ws), mlp_int8(h, ws)
    err, mag = float((got - twin).abs().max()), float(twin.abs().max())
    if got.shape != twin.shape or not err <= TWIN_RTOL * mag:
        raise AssertionError(f"fused epilogue vs int8 +had148: max |d| {err} "
                             f"of max |twin| {mag}")
    log(f"twin fused epilogue vs int8 +had148: max |d| {err:.4g} of max "
        f"|twin| {mag:.4g}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--T", type=int, default=T)
    ap.add_argument("--chain", type=int, default=CHAIN)
    ap.add_argument("--proto", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    timed = torch.device(args.device).type == "cuda"
    if timed:
        from .timing import card_line

        print(card_line(), flush=True)
    weights = Weights(device=args.device)
    with torch.no_grad():
        run(weights, args.T, args.chain, args.proto, timed,
            log=lambda s: print(s, flush=True))
        if args.proto:
            check_fused(weights, args.T, log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
