"""Matrix-unit rate probe (port of ``scripts/mxu_rate.py``): one
(M, K) × (K, N) product, by default (1024, 3584) × (3584, 19968), timed as

  * bf16 ``torch.matmul`` (f32 sums), against the 989 TFLOP/s dense peak;
  * ``torch._int_mm``, the library's int8 × int8 → int32 GEMM;
  * ``qmm.int8_gemm(…, out_dtype=torch.int32)``, the port's hand-written
    int8 GEMM (``mq_int8_gemm``) returning its raw int32 sums — the
    counterpart of the JAX probe's tiled Pallas int8 → int32 kernel
    (``make_pallas_i8``);

the two int8 rows against the 1,979 TOP/s dense int8 peak, in ms per matmul
(``--iters`` calls captured in one CUDA graph, median of replays), and the
int8 kernel's plain version (an exact float64 product) for scale. The
int8 kernel's int32 output is checked bit-equal to ``torch._int_mm``'s on
the same operands. The JAX probe sweeps Pallas tile shapes; ``mq_int8_gemm``
has one tile, so there is nothing to sweep.

    python -m mquant_tpu_torch.scripts.mxu_rate [--M 1024] [--K 3584]
        [--N 19968] [--iters 32] [--device cuda]

With ``--device cpu`` it computes the int8 kernel's product once through its
plain version and prints its shape (no timing).
"""

from __future__ import annotations

import argparse
from typing import Dict

import torch

from ..kernels import qmm

M, K, N = 1024, 3584, 19968
PEAK = {"bf16": 989e12, "int8": 1979e12}  # H100 SXM dense, per second


def operands(m: int, k: int, n: int, device="cuda", seed: int = 0):
    """Seeded int8 x (m, k) in [−127, 127] and W (k, n), and N(0, 1) bf16
    twins of the same shapes."""
    g = torch.Generator(device=device).manual_seed(seed)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=device,
                             dtype=torch.int8)

    def bf(*shape):
        return torch.randn(shape, generator=g, device=device).to(
            torch.bfloat16)

    return i8(m, k), i8(k, n), bf(m, k), bf(k, n)


def int8_gemm_i32(x: torch.Tensor, w: torch.Tensor, plain: bool = False
                  ) -> torch.Tensor:
    """int32 x · W by the port's int8 GEMM, or by its plain version (unit
    scales; the int32 output skips the epilogue)."""
    ones_m = torch.ones((x.shape[0],), device=x.device)
    ones_n = torch.ones((w.shape[1],), device=w.device)
    fn = (qmm.PLAIN if plain else qmm.KERNELS)["int8_gemm"]
    return fn(x, ones_m, w, ones_n, torch.int32)


def run(m: int = M, k: int = K, n: int = N, iters: int = 32, seed: int = 0,
        log=print) -> Dict[str, float]:
    """On the card: {row: ms per matmul}; raises if the int8 kernel's int32
    output is not bit-equal to ``torch._int_mm``'s."""
    from .timing import cuda_ms

    x, w, xb, wb = operands(m, k, n, "cuda", seed)
    got, ref = int8_gemm_i32(x, w), torch._int_mm(x, w)
    if not torch.equal(got, ref):
        raise AssertionError(f"int8_gemm int32 differs from torch._int_mm in "
                             f"{int((got != ref).sum())} of {ref.numel()}")
    log(f"M={m} K={k} N={n} iters={iters}: int8_gemm int32 output bit-equal "
        "to torch._int_mm")
    ops = 2 * m * k * n
    # (row, peak, calls per replay, call); the plain version is slow
    rows = (("bf16 torch.matmul", "bf16", iters,
             lambda i: torch.matmul(xb, wb)),
            ("int8 torch._int_mm", "int8", iters,
             lambda i: torch._int_mm(x, w)),
            ("int8 qmm.int8_gemm int32", "int8", iters,
             lambda i: int8_gemm_i32(x, w)),
            ("int8 plain version", "int8", 4,
             lambda i: int8_gemm_i32(x, w, plain=True)))
    out = {}
    for name, kind, calls, fn in rows:
        ms = out[name] = cuda_ms(fn, calls)
        rate = ops / ms / 1e9
        unit = "TFLOP/s" if kind == "bf16" else "TOP/s"
        log(f"{name:26s}: {ms:.4f} ms/matmul ({rate:.1f} {unit}, "
            f"{rate * 1e12 / PEAK[kind]:.3f} of the {PEAK[kind] / 1e12:,.0f} "
            "dense peak)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--M", type=int, default=M)
    ap.add_argument("--K", type=int, default=K)
    ap.add_argument("--N", type=int, default=N)
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        from .timing import card_line

        print(card_line(), flush=True)
        run(args.M, args.K, args.N, args.iters,
            log=lambda s: print(s, flush=True))
        return 0
    x, w, _, _ = operands(args.M, args.K, args.N, args.device)
    y = int8_gemm_i32(x, w)
    print(f"M={args.M} K={args.K} N={args.N} on {args.device}: int8_gemm "
          f"int32 output {tuple(y.shape)} (not timed)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
