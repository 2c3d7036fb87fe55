"""Device time of ``kernels.qmm.int8_gemv`` at the decode shapes of the
main path, on the card only: path S's `down` (K = 18943 → 3584) at 1, 8
(the engine's pool step) and 32 token rows, and the int8 lm_head
(3584 → 152064) at 1 and 8 rows; each with int32 output checked against
``int8_gemv_ref`` first, then timed in bf16 (``timing.cuda_ms``: a CUDA
graph of 20 calls cycling over weight copies beyond the 50 MB L2, median
of 5 replays) beside its byte bound at 3.35 TB/s.

It times whichever ``mquant_tpu_torch`` the interpreter imports, and uses
nothing of the package but ``int8_gemv``, ``int8_gemv_ref`` and
``scripts.timing``, so two checkouts can be compared on one card in one
session: run this file by its path with one checkout's root, then the
other's, first on ``PYTHONPATH``.

    python mquant_tpu_torch/scripts/int8_gemv_time.py [--seed 0]

Prints the card's line and one JSON line: {"card", "shapes": [{"label",
"M", "K", "N", "ms", "bound_ms"}]}.
"""

from __future__ import annotations

import argparse
import json

import torch

SHAPES = [("S down, 1 row", 1, 18943, 3584),
          ("engine S down, 8 rows", 8, 18943, 3584),
          ("S down, 32 rows", 32, 18943, 3584),
          ("lm_head, 1 row", 1, 3584, 152064),
          ("lm_head, 8 rows", 8, 3584, 152064)]
HBM_BPS = 3.35e12  # the H100 SXM's published HBM rate
L2_COLD_BYTES = 128 * 2**20


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("int8_gemv_time: needs a CUDA device")
    from mquant_tpu_torch.kernels import qmm
    from mquant_tpu_torch.scripts.timing import card_line, cuda_ms

    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    out = []
    for label, M, K, N in SHAPES:
        x = torch.randint(-127, 128, (M, K), generator=g, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (K, N), generator=g, device=dev,
                          dtype=torch.int8)
        xs = torch.rand((M,), generator=g, device=dev) * 0.1 + 1e-3
        ws = torch.rand((N,), generator=g, device=dev) * 0.01 + 1e-4
        if not torch.equal(qmm.int8_gemv(x, xs, w, ws, torch.int32),
                           qmm.int8_gemv_ref(x, xs, w, ws, torch.int32)):
            raise AssertionError(f"int8_gemv [{label}]: differs from plain")
        cold = [w] + [w.clone() for _ in range(
            min(15, -(-L2_COLD_BYTES // (K * N)) - 1))]
        ms = cuda_ms(lambda i: qmm.int8_gemv(x, xs, cold[i % len(cold)], ws,
                                             torch.bfloat16), 20)
        nbytes = K * N + M * K + 2 * M * N + 4 * (M + N)
        out.append({"label": label, "M": M, "K": K, "N": N, "ms": ms,
                    "bound_ms": nbytes / HBM_BPS * 1e3})
        print(f"int8_gemv {label:22s} M={M:3d} K={K:6d} N={N:6d}: "
              f"{ms:.4f} ms, bound {out[-1]['bound_ms']:.4f} ms", flush=True)
        del x, w, cold
        torch.cuda.empty_cache()
    line = {"card": card, "shapes": out}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
