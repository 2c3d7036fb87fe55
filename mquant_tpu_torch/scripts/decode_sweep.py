"""Launch-plan sweep of the two one-launch decode kernels on the card.

* ``w4a8_gemv`` at the Qwen2-VL-7B decode shapes (q|k|v, o, gate|up, down):
  one token row (the ``__dp4a`` path) and two (the tensor-core path: one n8
  tile, the same W bytes, so it times that path at one row's cost), each at
  the wrapper's plan; then one row at forced K split counts (1 .. 8 blocks
  a cluster), each held int32 bit-equal to the plain version.
* ``attn_decode`` on a bucketed 8192-row cache (pos 1024, pos 4223, batch 4
  with per-row start) at forced column split counts, each held within
  1e-2 of the plain version's largest magnitude.

Device ms per call by CUDA-graph replay with L2-cold weights / caches, beside
the card's name and power limit. Usage (card only):
``python -m mquant_tpu_torch.scripts.decode_sweep``.
"""

from __future__ import annotations

import argparse

import torch

from ..kernels import _build
from ..kernels import attn_decode as TA
from ..kernels import qmm
from .timing import card_line, cuda_ms

GEMV_SHAPES = [("q|k|v", 3584, 4608), ("o", 3584, 3584),
               ("gate|up", 3584, 37888), ("down", 18944, 3584)]
GEMV_SPLITS = (1, 2, 4, 8)
ATTN_CASES = [("pos 1024", 1, 1024, 0), ("pos 4223", 1, 4223, 0),
              ("batch 4, per-row start", 4, 1030, [0, 37, 500, 724])]
ATTN_SPLITS = (4, 8, 16, 33, 66)
COLD_BYTES = 128 * 2**20  # beyond the 50 MB L2


def _copies(t: torch.Tensor, n_max: int) -> list:
    n = max(1, min(n_max, -(-COLD_BYTES // (t.numel() * t.element_size()))))
    return [t] + [t.clone() for _ in range(n - 1)]


def gemv(g: torch.Generator, log=print) -> None:
    lib, dev = _build.load(), torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, K, N in GEMV_SHAPES:
        R = K // 2
        w = torch.randint(-128, 128, (R, N), generator=g, device=dev,
                          dtype=torch.int8)
        ws = torch.rand(N, generator=g, device=dev)
        cold = _copies(w, 16)
        parts = []
        for M in (1, 2):
            x = torch.randint(-127, 128, (M, K), generator=g, device=dev,
                              dtype=torch.int8)
            xs = torch.rand(M, generator=g, device=dev)
            ms = cuda_ms(lambda i: qmm.w4a8_gemv(x, xs, cold[i % len(cold)],
                                                 ws), 20)
            parts.append(f"M={M} {ms:.4f} ms")
        ref = qmm.w4a8_gemv_ref(x[:1], xs[:1], w, ws, torch.int32)
        steps = -(-R // qmm.GEMV_STEP_ROWS)
        for splits in GEMV_SPLITS:
            rps = -(-steps // splits) * qmm.GEMV_STEP_ROWS
            sp = -(-R // rps)  # the plan's rule: no split is empty

            def call(i, out_kind=0, wt=None, sp=sp, rps=rps):
                out = torch.empty((1, N), dtype=torch.int32 if out_kind else
                                  torch.bfloat16, device=dev)
                wt = cold[i % len(cold)] if wt is None else wt
                status = lib.mq_w4a8_gemv(
                    x.data_ptr(), wt.data_ptr(), xs.data_ptr(), ws.data_ptr(),
                    out.data_ptr(), 1, K, N, sp, rps, out_kind,
                    torch.cuda.current_stream().cuda_stream)
                if status:
                    raise RuntimeError(f"mq_w4a8_gemv: CUDA error {status}")
                return out

            if not torch.equal(call(0, 2, w), ref):
                raise AssertionError(f"w4a8_gemv {label}, {sp} splits: "
                                     "int32 differs from the plain version")
            parts.append(f"M=1 {sp} splits {cuda_ms(call, 20):.4f} ms")
        log(f"w4a8_gemv {label} (K={K}, N={N}, plan "
            f"{qmm._gemv_plan(K, N, sms)}): " + "; ".join(parts))
        del cold


def attention(g: torch.Generator, log=print) -> None:
    lib, dev = _build.load(), torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    H, KVH, HD, S = 28, 4, 128, 8192
    scale = HD**-0.5

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    for label, B, pos, start in ATTN_CASES:
        q, kn, vn = r(B, 1, H, HD), r(B, 1, KVH, HD), r(B, 1, KVH, HD)
        kc, vc = r(B, S, KVH, HD), r(B, S, KVH, HD)
        st = (torch.tensor(start, dtype=torch.int32, device=dev)
              if isinstance(start, list) else None)
        ref, _, _ = TA.attn_decode_ref(q, kn, vn, kc.clone(), vc.clone(), pos,
                                       scale, start=start if st is None
                                       else st)
        caches = list(zip(_copies(kc, 4), _copies(vc, 4)))
        counters = TA._counters(dev, B * KVH)
        parts = []
        for splits in ATTN_SPLITS:
            out = torch.empty((B, 1, H, HD), dtype=torch.bfloat16, device=dev)

            def call(i, splits=splits, out=out):
                kc_, vc_ = caches[i % len(caches)]
                part = torch.empty(B * KVH * splits * (H // KVH) * (HD + 4),
                                   dtype=torch.float32, device=dev)
                status = lib.mq_attn_decode(
                    q.data_ptr(), kn.data_ptr(), vn.data_ptr(),
                    kc_.data_ptr(), vc_.data_ptr(), None,
                    None if st is None else st.data_ptr(), out.data_ptr(),
                    part.data_ptr(), counters.data_ptr(), pos,
                    0 if st is not None else start, B, S, H, KVH, splits,
                    scale, torch.cuda.current_stream().cuda_stream)
                if status:
                    raise RuntimeError(f"mq_attn_decode: CUDA error {status}")

            call(0)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            if err > 1e-2 * float(ref.float().abs().max()):
                raise AssertionError(f"attn_decode {label}, {splits} splits: "
                                     f"max |d| {err}")
            parts.append(f"{splits} splits {cuda_ms(call, 20):.4f} ms")
        log(f"attn_decode {label} (plan "
            f"{TA._plan(B, KVH, S if st is not None else pos - start, sms)}"
            " splits): " + "; ".join(parts))
        del caches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_sweep: needs a CUDA device")
    print(card_line(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    with torch.no_grad():
        gemv(g)
        attention(g)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
