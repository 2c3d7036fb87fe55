"""The port's decode-GEMV probe kernels against the JAX probes' Pallas
kernels (CPU; numpy inputs from fixed seeds for both packages; the JAX
kernels run unchanged under ``pltpu.force_tpu_interpret_mode()``, with the
scripts' module globals M, K, N set to the test's shape and the tiles
passed explicitly).

* ``w8_bf16_gemv_ref`` (the plain version of ``mq_w8_bf16_gemv``) against
  ``scripts/gemv_bench.py::w8_bf16_gemv_pallas``: bf16 within one ulp at
  max(|a|, |b|), plus 1e-5 of the largest magnitude (both sum exact
  products, in float64 and in f32 in another order: an output near zero
  comes out of a cancelling sum whose last f32 bits depend on the order).
* ``w4_unpack_gemv_ref`` P0-P3 against ``scripts/w4_unpack_tune.py::
  pallas_gemv`` with each kernel: int32 equal; P1-P3 equal to the served
  ``w4a8_gemv``'s int32 as well.
* A plain model of ``mq_w8_bf16_gemv``'s arithmetic (the tensor-core
  kernel): W's bytes converted to bf16 by the kernel's bit trick (exact for
  all 256 bytes), each k16 product's exact sum added to f32 accumulators in
  the kernel's order (stages alternating between two consumer groups, group
  0 + group 1, then the K splits of ``qmm._gemv_plan`` in rank order), held
  against ``w8_bf16_gemv_ref`` within chip_smoke.py's bound (one bf16 ulp
  plus 1e-5 of the largest magnitude).
* ROADMAP C-w8, the two floored grids: at a shape the tile does not divide,
  JAX leaves the last output columns unwritten (NaN under interpret) or the
  last packed rows unsummed; the port computes the whole product.
* The probes' CPU paths through their Python API at tiny sizes.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mquant_tpu_torch.kernels import qmm
from mquant_tpu_torch.scripts import gemv_bench as PG
from mquant_tpu_torch.scripts import w4_unpack_tune as PW

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import gemv_bench as JG  # noqa: E402
import w4_unpack_tune as JW  # noqa: E402


def _w8_operands(seed, M, K, N):
    rng = np.random.default_rng(seed)
    x = np.asarray(jnp.asarray(rng.normal(size=(M, K)), jnp.bfloat16))
    w = rng.integers(-127, 127, size=(K, N)).astype(np.int8)
    ws = rng.uniform(0.005, 0.02, size=(1, N)).astype(np.float32)
    return x, w, ws


def _jax_w8(monkeypatch, x, w, ws, tn):
    M, K = x.shape
    for name, v in (("M", M), ("K", K), ("N", w.shape[1])):
        monkeypatch.setattr(JG, name, v)
    with pltpu.force_tpu_interpret_mode():
        y = JG.w8_bf16_gemv_pallas(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(ws), tn=tn)
    return np.asarray(y.astype(jnp.float32))


def _port_w8(x, w, ws):
    return qmm.w8_bf16_gemv_ref(torch.from_numpy(x.astype(np.float32)).to(
        torch.bfloat16), torch.from_numpy(w), torch.from_numpy(ws[0]))


def _within_ulp(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    mag = np.maximum(np.abs(got), np.abs(ref)).clip(min=2.0**-126)
    room = np.exp2(np.floor(np.log2(mag)) - 7) + 1e-5 * np.abs(ref).max()
    assert (np.abs(got - ref) <= room).all()


@pytest.mark.parametrize("M", [1, 8])
def test_w8_bf16_gemv_plain_matches_jax_kernel(monkeypatch, M):
    x, w, ws = _w8_operands(M, M, 256, 512)
    ref = _jax_w8(monkeypatch, x, w, ws, tn=256)
    got = _port_w8(x, w, ws)
    assert got.dtype == torch.bfloat16 and got.shape == (M, 512)
    _within_ulp(got.float().numpy(), ref)
    # CPU tensors: the wrapper is the plain version, and launches nothing
    before = qmm.LAUNCHES["w8_bf16_gemv"]
    xt = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(qmm.w8_bf16_gemv(xt, torch.from_numpy(w),
                                        torch.from_numpy(ws)), got)
    assert qmm.LAUNCHES["w8_bf16_gemv"] == before


def test_w8_bf16_gemv_floored_grid(monkeypatch):
    """C-w8: N = 640 with tn = 256 is a grid of 2 tiles; JAX leaves columns
    512-639 unwritten (NaN under interpret). The port writes every column:
    the first 512 agree with JAX's, all 640 with a float64 product."""
    x, w, ws = _w8_operands(3, 8, 256, 640)
    ref = _jax_w8(monkeypatch, x, w, ws, tn=256)
    assert np.isnan(ref[:, 512:]).all() and np.isfinite(ref[:, :512]).all()
    got = _port_w8(x, w, ws).float().numpy()
    _within_ulp(got[:, :512], ref[:, :512])
    exact = (x.astype(np.float64) @ w.astype(np.float64)) * ws
    _within_ulp(got, exact.astype(np.float32))


def _bf16_of_bytes(w: np.ndarray) -> np.ndarray:
    """int8 w as the kernel converts it (bf16_frags, csrc/qmm.cu): the byte
    + 128 as the low mantissa bits of 2^23, less 2^23 + 128 in f32, then
    the f32's upper half as a bf16 (here: an f32 with the low half 0)."""
    u = (w.astype(np.int32) & 0xFF) ^ 0x80
    f = (np.uint32(0x4B000000) | u.astype(np.uint32)).view(np.float32) \
        - np.float32(8388736.0)
    return (f.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)


def test_w8_bf16_byte_conversion_is_exact():
    b = np.arange(-128, 128, dtype=np.int32).astype(np.int8)
    np.testing.assert_array_equal(_bf16_of_bytes(b), b.astype(np.float32))


def _w8_tc_model(x: torch.Tensor, w: np.ndarray, ws: torch.Tensor,
                 sms: int = 132) -> torch.Tensor:
    """The tensor-core kernel's sums: each mma.sync k16 product adds the
    exact sum of its 16 products (bf16 x times the converted byte) to an f32
    accumulator; a split's 32-row stages go to consumer groups 0 and 1 in
    turn (k16 halves in order), the groups meet as group 0 + group 1, the
    splits in rank order; then × w_scale in f32 and bf16."""
    M, K = x.shape
    N = w.shape[1]
    _, splits, rps = qmm._gemv_plan(K, N, sms, packed=False)
    kp = -(-K // 32) * 32
    xd = torch.zeros((M, kp), dtype=torch.float64)
    xd[:, :K] = x.double()
    wd = torch.zeros((kp, N), dtype=torch.float64)
    wd[:K] = torch.from_numpy(_bf16_of_bytes(w)).double()
    blocks = torch.stack([(xd[:, b:b + 16] @ wd[b:b + 16]).float()
                          for b in range(0, kp, 16)])
    total = None
    for s in range(splits):
        r0 = s * rps
        steps = -(-(min(K, r0 + rps) - r0) // 32)
        red = None
        for grp in (0, 1):
            acc = torch.zeros((M, N), dtype=torch.float32)
            for st in range(grp, steps, 2):
                for h in (0, 1):
                    acc = acc + blocks[(r0 + 32 * st) // 16 + h]
            red = acc if red is None else red + acc
        total = red if total is None else total + red
    return (total * ws.float()).to(torch.bfloat16)


# gemv_bench's widths at N = 2048 and M = 8, 1, 5; N % 16 == 8 (the
# cp.async rows); a K that is no multiple of 32 or of 4
@pytest.mark.parametrize("M,K,N", [(8, 3584, 2048), (1, 3584, 2048),
                                   (5, 3584, 2048), (8, 3584, 1032),
                                   (3, 2051, 136)])
def test_w8_bf16_tc_model_within_bound(M, K, N):
    x, w, ws = _w8_operands(K + N, M, K, N)
    xt = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    wst = torch.from_numpy(ws[0])
    model = _w8_tc_model(xt, w, wst)
    ref = qmm.w8_bf16_gemv_ref(xt, torch.from_numpy(w), wst)
    assert model.shape == ref.shape == (M, N)
    _within_ulp(model.float().numpy(), ref.float().numpy())


def _w4_operands(seed, M, K, N):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, size=(M, K)).astype(np.int8)
    packed = rng.integers(-128, 128, size=(K // 2, N)).astype(np.int8)
    return x, packed


JAX_W4_KERNELS = {0: lambda: JW.packed_dot_kernel,
                  1: lambda: JW.make_w4_kernel(JW.unpack_i32),
                  2: lambda: JW.make_w4_kernel(JW.unpack_shift8),
                  3: lambda: JW.make_w4_kernel(JW.unpack_shift32)}


def _jax_w4(monkeypatch, x, packed, variant, tn, tk):
    M, K = x.shape
    for name, v in (("M", M), ("K", K), ("N", packed.shape[1])):
        monkeypatch.setattr(JW, name, v)
    # the script's shifts take a Python int, which the tests' 64-bit mode
    # would make int64: run it in JAX's default 32-bit mode, as on the TPU
    with jax.enable_x64(False), pltpu.force_tpu_interpret_mode():
        y = JW.pallas_gemv(JAX_W4_KERNELS[variant](), jnp.asarray(x),
                           jnp.asarray(packed), tn=tn, tk=tk)
    return np.asarray(y)


@pytest.mark.parametrize("variant", sorted(qmm.W4_VARIANTS))
def test_w4_unpack_plain_matches_jax_kernel(monkeypatch, variant):
    x, packed = _w4_operands(variant, 8, 1024, 256)
    ref = _jax_w4(monkeypatch, x, packed, variant, tn=256, tk=128)
    xt, pt = torch.from_numpy(x), torch.from_numpy(packed)
    got = qmm.w4_unpack_gemv_ref(xt, pt, variant)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    before = qmm.LAUNCHES["w4_unpack_gemv"]
    assert torch.equal(qmm.w4_unpack_gemv(xt, pt, variant), got)
    assert qmm.LAUNCHES["w4_unpack_gemv"] == before
    if variant:  # the W4 product: the served GEMV's int32
        served = qmm.w4a8_gemv_ref(xt, torch.ones(8), pt, torch.ones(256),
                                   torch.int32)
        assert torch.equal(got, served)


def test_w4_unpack_floored_grid(monkeypatch):
    """C-w8: K/2 = 640 packed rows with tk = 256 is n_k = 2 steps; JAX sums
    rows 0-511 only. The port sums all 640."""
    x, packed = _w4_operands(9, 8, 1280, 256)
    ref = _jax_w4(monkeypatch, x, packed, 3, tn=256, tk=256)
    xt, pt = torch.from_numpy(x), torch.from_numpy(packed)
    rows = torch.cat([torch.arange(512), 640 + torch.arange(512)])
    partial = qmm.w4_unpack_gemv_ref(
        xt[:, rows].contiguous(), pt[:512].contiguous(), 3)
    np.testing.assert_array_equal(ref, partial.numpy())
    full = qmm.w4_unpack_gemv(xt, pt, 3).numpy()
    w = qmm.unpack_int4_weights({"w_q": pt}).numpy().astype(np.int64)
    np.testing.assert_array_equal(full, x.astype(np.int64) @ w)
    assert (full != ref).any()


def test_probe_wrappers_raise():
    x = torch.zeros((9, 64), dtype=torch.bfloat16)
    w8 = torch.zeros((64, 32), dtype=torch.int8)
    with pytest.raises(ValueError):  # M > 8
        qmm.w8_bf16_gemv(x, w8, torch.ones(32))
    with pytest.raises(ValueError):  # w of another K
        qmm.w8_bf16_gemv(x[:2], w8[:32], torch.ones(32))
    with pytest.raises(ValueError):  # w_scale of another N
        qmm.w8_bf16_gemv(x[:2], w8, torch.ones(16))
    xq = torch.zeros((2, 64), dtype=torch.int8)
    with pytest.raises(ValueError):  # no variant 4
        qmm.w4_unpack_gemv(xq, w8[:32], 4)
    with pytest.raises(ValueError):  # odd K
        qmm.w4_unpack_gemv(xq[:, :63].contiguous(), w8[:31], 1)
    with pytest.raises(ValueError):  # M > 8
        qmm.w4_unpack_gemv(torch.zeros((9, 64), dtype=torch.int8), w8[:32], 1)
    meta = torch.zeros((2, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        qmm.w8_bf16_gemv(meta, w8.to("meta"), torch.ones(32, device="meta"))


def test_gemv_bench_cpu_run():
    bench = PG.Bench(3, 64, 48, "cpu")
    lines = []
    with torch.no_grad():
        out = PG.run(bench, 2, timed=False, log=lines.append)
    assert list(out) == [label for label, _ in PG.LINES]
    assert all(ms is None for ms in out.values())
    assert all("not timed" in s for s in lines)
    # the kernel line and the library line compute the same product
    y_k = bench.w8_bf16(bench.x0).float()
    y_l = bench.int8_bf16_dot(bench.x0).float()
    assert float((y_k - y_l).abs().max()) <= 1e-2 * float(y_l.abs().max())


def test_w4_unpack_tune_cpu_run():
    bench = PW.Bench(4, 64, 32, 2, "cpu")
    lines = []
    with torch.no_grad():
        out = PW.run(bench, timed=False, log=lines.append)
        PW.check(bench, log=lines.append)
    assert len(out) == 2 + len(qmm.W4_VARIANTS)
    assert all(ms is None for ms in out.values())
    assert any("not ported" in s for s in lines)
