"""The port's int8 matmuls against the JAX package's Pallas kernels (run in
interpret mode on the CPU, as tests/test_kernels.py runs them).

On the CPU each wrapper runs its plain version (exact integer dots), so
these tests hold the plain versions — and the routing around them — against
the TPU kernels they stand for. Tolerances: int32 accumulators (read through
unit scales, exact in f32 at these sizes) and f32 outputs equal; bf16
outputs within 1 bf16 ulp. The CUDA kernels themselves run only on the card
(``chip_smoke.py`` holds them against the same plain versions there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mquant_tpu.kernels import qmm as JK
from mquant_tpu.models.layers import SiteSpec as JSpec
from mquant_tpu_torch.kernels import qmm as TK
from mquant_tpu_torch.models.layers import SiteSpec as TSpec


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _bf16_within_1ulp(t: torch.Tensor, j):
    a = t.float().numpy()
    b = np.asarray(jnp.asarray(j, jnp.float32))
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), 2.0**-126)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert np.all(np.abs(a - b) <= ulp), np.max(np.abs(a - b) / ulp)


def _operands(rng, M, K, N, L=None, packed=True):
    """int8 activations, weights (split-half packed W4 or int8), per-token
    and per-channel scales."""
    x = rng.integers(-127, 128, size=(M, K)).astype(np.int8)
    shape = (K, N) if L is None else (L, K, N)
    if packed:
        w = rng.integers(-8, 8, size=shape).astype(np.int8)
        half = K // 2
        lo = w[..., :half, :].astype(np.uint8) & 0x0F
        hi = w[..., half:, :].astype(np.uint8) & 0x0F
        w = (lo | (hi << 4)).view(np.int8)
    else:
        w = rng.integers(-127, 128, size=shape).astype(np.int8)
    xs = rng.uniform(0.01, 0.1, size=(M, 1)).astype(np.float32)
    ws = rng.uniform(0.001, 0.01, size=(N,) if L is None else (L, N)
                     ).astype(np.float32)
    return x, w, xs, ws


@pytest.mark.parametrize("M", [1, 5])
def test_w4a8_gemv_matches_pallas_stacked(rng, M):
    """``_qmm_pallas_w4_stacked`` at every layer index == the port's GEMV on
    the layer view ``w[l]``."""
    L, K, N = 3, 512, 256
    x, w, xs, ws = _operands(rng, M, K, N, L=L)
    for li in range(L):
        idx = jnp.asarray([li], jnp.int32)
        ones_m, ones_n = np.ones((M, 1), np.float32), np.ones((N,), np.float32)
        acc_j = JK._qmm_pallas_w4_stacked(jnp.asarray(x), jnp.asarray(ones_m),
                                          jnp.asarray(w), jnp.asarray(ones_n),
                                          idx, jnp.float32, interpret=True)
        acc_t = TK.w4a8_gemv(_t(x), _t(ones_m[:, 0]), _t(w)[li],
                             _t(ones_n), torch.int32)
        np.testing.assert_array_equal(acc_t.numpy(),
                                      np.asarray(acc_j).astype(np.int32))
        for dt_j, dt_t in ((jnp.float32, torch.float32),
                           (jnp.bfloat16, torch.bfloat16)):
            y_j = JK._qmm_pallas_w4_stacked(
                jnp.asarray(x), jnp.asarray(xs), jnp.asarray(w),
                jnp.asarray(ws[li]), idx, dt_j, interpret=True)
            y_t = TK.w4a8_gemv(_t(x), _t(xs[:, 0]), _t(w)[li], _t(ws[li]),
                               dt_t)
            if dt_t == torch.float32:
                np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
            else:
                _bf16_within_1ulp(y_t, y_j)


@pytest.mark.parametrize("M", [3, 64])
def test_w4_matmul_matches_pallas_w4(rng, M):
    """``_qmm_pallas_w4`` (M ≤ 32: the per-layer GEMV; M > 32: the
    k-accumulating GEMM) == the port's GEMV / GEMM on the packed weight."""
    K, N = 512, 256
    x, w, xs, ws = _operands(rng, M, K, N)
    fn = TK.w4a8_gemv if M <= 32 else (
        lambda *a: TK.int8_gemm(*a, packed=True))
    ones_m, ones_n = np.ones((M, 1), np.float32), np.ones((N,), np.float32)
    acc_j = JK._qmm_pallas_w4(jnp.asarray(x), jnp.asarray(ones_m),
                              {"w_q": jnp.asarray(w),
                               "w_scale": jnp.asarray(ones_n)},
                              jnp.float32, tm=16, tn=128, tk=128,
                              interpret=True)
    acc_t = fn(_t(x), _t(ones_m[:, 0]), _t(w), _t(ones_n), torch.int32)
    np.testing.assert_array_equal(acc_t.numpy(),
                                  np.asarray(acc_j).astype(np.int32))
    p = {"w_q": jnp.asarray(w), "w_scale": jnp.asarray(ws)}
    y_j = JK._qmm_pallas_w4(jnp.asarray(x), jnp.asarray(xs), p, jnp.float32,
                            tm=16, tn=128, tk=128, interpret=True)
    y_t = fn(_t(x), _t(xs[:, 0]), _t(w), _t(ws), torch.float32)
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    yb_j = JK._qmm_pallas_w4(jnp.asarray(x), jnp.asarray(xs), p, jnp.bfloat16,
                             tm=16, tn=128, tk=128, interpret=True)
    _bf16_within_1ulp(fn(_t(x), _t(xs[:, 0]), _t(w), _t(ws), torch.bfloat16),
                      yb_j)


@pytest.mark.parametrize("M", [1, 8])
def test_int8_gemv_matches_pallas_gemv(rng, M):
    K, N = 256, 384
    x, w, xs, ws = _operands(rng, M, K, N, packed=False)
    ones_m, ones_n = np.ones((M, 1), np.float32), np.ones((N,), np.float32)
    acc_j = JK._qmm_pallas_gemv(jnp.asarray(x), jnp.asarray(ones_m),
                                jnp.asarray(w), jnp.asarray(ones_n),
                                jnp.float32, interpret=True)
    acc_t = TK.int8_gemv(_t(x), _t(ones_m[:, 0]), _t(w), _t(ones_n),
                         torch.int32)
    np.testing.assert_array_equal(acc_t.numpy(),
                                  np.asarray(acc_j).astype(np.int32))
    y_j = JK._qmm_pallas_gemv(jnp.asarray(x), jnp.asarray(xs), jnp.asarray(w),
                              jnp.asarray(ws), jnp.float32, interpret=True)
    y_t = TK.int8_gemv(_t(x), _t(xs[:, 0]), _t(w), _t(ws), torch.float32)
    # the Pallas GEMV multiplies (acc·w_scale)·x_scale; the port keeps the
    # main path's (acc·x_scale)·w_scale (qmm.py:569/:577, exact in
    # test_quantized_matmul_pre_routing). Each order rounds twice, so the two
    # differ by at most 2 f32 ulps.
    a, b = y_t.numpy(), np.asarray(y_j)
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    assert np.all(np.abs(a - b) <= 2 * ulp)
    yb_j = JK._qmm_pallas_gemv(jnp.asarray(x), jnp.asarray(xs), jnp.asarray(w),
                               jnp.asarray(ws), jnp.bfloat16, interpret=True)
    _bf16_within_1ulp(TK.int8_gemv(_t(x), _t(xs[:, 0]), _t(w), _t(ws),
                                   torch.bfloat16), yb_j)


def test_int8_gemm_w8_matches_xla_s8_dot(rng):
    """W8 GEMM (ViT / merger) == the JAX package's s8 dot_general path."""
    M, K, N = 40, 128, 96
    x, w, xs, ws = _operands(rng, M, K, N, packed=False)
    y_j = JK.quantized_matmul_pre(jnp.asarray(x), jnp.float32(0.05),
                                  {"w_q": jnp.asarray(w),
                                   "w_scale": jnp.asarray(ws)}, jnp.float32)
    y_t = TK.int8_gemm(_t(x), torch.full((M,), 0.05), _t(w), _t(ws),
                       torch.float32)
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))


# ragged N at M = 40 (a GEMM): N odd and N % 4 == 2 at K = 1000, and
# InternVL2-8B's lm_head width N = 92553 at a short K; W8 and packed W4
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("K,N", [(1000, 1003), (1000, 1002), (64, 92553)])
def test_quantized_matmul_pre_ragged_n_matches_jax(rng, packed, K, N):
    """JAX ``quantized_matmul_pre`` on its default M > 32 route (the exact s8
    dot_general for W8, ``_two_gemm_packed`` for W4) against the port's on
    the CPU (the plain version that ``int8_gemm_ragged`` holds on the card),
    shared operands: bf16 bit-equal (both integer sums are exact)."""
    M = 40
    x, w, xs, ws = _operands(rng, M, K, N, packed=packed)
    y_j = JK.quantized_matmul_pre(jnp.asarray(x), jnp.asarray(xs),
                                  {"w_q": jnp.asarray(w),
                                   "w_scale": jnp.asarray(ws)}, jnp.bfloat16)
    y_t = TK.quantized_matmul_pre(_t(x), _t(xs),
                                  {"w_q": _t(w), "w_scale": _t(ws)},
                                  torch.bfloat16)
    assert y_t.shape == (M, N) and y_t.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        y_t.float().numpy(), np.asarray(jnp.asarray(y_j, jnp.float32)))
    assert TK.ragged_supports(K, N, packed) and not TK.tma_supports(
        K, N, packed)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("lead", [(2,), (1, 3), (45,), (3, 17)])
def test_quantized_matmul_pre_routing(rng, packed, lead):
    """Routing by token count (≤ 32 → GEMV, > 32 → GEMM) and by storage
    (packed W4 / int8), with scalar and per-token scales, against the JAX
    function's XLA paths on the CPU."""
    K, N = 128, 64
    M = int(np.prod(lead))
    x, w, xs, ws = _operands(rng, M, K, N, packed=packed)
    xq = x.reshape(*lead, K)
    for scale in (np.float32(0.04), xs.reshape(*lead, 1)):
        y_j = JK.quantized_matmul_pre(jnp.asarray(xq), jnp.asarray(scale),
                                      {"w_q": jnp.asarray(w),
                                       "w_scale": jnp.asarray(ws)},
                                      jnp.float32)
        y_t = TK.quantized_matmul_pre(_t(xq), _t(scale),
                                      {"w_q": _t(w), "w_scale": _t(ws)},
                                      torch.float32)
        assert y_t.shape == (*lead, N)
        np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))


def test_quantized_matmul_end_to_end(rng):
    """fp activation → static int8 → W4 GEMV → dequant, as qlinear runs it."""
    from mquant_tpu.core.quant import QuantParams as JQP
    from mquant_tpu_torch.core.quant import QuantParams as TQP

    w = rng.normal(size=(128, 64)).astype(np.float32)
    x = rng.normal(size=(4, 128)).astype(np.float32)
    pj = JK.quantize_weights_real(jnp.asarray(w), 4)
    pt = TK.quantize_weights_real(_t(w), 4)
    y_j = JK.quantized_matmul(jnp.asarray(x), pj,
                              JSpec(w_bits=4, a_bits=8, a_static=True),
                              {"act": JQP(jnp.float32(0.05))})
    y_t = TK.quantized_matmul(_t(x), pt,
                              TSpec(w_bits=4, a_bits=8, a_static=True),
                              {"act": TQP(torch.tensor(0.05))})
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))


def test_pack_w4_sites_matches_jax(rng):
    """Fused q|k|v and gate|up packed matrices and the per-site packing of o
    and down are byte-identical to the JAX package's (stacked layers)."""
    L, Hd, I = 2, 64, 96
    widths = {"q": (Hd, 64), "k": (Hd, 32), "v": (Hd, 32), "o": (64, Hd),
              "gate": (Hd, I), "up": (Hd, I), "down": (I, Hd)}
    layers = {n: {"w_q": rng.integers(-7, 8, size=(L, a, b)).astype(np.int8),
                  "w_scale": rng.uniform(0.01, 0.1, size=(L, b)).astype(
                      np.float32)} for n, (a, b) in widths.items()}
    specs_j = {f"llm.{n}": JSpec(w_bits=4, a_bits=8, a_static=True)
               for n in widths}
    specs_t = {f"llm.{n}": TSpec(w_bits=4, a_bits=8, a_static=True)
               for n in widths}
    in_dims = {n: a for n, (a, b) in widths.items()}
    j = JK.pack_w4_sites({n: {k: jnp.asarray(v) for k, v in s.items()}
                          for n, s in layers.items()}, specs_j, in_dims)
    t = TK.pack_w4_sites({n: {k: _t(v) for k, v in s.items()}
                          for n, s in layers.items()}, specs_t, in_dims)
    for n in widths:
        assert set(t[n]) == set(j[n]), n
        for k in j[n]:
            np.testing.assert_array_equal(t[n][k].numpy(), np.asarray(j[n][k]))
    assert t["q"]["w_q_fused"].shape == (L, Hd // 2, 128)
    assert t["gate"]["w_q_fused"] is t["up"]["w_q_fused"]


def test_unpack_int4_weights_matches_jax(rng):
    b = rng.integers(-128, 128, size=(2, 16, 8)).astype(np.int8)
    np.testing.assert_array_equal(
        TK.unpack_int4_weights({"w_q": _t(b)}).numpy(),
        np.asarray(JK.unpack_int4_weights({"w_q": jnp.asarray(b)})))


@pytest.mark.parametrize("name", ["w4a8_gemv", "int8_gemv", "int8_gemm",
                                  "int8_gemm_ragged"])
def test_wrappers_reject_bad_operands(rng, name):
    """The wrappers check dtype, shape and device and raise; a tensor that
    is neither on the CPU nor on a CUDA card gets no plain fallback."""
    fn = TK.KERNELS[name]
    packed = name == "w4a8_gemv"
    x, w, xs, ws = _operands(rng, 2, 64, 32, packed=packed)
    args = [_t(x), _t(xs[:, 0]), _t(w), _t(ws)]
    with pytest.raises(ValueError):
        fn(args[0].float(), *args[1:])  # activations must be int8
    with pytest.raises(ValueError):
        fn(args[0], args[1], args[2][:-2], args[3])  # K mismatch
    with pytest.raises(ValueError):
        fn(*[a.to("meta") for a in args])
    for k in TK.LAUNCHES:
        TK.LAUNCHES[k] = 0
    fn(*args)  # CPU: the plain version, not a kernel launch
    assert TK.LAUNCHES[name] == 0
