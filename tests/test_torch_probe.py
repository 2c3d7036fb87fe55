"""The port's prefill-probe kernels and probes against the JAX package (CPU;
numpy inputs from fixed seeds for both packages).

* ``rms_norm_quant_ref``, ``had_quant_ref`` and ``fwht_two_matmul_ref`` (the
  plain versions of the CUDA kernels ``mq_rms_norm_quant``, ``mq_had_quant``
  and ``mq_fwht``) against JAX ``rms_norm_quant`` / ``had_quant`` /
  ``fwht_pallas`` in interpret mode. Int8 codes: equal, or within ±1 with at
  most 1e-3 of them differing (the two sum f32 squares and products in other
  orders, so a code on a rounding tie may land one step apart; the fraction
  is asserted per case). fwht: within rtol = atol = 1e-4 in f32
  (``TestFwhtPallas``'s tolerance); in bf16 within one bf16 ulp plus 1e-5
  of the largest magnitude (an output near zero comes out of a cancelling
  f32 sum, whose last bits depend on the sum's order, and there a bf16 ulp
  is finer than f32's absolute error).
* The ported ``fwht`` / ``hadamard_transform`` / ``transform_matrix`` and
  ``layers.causal_mask`` against their JAX originals (1e-5 in f32, exact).
* ROADMAP C-w7: quantize(rms_norm(x, w)) is not rms_norm_quant: the chain
  rounds y to bf16 before the quantizer, and its codes differ.
* ``scripts/prefill_probe`` at tiny widths: every segment runs and keeps its
  shape, and each fused segment matches its unfused twin.
* ``scripts/mxu_rate`` at tiny shapes: the int8 kernel's int32 product
  equals numpy's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mquant_tpu.core.formats import INT8 as JINT8
from mquant_tpu.core.quant import QuantParams as JQP
from mquant_tpu.core.quant import quantize as jquantize
from mquant_tpu.kernels import fwht as JF
from mquant_tpu.models import layers as JL
from mquant_tpu.transform import hadamard as JH
from mquant_tpu_torch import interop
from mquant_tpu_torch.core.formats import INT8
from mquant_tpu_torch.core.quant import QuantParams, quantize
from mquant_tpu_torch.kernels import fwht as TF
from mquant_tpu_torch.models import layers as TL
from mquant_tpu_torch.scripts import mxu_rate as MR
from mquant_tpu_torch.scripts import prefill_probe as PP
from mquant_tpu_torch.transform import hadamard as TH

SCALE = 0.05
CODE_FRAC = 1e-3  # at most this fraction of codes one step apart


def _t(a):
    return interop.array_to_torch(a, device="cpu")


def _bf16(rng, *shape, sd=1.0):
    return np.asarray(jnp.asarray(rng.normal(size=shape) * sd, jnp.bfloat16))


def _codes_close(got, ref):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(ref, np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= CODE_FRAC, (d.max(),
                                                          (d > 0).mean())


def _within_ulp(got, ref):
    """One bf16 ulp at max(|got|, |ref|), plus 1e-5 of max |ref|."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    mag = np.maximum(np.abs(got), np.abs(ref)).clip(min=2.0**-126)
    room = np.exp2(np.floor(np.log2(mag)) - 7) + 1e-5 * np.abs(ref).max()
    assert (np.abs(got - ref) <= room).all()


# T = 13: padding tokens in the JAX kernel's 16-row tile
@pytest.mark.parametrize("T,n", [(13, 128), (13, 3584), (4, 1024)])
def test_rms_norm_quant_plain_matches_jax_kernel(T, n):
    rng = np.random.default_rng(T * n)
    x = _bf16(rng, 1, T, n, sd=3.0)
    w = _bf16(rng, n, sd=0.5)
    ref = JF.rms_norm_quant(jnp.asarray(x), jnp.asarray(w), jnp.float32(SCALE),
                            interpret=True)
    got = TF.rms_norm_quant_ref(_t(x), _t(w), torch.tensor(SCALE))
    assert got.dtype == torch.int8 and got.shape == (1, T, n)
    _codes_close(got.numpy(), ref)
    # CPU tensors: the wrapper is the plain version, and launches nothing
    before = TF.LAUNCHES["rms_norm_quant"]
    np.testing.assert_array_equal(
        TF.rms_norm_quant(_t(x), _t(w), SCALE).numpy(), got.numpy())
    assert TF.LAUNCHES["rms_norm_quant"] == before


@pytest.mark.parametrize("port", [True, False])
def test_unfused_norm_quant_chain_differs(port):
    """ROADMAP C-w7: the JAX docstring calls rms_norm_quant "same math as
    quantize(rms_norm(x, w), scale)", but rms_norm rounds y to bf16 before
    the quantizer and the kernel does not: codes within ±1, some differ (in
    the port and in the JAX package alike)."""
    rng = np.random.default_rng(7)
    x, w = _bf16(rng, 64, 3584), _bf16(rng, 3584, sd=0.5)
    if port:
        fused = TF.rms_norm_quant_ref(_t(x), _t(w), SCALE).numpy()
        chain = quantize(TL.rms_norm(_t(x), _t(w)),
                         QuantParams(torch.tensor(SCALE)), INT8).numpy()
    else:
        fused = np.asarray(JF.rms_norm_quant(jnp.asarray(x), jnp.asarray(w),
                                             jnp.float32(SCALE),
                                             interpret=True))
        chain = np.asarray(jquantize(JL.rms_norm(jnp.asarray(x),
                                                 jnp.asarray(w)),
                                     JQP(scale=jnp.float32(SCALE)), JINT8))
    d = np.abs(fused.astype(np.int32) - chain.astype(np.int32))
    assert d.max() == 1 and 1e-3 < (d > 0).mean() < 0.1


@pytest.mark.parametrize("n,T", [(512, 8), (3584, 5), (18944, 3)])
def test_had_quant_plain_matches_jax_kernel(n, T):
    rng = np.random.default_rng(n + T)
    x = _bf16(rng, 1, T, n)
    ref = JF.had_quant(jnp.asarray(x), jnp.float32(SCALE), interpret=True)
    got = TF.had_quant_ref(_t(x), torch.tensor(SCALE))
    assert got.dtype == torch.int8 and got.shape == (1, T, n)
    _codes_close(got.numpy(), ref)
    before = TF.LAUNCHES["had_quant"]
    np.testing.assert_array_equal(TF.had_quant(_t(x), SCALE).numpy(),
                                  got.numpy())
    assert TF.LAUNCHES["had_quant"] == before


def test_had_quant_is_the_tail_without_swiglu():
    """At n = 18944 had_quant of a precomputed bf16 silu(g)·u gives the fused
    tail's codes."""
    rng = np.random.default_rng(3)
    g, u = _t(_bf16(rng, 2, 18944)), _t(_bf16(rng, 2, 18944))
    gf, uf = g.float(), u.float()
    x = ((gf * torch.sigmoid(gf)) * uf).to(torch.bfloat16)
    np.testing.assert_array_equal(
        TF.had_quant_ref(x, SCALE).numpy(),
        TF.fused_swiglu_had_quant_ref(g, u, SCALE).numpy())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n", [96, 128, 256, 3584])
def test_fwht_two_matmul_plain_matches_jax_kernel(n, dtype):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(3, 5, n)).astype(np.float32)  # 15 tokens: padding
    if dtype == "bf16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16))
    ref = np.asarray(JF.fwht_pallas(jnp.asarray(x), tile_t=8, interpret=True))
    got = TF.fwht_two_matmul_ref(_t(x))
    assert got.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    got = got.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    else:
        _within_ulp(got, ref)
    before = TF.LAUNCHES["fwht_two_matmul"]
    np.testing.assert_array_equal(
        TF.fwht_two_matmul(_t(x)).float().numpy(), got)
    assert TF.LAUNCHES["fwht_two_matmul"] == before


def test_fwht_two_matmul_keeps_f32_between_factors():
    """On bf16 x it is not online_hadamard, which rounds to bf16 between the
    two products: the f32 form agrees with the dense f64 transform to one
    bf16 ulp, the chain does not everywhere."""
    rng = np.random.default_rng(5)
    x = _t(_bf16(rng, 16, 3584))
    exact = (x.double() @ torch.from_numpy(TH.transform_matrix(3584)).T)
    _within_ulp(TF.fwht_two_matmul_ref(x).float().numpy(),
                exact.to(torch.bfloat16).float().numpy())
    assert not torch.equal(TF.fwht_two_matmul_ref(x), TF.online_hadamard(x))


# every n = K·128 of the Hadamard kernels' contract (K ≤ 160)
KERNEL_NS = [K * TF.TAIL_M for K in range(1, TF.TAIL_MAX_K + 1)
             if TF.tail_supports(K * TF.TAIL_M)]


@pytest.mark.parametrize("n", KERNEL_NS)
def test_fwht_hadK_is_a_scaled_sign_matrix(n):
    """The K-axis factor of every n the kernels take (the Paley / get_hadK
    orders, the pow2 splits' Sylvester H_a, K = 1) is c · sign(A) with one
    f32 c = 1/√K, which ``mq_fwht`` takes on the tensor cores; only the
    seeded random orthogonal block (K = 156) is not, and goes to
    ``mq_fwht_dense``. ``mq_fwht``'s ring holds a whole bf16 or f32 row of
    every such n (``_fwht_plan``)."""
    for elem, ring in ((2, TF.FWHT_STAGE_BYTES - TF.FWHT_OUT_STAGE_BYTES),
                       (4, TF.FWHT_STAGE_BYTES)):
        blocks, slots = TF._fwht_plan(1024, n, elem, 132)
        assert blocks == 132 and 1 <= slots <= TF.TAIL_MAX_SLOTS
        assert slots * n * elem <= ring
    assert TF._fwht_plan(5, n, 2, 132)[0] == 5
    A, _, K = TF._factors(n)
    sf = TF._sign_factor(n)
    c_kernel = TF._fwht_factors(n, torch.device("cpu"))[1]
    if K in TH._RANDOM_ORTHO_K:
        assert sf is None and c_kernel is None  # mq_fwht_dense
        return
    S, c = sf
    assert c_kernel == c  # mq_fwht
    assert set(np.unique(S).tolist()) == ({1.0} if K == 1 else {-1.0, 1.0})
    np.testing.assert_array_equal(np.float32(c) * S, A)
    np.testing.assert_allclose(c, 1 / np.sqrt(K), rtol=1e-6)


def _fwht_tc_model(x: torch.Tensor) -> torch.Tensor:
    """``fwht_tc_kernel``'s arithmetic in plain PyTorch: Y1 = X·H₁₂₈ by an
    f32 butterfly (Sylvester order), × 1/√128; Y1 split into three bf16
    terms hi + mid + lo (exactly Y1); c · (S·lo + S·mid + S·hi) with the
    sign matrix S, exact products and f32 sums; cast to x's dtype."""
    n = x.shape[-1]
    _, B, K = TF._factors(n)
    S, c = TF._sign_factor(n)
    X = x.float().reshape(-1, K, TF.TAIL_M)
    h = 1
    while h < TF.TAIL_M:  # pairs (i, i + h) in blocks of 2h
        X = X.reshape(*X.shape[:2], -1, 2, h)
        X = torch.stack([X[..., 0, :] + X[..., 1, :],
                         X[..., 0, :] - X[..., 1, :]], dim=-2)
        h *= 2
    Y1 = X.reshape(-1, K, TF.TAIL_M) * float(B[0, 0])
    hi = Y1.bfloat16().float()
    mid = (Y1 - hi).bfloat16().float()
    lo = (Y1 - hi - mid).bfloat16().float()
    assert torch.equal(hi + mid + lo, Y1)  # the split is exact
    St = torch.from_numpy(S)
    acc = St @ lo
    acc = acc + St @ mid
    acc = acc + St @ hi
    return (acc * c).reshape(x.shape).to(x.dtype)


@pytest.mark.parametrize("against", ["plain", "jax"])
@pytest.mark.parametrize("n", [18944, 4096, 3584, 128])
def test_fwht_tc_model_matches(n, against):
    """The kernel's arithmetic (:func:`_fwht_tc_model`) against
    ``fwht_two_matmul_ref`` (float64) and JAX ``fwht_pallas`` in interpret
    mode, on f32 rows: within 1e-5 of the largest magnitude (the card's
    bound, FWHT_RTOL)."""
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(3, n)) * 3).astype(np.float32)
    got = _fwht_tc_model(_t(x)).numpy()
    ref = (TF.fwht_two_matmul_ref(_t(x)).numpy() if against == "plain" else
           np.asarray(JF.fwht_pallas(jnp.asarray(x), tile_t=8,
                                     interpret=True)))
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("n", [8, 128, 1024])
def test_fwht_butterfly_matches_jax(n):
    x = np.random.default_rng(n).normal(size=(4, n)).astype(np.float32)
    np.testing.assert_allclose(TH.fwht(_t(x)).numpy(),
                               np.asarray(JH.fwht(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [96, 128, 256, 3584])
def test_hadamard_transform_matches_jax(n):
    x = np.random.default_rng(n).normal(size=(2, 3, n)).astype(np.float32)
    np.testing.assert_allclose(TH.hadamard_transform(_t(x)).numpy(),
                               np.asarray(JH.hadamard_transform(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    M = TH.transform_matrix(n)
    assert M.dtype == np.float64
    np.testing.assert_allclose(M, JH.transform_matrix(n), rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        TH.transform_matrix(n, np.float32), JH.transform_matrix(n, np.float32),
        rtol=1e-5, atol=1e-5)


def test_causal_mask_matches_jax():
    for T, S, off in ((5, 5, 0), (3, 9, 6)):
        np.testing.assert_array_equal(
            TL.causal_mask(T, S, off, device="cpu").numpy(),
            np.asarray(JL.causal_mask(T, S, off)))


@pytest.mark.parametrize("n,K", [(18944, 148), (3584, 28), (512, 4),
                                 (16384, 128), (128, 1)])
def test_hadamard_kernels_contract(n, K):
    assert TF._hadamard_K("k", n) == K


@pytest.mark.parametrize("n", [96, 2368, 32768])
def test_hadamard_kernels_contract_raises(n):
    """m ≠ 128 (96 = 12·8, 2368 = 148·16) or pow2 n above 16384 (m = 256)."""
    with pytest.raises(ValueError):
        TF._hadamard_K("k", n)


def test_wrappers_raise_on_other_devices():
    x = torch.zeros((2, 512), dtype=torch.bfloat16, device="meta")
    for fn in (lambda: TF.had_quant(x, SCALE),
               lambda: TF.fwht_two_matmul(x),
               lambda: TF.rms_norm_quant(x, x[0], SCALE)):
        with pytest.raises(ValueError):
            fn()


TINY = PP.ProbeConfig(T=64, hidden=128, inter=512, heads=4, kv_heads=2,
                      head_dim=32)


@pytest.fixture(scope="module")
def probe():
    return PP.Probe(TINY, "cpu", seed=0)


@pytest.mark.parametrize("text,meth,kind", PP.SEGMENTS)
def test_probe_segment_runs(probe, text, meth, kind):
    h = probe.input(kind)
    with torch.no_grad():
        y = getattr(probe, meth)(h)
        y2 = getattr(probe, meth)(y.to(h.dtype))  # chained, as timed
    assert y.shape == h.shape == y2.shape
    assert bool(torch.isfinite(y.float()).all())
    assert bool(torch.isfinite(y2.float()).all())


@pytest.mark.parametrize("twin", PP.TWINS, ids=[t[0] for t in PP.TWINS])
def test_probe_fused_segment_matches_twin(probe, twin):
    fused, other, kind, a, b, cmp = twin
    h = probe.input(kind)
    with torch.no_grad():
        cmp(getattr(probe, a)(h), getattr(probe, b)(h), f"{fused} vs {other}")


def test_probe_run_untimed_on_cpu(probe):
    lines = []
    with torch.no_grad():
        out = PP.run(probe, 2, timed=False, log=lines.append)
    assert list(out) == [PP.label(TINY, s[0]) for s in PP.SEGMENTS]
    assert all(ms is None for ms in out.values())
    assert all("not timed" in s for s in lines)


def test_probe_rejects_bad_widths():
    with pytest.raises(ValueError):
        PP.Probe(PP.ProbeConfig(T=8, hidden=100, inter=512, heads=4,
                                kv_heads=2, head_dim=32), "cpu")


@pytest.mark.parametrize("M,K,N", [(40, 64, 48), (33, 96, 8), (64, 3584, 16)])
def test_mxu_rate_int32_matches_numpy(M, K, N):
    x, w, xb, wb = MR.operands(M, K, N, "cpu", seed=M)
    assert x.dtype == w.dtype == torch.int8 and xb.dtype == torch.bfloat16
    got = MR.int8_gemm_i32(x, w)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), x.numpy().astype(np.int64) @ w.numpy().astype(np.int64))


def test_mxu_rate_cpu_main(capsys):
    assert MR.main(["--M", "40", "--K", "64", "--N", "48", "--device",
                    "cpu"]) == 0
    assert "(40, 48) (not timed)" in capsys.readouterr().out
