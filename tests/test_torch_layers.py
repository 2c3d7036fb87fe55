"""The port's model layers against the JAX package's (f32, CPU, numpy
inputs from a fixed seed).

Tolerances: integer paths (qlinear / qlinear_group in real mode) equal; float
kernels (Hadamard, norms, rope tables, attention) within a few f32 ulps of
their magnitude — the two frameworks sum in different orders."""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mquant_tpu.core.quant import QuantParams as JQP
from mquant_tpu.kernels import fwht as JF
from mquant_tpu.kernels import qmm as JK
from mquant_tpu.models import layers as JL
from mquant_tpu.models import llm as JLLM
from mquant_tpu.transform import hadamard as JH
from mquant_tpu_torch.core.quant import QuantParams as TQP
from mquant_tpu_torch.kernels import fwht as TF
from mquant_tpu_torch.kernels import qmm as TK
from mquant_tpu_torch.models import layers as TL
from mquant_tpu_torch.models import llm as TLLM
from mquant_tpu_torch.transform import hadamard as TH

F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _spec_pair(**kw):
    return JL.SiteSpec(**kw), TL.SiteSpec(**kw)


@pytest.mark.parametrize("bits,M", [(4, 5), (4, 40), (8, 3), (8, 40)])
def test_qlinear_real_matches_jax(rng, bits, M):
    """W4 packed / W8 sites with static per-tensor int8 activations and a
    bias, at decode (GEMV) and prefill (GEMM) token counts."""
    K, N = 128, 64
    w = rng.normal(size=(K, N)).astype(np.float32)
    b = rng.normal(size=(N,)).astype(np.float32)
    x = rng.normal(size=(1, M, K)).astype(np.float32)
    pj = dict(JK.quantize_weights_real(jnp.asarray(w), bits), b=jnp.asarray(b))
    pt = dict(TK.quantize_weights_real(_t(w), bits), b=_t(b))
    sj, st = _spec_pair(w_bits=bits, a_bits=8, a_static=True)
    yj = JL.qlinear(jnp.asarray(x), pj, "s", sj,
                    {"s": {"act": JQP(jnp.float32(0.04))}}, "real")
    yt = TL.qlinear(_t(x), pt, "s", st, {"s": {"act": TQP(torch.tensor(0.04))}},
                    "real")
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


def test_qlinear_block_hadamard_site_matches_jax(rng):
    """The ``down`` site of the main path: block online Hadamard → static
    int8 → W4 GEMM. Float Hadamard sums differ in order, so a few codes may
    land one step apart; the outputs agree within that."""
    K, N = 256, 32
    w = rng.normal(size=(K, N)).astype(np.float32)
    x = rng.normal(size=(1, 7, K)).astype(np.float32)
    sj, st = _spec_pair(w_bits=4, a_bits=8, a_static=True, online_had="block",
                        head_dim=128)
    yj = JL.qlinear(jnp.asarray(x), JK.quantize_weights_real(jnp.asarray(w), 4),
                    "d", sj, {"d": {"act": JQP(jnp.float32(0.02))}}, "real")
    yt = TL.qlinear(_t(x), TK.quantize_weights_real(_t(w), 4), "d", st,
                    {"d": {"act": TQP(torch.tensor(0.02))}}, "real")
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-3, atol=2e-2)


def test_qlinear_fp_mode_matches_jax(rng):
    x = rng.normal(size=(2, 3, 16)).astype(np.float32)
    w = rng.normal(size=(16, 8)).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    yj = JL.qlinear(jnp.asarray(x), {"w": jnp.asarray(w), "b": jnp.asarray(b)},
                    "s")
    yt = TL.qlinear(_t(x), {"w": _t(w), "b": _t(b)}, "s")
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **F32_TOL)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("M", [2, 36])
def test_qlinear_group_matches_jax(rng, fused, M):
    """q|k|v sharing one quantized input: per-site GEMMs, or (after
    ``pack_w4_sites``) one fused GEMM sliced apart — both equal JAX's."""
    K = 64
    widths = {"q": 64, "k": 32, "v": 32}
    raw = {n: {"w_q": rng.integers(-7, 8, size=(K, m)).astype(np.int8),
               "w_scale": rng.uniform(0.01, 0.1, size=(m,)).astype(np.float32),
               "b": rng.normal(size=(m,)).astype(np.float32)}
           for n, m in widths.items()}
    names = [f"llm.{n}" for n in widths]
    sj, st = _spec_pair(w_bits=4, a_bits=8, a_static=True)
    lj = {n: {k: jnp.asarray(v) for k, v in s.items()} for n, s in raw.items()}
    lt = {n: {k: _t(v) for k, v in s.items()} for n, s in raw.items()}
    if fused:
        in_dims = {n: K for n in widths}
        lj = JK.pack_w4_sites(lj, {n: sj for n in names}, in_dims)
        lt = TK.pack_w4_sites(lt, {n: st for n in names}, in_dims)
        assert "w_q_fused" in lt["q"]
    x = rng.normal(size=(1, M, K)).astype(np.float32)
    oj = JL.qlinear_group(jnp.asarray(x), [lj[n] for n in widths], names,
                          {n: sj for n in names},
                          {"llm.q": {"act": JQP(jnp.float32(0.05))}}, "real")
    ot = TL.qlinear_group(_t(x), [lt[n] for n in widths], names,
                          {n: st for n in names},
                          {"llm.q": {"act": TQP(torch.tensor(0.05))}}, "real")
    for a, b in zip(ot, oj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("n", [1, 2, 12, 20, 28, 36, 52, 64, 148, 156])
def test_hadamard_generation_matches_jax(n):
    """Sylvester, Paley I/II (incl. GF(27) → 28, GF(25) → 52) and the seeded
    random orthogonal block (156): identical matrices and K factors."""
    np.testing.assert_array_equal(TH._block_K(n), JH._block_K(n))
    if n not in (156,):
        np.testing.assert_array_equal(TH.hadamard_matrix(n),
                                      JH.hadamard_matrix(n))
    for dim in (n * 64, 18944, 29568, 3584):
        try:
            ref = JH.get_hadK(dim)
        except ValueError:
            with pytest.raises(ValueError):
                TH.get_hadK(dim)
            continue
        got = TH.get_hadK(dim)
        assert got[1] == ref[1]
        np.testing.assert_array_equal(got[0], ref[0])
        assert TH.auto_pad_size(dim) == JH.auto_pad_size(dim)
    assert TH.SUPPORTED_K == JH.SUPPORTED_K


@pytest.mark.parametrize("n", [128, 256, 96, 18944 // 64])
def test_online_hadamard_matches_jax(rng, n):
    """Full mode (Paley / Sylvester Kronecker factors) over n."""
    x = rng.normal(size=(4, 5, n)).astype(np.float32)
    np.testing.assert_allclose(TF.online_hadamard(_t(x)).numpy(),
                               np.asarray(JF.online_hadamard(jnp.asarray(x))),
                               **F32_TOL)


@pytest.mark.parametrize("mode,width", [("block", 128), ("head", 32),
                                        ("full", 0)])
def test_site_online_hadamard_modes(rng, mode, width):
    x = rng.normal(size=(2, 3, 384)).astype(np.float32)
    sj, st = _spec_pair(online_had=mode, head_dim=width)
    np.testing.assert_allclose(
        TL._online_hadamard(_t(x), st).numpy(),
        np.asarray(JL._online_hadamard(jnp.asarray(x), sj)), **F32_TOL)


def test_norms_and_swiglu_match_jax(rng):
    x = rng.normal(size=(2, 5, 48)).astype(np.float32) * 3
    w = rng.normal(size=(48,)).astype(np.float32)
    b = rng.normal(size=(48,)).astype(np.float32)
    np.testing.assert_allclose(TL.rms_norm(_t(x), _t(w)).numpy(),
                               np.asarray(JL.rms_norm(jnp.asarray(x),
                                                      jnp.asarray(w))),
                               **F32_TOL)
    np.testing.assert_allclose(
        TL.layer_norm(_t(x), _t(w), _t(b), 1e-6).numpy(),
        np.asarray(JL.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b), 1e-6)), **F32_TOL)
    np.testing.assert_allclose(
        TL.swiglu(_t(x), _t(x[::-1].copy())).numpy(),
        np.asarray(JL.swiglu(jnp.asarray(x), jnp.asarray(x[::-1]))),
        **F32_TOL)


@pytest.mark.parametrize("mrope", [True, False])
def test_rope_tables_and_apply_match_jax(rng, mrope):
    """Qwen2-VL M-RoPE: (3, B, T) position planes, head_dim channels split
    (16, 24, 24) across them; and plain (B, T) positions."""
    cfg_j = JLLM.DecoderConfig(vocab=8, hidden=512, n_layers=1, n_heads=4,
                               n_kv_heads=2, intermediate=8,
                               mrope_sections=(16, 24, 24))
    cfg_t = TLLM.DecoderConfig(vocab=8, hidden=512, n_layers=1, n_heads=4,
                               n_kv_heads=2, intermediate=8,
                               mrope_sections=(16, 24, 24))
    shape = (3, 2, 9) if mrope else (2, 9)
    pos = rng.integers(0, 3000, size=shape)
    cj, sj = JLLM.rope_tables(cfg_j, jnp.asarray(pos), jnp.float32)
    ct, st = TLLM.rope_tables(cfg_t, _t(pos), torch.float32)
    assert ct.shape == (2, 9, 128)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=2e-6, rtol=0)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=2e-6, rtol=0)
    q = rng.normal(size=(2, 9, 4, 128)).astype(np.float32)
    k = rng.normal(size=(2, 9, 2, 128)).astype(np.float32)
    qj, kj = JL.apply_rope(jnp.asarray(q), jnp.asarray(k), cj, sj)
    qt, kt = TL.apply_rope(_t(q), _t(k), ct, st)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=2e-5, rtol=0)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=2e-5, rtol=0)


def test_attention_gqa_masks_poisoned_tail(rng):
    """Decode-style GQA attention over a cache whose columns beyond ``pos``
    hold poison (huge values, as a reused slot's stale KV would): the bool
    mask must remove them exactly, in both packages."""
    B, T, H, KVH, hd, S, pos = 2, 3, 8, 2, 16, 24, 11
    q = rng.normal(size=(B, T, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, KVH, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KVH, hd)).astype(np.float32)
    rows = pos + np.arange(T)[:, None]
    mask = (np.arange(S)[None, :] <= rows)[None, None].repeat(B, 0)
    kp, vp = k.copy(), v.copy()
    kp[:, pos + T:] = 3e4
    vp[:, pos + T:] = -3e4
    oj = JL.attention(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                      jnp.asarray(mask))
    ot = TL.attention(_t(q), _t(kp), _t(vp), _t(mask))
    clean = TL.attention(_t(q), _t(k), _t(v), _t(mask))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **F32_TOL)
    np.testing.assert_array_equal(ot.numpy(), clean.numpy())


def test_attention_causal_matches_jax(rng):
    q = rng.normal(size=(1, 12, 4, 8)).astype(np.float32)
    k = rng.normal(size=(1, 12, 2, 8)).astype(np.float32)
    v = rng.normal(size=(1, 12, 2, 8)).astype(np.float32)
    oj = JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=True)
    ot = TL.attention(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **F32_TOL)


def test_unported_site_configs_raise(rng):
    """Output quantizers raise. Calibration mode records the site's input
    into a Tape (the stats and the sample equal JAX's) and passes x through
    while the site has no calibrated scales."""
    st = TL.SiteSpec(w_bits=4, a_bits=8, out_bits=8)
    p = TK.quantize_weights_real(torch.randn(8, 4), 4)
    with pytest.raises(NotImplementedError):  # output quantizer
        TL.qlinear(torch.randn(2, 8), p, "s", st, None, "real")
    x = rng.normal(size=(2, 3, 8)).astype(np.float32)
    w = rng.normal(size=(8, 4)).astype(np.float32)
    kw = dict(w_bits=4, a_bits=8, a_static=True)
    tape_t, tape_j = TL.Tape(collect_samples=True), JL.Tape(
        collect_samples=True)
    yt = TL.qlinear(_t(x), {"w": _t(w)}, "s", TL.SiteSpec(**kw), None,
                    "calib", tape_t)
    yj = JL.qlinear(jnp.asarray(x), {"w": jnp.asarray(w)}, "s",
                    JL.SiteSpec(**kw), None, "calib", tape_j)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **F32_TOL)
    np.testing.assert_allclose(yt.numpy(), x @ w, **F32_TOL)  # passed through
    for f in ("min", "max", "n"):
        np.testing.assert_array_equal(getattr(tape_t.stats["s"], f).numpy(),
                                      np.asarray(getattr(tape_j.stats["s"], f)))
    np.testing.assert_array_equal(tape_t.samples["s"].numpy(),
                                  np.asarray(tape_j.samples["s"]))
