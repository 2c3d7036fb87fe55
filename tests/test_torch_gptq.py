"""The port's GPTQ (``mquant_tpu_torch.gptq``) against the JAX package's
on the same numpy inputs (f32, CPU).

Thresholds, from the agreement measured here:
* ``accumulate_hessian`` within f32 rel 1e-6 (measured ≤ 9e-7: the XᵀX
  sums run in other orders);
* ``_hinv_cholesky`` within rel 1e-4 (measured ≤ 5e-6: LAPACK's Cholesky
  and triangular inverse against JAX's blocked loops);
* the walk given JAX's U: ≥ 99.9% of the codes equal, each difference one
  code, the scales bit-equal (measured: every code and scale equal; the
  port divides by the format's range as JAX's jitted walk does);
* ``gptq_quantize_matrix`` end to end: the proxy loss tr(ΔWᵀ H ΔW) within
  1% of JAX's and below round-to-nearest's on the same H;
* ``gptq_quantize_decoder``: ≥ 99% of each site's codes equal (the next
  layer's inputs and Hessians carry the first layer's code differences).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mquant_tpu.core import quant as JQ
from mquant_tpu.core.formats import get_format as j_fmt
from mquant_tpu.gptq import core as JG
from mquant_tpu.gptq import driver as JD
from mquant_tpu.models import llm as JLLM
from mquant_tpu.models.layers import SiteSpec as JSpec
from mquant_tpu.transform import recipes as JR
from mquant_tpu_torch import interop
from mquant_tpu_torch.gptq import core as TG
from mquant_tpu_torch.gptq import driver as TD
from mquant_tpu_torch.models import llm as TLLM
from mquant_tpu_torch.models.layers import SiteSpec as TSpec

CASES = [(256, 64, {}), (256, 64, dict(act_order=True)),
         (256, 64, dict(sym=False)), (256, 64, dict(group_size=64)),
         (200, 48, dict(act_order=True, group_size=50)),
         (300, 96, {}),  # no multiple of the 128-row block
         (300, 96, dict(mse_clip=True))]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _problem(rng, n, out):
    W = (rng.normal(size=(n, out)) * 0.1).astype(np.float32)
    mix = rng.normal(size=(n, n)) * 0.1
    x = (rng.normal(size=(600, n)) @ mix).astype(np.float32)
    x[:, 3] *= 8.0  # one salient input
    return W, x


def _proxy(Wq, W, H):
    d = np.asarray(Wq, np.float64) - np.asarray(W, np.float64)
    return float(np.einsum("io,ij,jo->", d, np.asarray(H, np.float64), d))


def _codes(w, scale, zero=None):
    s = np.asarray(scale)
    s = np.repeat(s, w.shape[0] // s.shape[0], axis=0)
    q = np.round(np.asarray(w, np.float64) / s)
    return q if zero is None else q + np.repeat(np.asarray(zero),
                                                w.shape[0] // s.shape[0], 0)


@pytest.mark.parametrize("n,out,kw", CASES)
def test_hessian_factor_walk_match_jax(rng, n, out, kw):
    W, x = _problem(rng, n, out)
    Hj = np.asarray(JG.accumulate_hessian(None, jnp.asarray(x)))
    Ht = TG.accumulate_hessian(None, _t(x)).numpy()
    assert np.abs(Ht - Hj).max() <= 1e-6 * np.abs(Hj).max()
    perm = (np.argsort(-np.diag(Hj), kind="stable")
            if kw.get("act_order") else None)
    Hp = Hj if perm is None else Hj[perm][:, perm]
    Uj = np.asarray(JG._hinv_cholesky(jnp.asarray(Hp), 0.01))
    Ut = TG._hinv_cholesky(_t(Hp), 0.01).numpy()
    assert np.abs(Ut - Uj).max() <= 1e-4 * np.abs(Uj).max()
    if kw.get("mse_clip"):
        return  # the clip search's loss rounds otherwise: end to end below
    rj = JG.gptq_quantize_matrix(jnp.asarray(W), jnp.asarray(Hj), bits=4,
                                 **kw)
    rt = TG._gptq_walk(_t(W), _t(np.diag(Hp)), _t(Uj),
                       None if perm is None else _t(perm), bits=4,
                       group_size=kw.get("group_size"), mse_clip=False,
                       sym=kw.get("sym", True))
    np.testing.assert_array_equal(rt.scale.numpy(), np.asarray(rj.scale))
    if rj.zero is not None:
        np.testing.assert_array_equal(rt.zero.numpy(), np.asarray(rj.zero))
    w_j, w_t = np.asarray(rj.w), rt.w.numpy()
    if perm is not None:
        w_j, w_t = w_j[perm], w_t[perm]  # grouped grids index permuted rows
    cj = _codes(w_j, rj.scale, rj.zero)
    ct = _codes(w_t, rt.scale.numpy(), None if rt.zero is None
                else rt.zero.numpy())
    agree = (cj == ct).mean()
    assert agree >= 0.999, f"codes equal {agree:.5f}"
    assert np.abs(cj - ct).max() <= 1, "a code differs by more than one"


@pytest.mark.parametrize("n,out,kw", CASES)
def test_gptq_matrix_proxy_matches_jax(rng, n, out, kw):
    W, x = _problem(rng, n, out)
    H = np.asarray(JG.accumulate_hessian(None, jnp.asarray(x)))
    rj = JG.gptq_quantize_matrix(jnp.asarray(W), jnp.asarray(H), bits=4, **kw)
    rt = TG.gptq_quantize_matrix(_t(W), _t(H), bits=4, **kw)
    assert not bool(rt.used_fallback) and not bool(rj.used_fallback)
    assert (rt.perm is None) == (rj.perm is None)
    if rj.perm is not None:
        np.testing.assert_array_equal(rt.perm.numpy(), np.asarray(rj.perm))
    sym = kw.get("sym", True)
    fmt = j_fmt(4, signed=sym)
    qp = JQ.weight_qparams(jnp.asarray(W), fmt, per_channel=True,
                           symmetric=sym, mse_clip=kw.get("mse_clip", False))
    rtn = np.asarray(JQ.fake_quantize(jnp.asarray(W), qp, fmt))
    pj, pt, pr = (_proxy(rj.w, W, H), _proxy(rt.w.numpy(), W, H),
                  _proxy(rtn, W, H))
    assert abs(pt - pj) <= 0.01 * pj, (pt, pj)
    assert pt < pr, (pt, pr)


def test_failed_factorization_falls_back_to_rtn(rng):
    """A Hessian with a non-finite entry, and an indefinite one (a Gram
    matrix shifted by −3 · mean diag), fall back to round-to-nearest in
    both packages: equal weights and grids. Where the two part: −I (all
    pivots negative) fails the port's Cholesky, which falls back, while
    JAX's blocked Cholesky clamps each pivot at 1e-12 and walks finite
    weights on the clamped factor (ROADMAP C-w14). A singular Gram matrix
    (rank 1, undamped) factors in both: its f32 rounding leaves it
    numerically positive definite."""
    n, out = 64, 16
    W = rng.normal(size=(n, out)).astype(np.float32)
    fmt = j_fmt(4, signed=True)
    # round-to-nearest as JAX's jitted walk computes its fallback
    qp = jax.jit(lambda w: JQ.weight_qparams(w, fmt, per_channel=True))(
        jnp.asarray(W))
    rtn = np.asarray(jax.jit(lambda w, s: JQ.fake_quantize(
        w, JQ.QuantParams(s), fmt))(jnp.asarray(W), qp.scale))
    gram = np.array(JG.accumulate_hessian(None, jnp.asarray(
        rng.normal(size=(128, n)).astype(np.float32))))
    H_nan = gram.copy()
    H_nan[5, 7] = np.nan
    H_indef = gram - 3.0 * np.diag(gram).mean() * np.eye(n, dtype=np.float32)
    H_neg = -np.eye(n, dtype=np.float32)
    for H, jax_falls in ((H_nan, True), (H_indef, True), (H_neg, False)):
        rt = TG.gptq_quantize_matrix(_t(W), _t(H), bits=4, percdamp=0.0)
        assert bool(rt.used_fallback)
        np.testing.assert_array_equal(rt.w.numpy(), rtn)
        np.testing.assert_array_equal(rt.scale.numpy()[0],
                                      np.asarray(qp.scale).ravel())
        rj = JG.gptq_quantize_matrix(jnp.asarray(W), jnp.asarray(H), bits=4,
                                     percdamp=0.0)
        assert bool(rj.used_fallback) == jax_falls
        assert np.isfinite(np.asarray(rj.w)).all()
        if jax_falls:
            np.testing.assert_array_equal(np.asarray(rj.w), rtn)
    rank1 = np.asarray(JG.accumulate_hessian(None, jnp.ones((4, n),
                                                            jnp.float32)))
    rt = TG.gptq_quantize_matrix(_t(W), _t(rank1), bits=4, percdamp=0.0)
    rj = JG.gptq_quantize_matrix(jnp.asarray(W), jnp.asarray(rank1), bits=4,
                                 percdamp=0.0)
    assert not bool(rt.used_fallback) and not bool(rj.used_fallback)
    assert np.isfinite(rt.w.numpy()).all()


@pytest.fixture(scope="module")
def decoder():
    cfg_j = JLLM.DecoderConfig(vocab=97, hidden=64, n_layers=2, n_heads=4,
                               n_kv_heads=2, intermediate=128,
                               dtype=jnp.float32)
    d = {f.name: getattr(cfg_j, f.name)
         for f in dataclasses.fields(TLLM.DecoderConfig)}
    cfg_t = TLLM.DecoderConfig(**{**d, "dtype": torch.float32})
    params = JLLM.init_decoder_params(cfg_j, jax.random.key(0))
    fused = JR.fuse_decoder(cfg_j, params)
    rot, _ = JR.rotate_decoder(cfg_j, fused, jax.random.key(1),
                               online_had_down=True)
    pj = JR.split_decoder_down(rot)
    embeds = [np.asarray(params["embed"]["w"])[np.asarray(jax.random.randint(
        jax.random.key(10 + i), (2, 24), 0, 97))] for i in range(3)]
    kw = dict(w_bits=4, a_bits=8, a_static=True)
    specs = {f"llm.{s}": kw for s in JLLM.LLM_SITES}
    specs["llm.down"] = dict(kw, online_had="full", split=True)
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, pj=pj,
                pt=interop.to_torch(pj, device="cpu"), embeds=embeds,
                specs_j={k: JSpec(**v) for k, v in specs.items()},
                specs_t={k: TSpec(**v) for k, v in specs.items()})


@pytest.mark.parametrize("act_order", [False, True])
def test_gptq_decoder_matches_jax(decoder, act_order):
    """Both drivers on the same rotated, split tiny decoder and JAX's
    embeddings: per-site code agreement, the grids, ``w_col0`` untouched
    and float, no fallback."""
    d = decoder
    pj, rj = JD.gptq_quantize_decoder(
        d["cfg_j"], d["pj"], [jnp.asarray(e) for e in d["embeds"]],
        d["specs_j"], gcfg=JD.GPTQConfig(act_order=act_order))
    pt, rt = TD.gptq_quantize_decoder(
        d["cfg_t"], d["pt"], [_t(e) for e in d["embeds"]], d["specs_t"],
        gcfg=TD.GPTQConfig(act_order=act_order))
    assert rt["fallbacks"] == rj["fallbacks"] == []
    assert rt["sites"] == rj["sites"] == 14
    assert set(rt["seconds"]) == {"hessian", "factor", "walk"}
    lay_j, lay_t = pj["layers"], pt["layers"]
    np.testing.assert_array_equal(lay_t["down"]["w_col0"].numpy(),
                                  np.asarray(d["pj"]["layers"]["down"]
                                             ["w_col0"]))
    assert lay_t["down"]["w"].shape[-2] == d["cfg_t"].intermediate - 1
    for s in JLLM.LLM_SITES:
        sj, zj, _ = rj["qparams"][s]
        st, zt, _ = rt["qparams"][s]
        assert zj is None and zt is None
        assert tuple(st.shape) == sj.shape == (2, 1, lay_t[s]["w"].shape[-1])
        cj = np.round(np.asarray(lay_j[s]["w"], np.float64) / np.asarray(sj))
        ct = np.round(lay_t[s]["w"].double().numpy() / st.numpy())
        agree = (cj == ct).mean()
        assert agree >= 0.99, f"{s}: codes equal {agree:.5f}"
        # the grids the codes lie on are what realization reads
        np.testing.assert_array_equal(
            ct.astype(np.float32) * st.numpy(), lay_t[s]["w"].numpy())
