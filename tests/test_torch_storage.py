"""The storage configurations of the port's integer path (asymmetric and
grouped weight grids, act_order-permuted storage, asymmetric, per-group
and folded per-channel activations, output quantizers), against the JAX package on the same numpy inputs (CPU).

Bit-equal, as the JAX functions compute them on the CPU (the MSE clip
search, ROADMAP C-w17, is ``tests/test_torch_clip.py``'s):
* the int32 group accumulators and the group-blocked epilogue
  (``_grouped_epilogue``; XLA contracts its sums into FMAs, ``qmm.fma32``),
  for every combination of grouped weight scales, weight and activation
  zero points and per-group activation scales, both of the port's routes
  (one block-diagonal product at M ≤ 32, one product a group above);
* ``qlinear`` in real mode on each class of ``tests/test_realint_configs.py``
  and the realized storage leaves.
The decoder-level cases compare logits within DEC_RTOL of their largest
magnitude: the decoders' float ops (norms, RoPE, attention) round in other
orders in the two packages, as in ``tests/test_torch_slice.py``. The folded
``a_corr`` row is an f32 einsum in both packages (other summation orders):
within A_CORR_RTOL.
"""

import fractions
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mquant_tpu.core import quant as JQ
from mquant_tpu.core.formats import get_format as j_fmt
from mquant_tpu.gptq import core as JG
from mquant_tpu.kernels import qmm as JK
from mquant_tpu.models import layers as JL
from mquant_tpu.models import llm as JLLM
from mquant_tpu.transform import recipes as JR
from mquant_tpu_torch import interop
from mquant_tpu_torch import pipeline as TP
from mquant_tpu_torch.core import quant as TQ
from mquant_tpu_torch.kernels import qmm as TK
from mquant_tpu_torch.models import layers as TL
from mquant_tpu_torch.models import llm as TLLM
from mquant_tpu_torch.transform import recipes as TR

DEC_RTOL = 1e-5
A_CORR_RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _eq(t, j, what=""):
    t = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    j = np.asarray(j)
    j = j.astype(np.float32) if j.dtype.name == "bfloat16" else j
    assert t.shape == j.shape, (what, t.shape, j.shape)
    np.testing.assert_array_equal(t, j, err_msg=what)


# ---------------------------------------------------------------------------
# the group-blocked epilogue
# ---------------------------------------------------------------------------


def test_fma32_rounds_once():
    """``qmm.fma32`` against exact rational arithmetic on 4096 f32 triples
    (products near the sums' magnitude, cancellations, ties)."""
    rng = np.random.default_rng(1)
    a = (rng.standard_normal(4096) * 2.0 ** rng.integers(-20, 20, 4096)
         ).astype(np.float32)
    b = rng.standard_normal(4096).astype(np.float32)
    c = (-(a.astype(np.float64) * b) * (1 + rng.standard_normal(4096)
                                        * 1e-6)).astype(np.float32)
    c[:1024] = rng.standard_normal(1024).astype(np.float32)
    got = TK.fma32(_t(a), _t(b), _t(c)).numpy()
    for i in range(4096):
        exact = (fractions.Fraction(float(a[i])) * fractions.Fraction(
            float(b[i])) + fractions.Fraction(float(c[i])))
        want = np.float32(_round_f32(exact))
        assert got[i] == want, (i, a[i], b[i], c[i], got[i], want)


def _round_f32(x: fractions.Fraction) -> float:
    """Round a rational to the nearest f32, ties to even."""
    if x == 0:
        return 0.0
    sign = -1 if x < 0 else 1
    x = abs(x)
    e = math.floor(math.log2(x.numerator) - math.log2(x.denominator))
    while fractions.Fraction(2) ** e > x:
        e -= 1
    while fractions.Fraction(2) ** (e + 1) <= x:
        e += 1
    e = max(e, -126)
    q = x / fractions.Fraction(2) ** (e - 23)
    n = math.floor(q)
    r = q - n
    if r > fractions.Fraction(1, 2) or (r == fractions.Fraction(1, 2)
                                        and n % 2):
        n += 1
    return sign * float(fractions.Fraction(n) * fractions.Fraction(2) ** (
        e - 23))


EPI_CASES = [(gw, ags, wz, xz) for gw in (1, 4) for ags in (None, 64)
             for wz in (False, True) for xz in (False, True)
             if gw > 1 or ags or wz or xz]


def _epi_operands(rng, M, K, N, gw, ags, wz, xz):
    xq = rng.integers(-128, 128, (M, K)).astype(np.int8)
    w = rng.integers(-8, 8, (K, N)).astype(np.int8)
    ws = ((rng.random((gw, N)) + 0.5) * 0.01).astype(np.float32)
    ws = ws[0] if gw == 1 else ws
    ga = K // ags if ags else 1
    xs = ((rng.random((M, ga)) + 0.5) * 0.02).astype(np.float32)
    return (xq, xs, rng.integers(-20, 20, xs.shape).astype(np.float32)
            if xz else None, ags, w, ws,
            rng.integers(-8, 8, (gw, N)).astype(np.float32) if wz else None)


@pytest.mark.parametrize("route", ["blockdiag", "groups"])
@pytest.mark.parametrize("case", EPI_CASES)
def test_grouped_epilogue_bit_equal(case, route, monkeypatch):
    """``_grouped_epilogue`` against JAX's on M = 5 rows: f32 and bf16
    outputs bit-equal, on the route of one block-diagonal product (the
    card's at M ≤ 32, forced here) and the route of one product a group."""
    monkeypatch.setattr(TK, "_blockdiag_route",
                        lambda dev, M: route == "blockdiag")
    rng = np.random.default_rng(hash(case) % 2**32)
    ops = _epi_operands(rng, 5, 256, 48, *case)
    jops = [None if o is None else (jnp.asarray(o) if isinstance(
        o, np.ndarray) else o) for o in ops]
    tops = [None if o is None else (_t(o) if isinstance(o, np.ndarray)
                                    else o) for o in ops]
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        _eq(TK._grouped_epilogue(*tops, td),
            JK._grouped_epilogue(*jops, jd), f"{case} {jd}")


def test_group_accumulators_and_blockdiag_layout():
    """The block-diagonal x (row (m, g) = x[m]'s group g, a row of ones per
    group for Σw) gives every group's exact int32 accumulator and W's group
    sums in one product: equal to JAX's per-group int32 dots."""
    rng = np.random.default_rng(3)
    M, G, u, N = 3, 4, 32, 40
    xq = rng.integers(-128, 128, (M, G * u)).astype(np.int8)
    w = rng.integers(-128, 128, (G * u, N)).astype(np.int8)
    P, wsum = TK._blockdiag_partials(_t(xq), _t(w), G, ones=True)
    for g in range(G):
        sl = slice(g * u, (g + 1) * u)
        ref = jax.lax.dot_general(jnp.asarray(xq[:, sl]), jnp.asarray(w[sl]),
                                  (((1,), (0,)), ((), ())),
                                  preferred_element_type=jnp.int32)
        _eq(P[g], ref, f"group {g}")
        _eq(wsum[g], np.asarray(w[sl], np.int32).sum(0), f"wsum {g}")


# ---------------------------------------------------------------------------
# tests/test_realint_configs.py's classes
# ---------------------------------------------------------------------------


def _gptq_site(rng, In, Out, sym=True, group_size=None, bits=4,
               act_order=False):
    w = jnp.asarray(rng.normal(size=(In, Out)), jnp.float32) * 0.1
    xs = jnp.asarray(rng.normal(size=(64, In)) * rng.uniform(
        0.2, 3.0, size=(1, In)), jnp.float32)
    H = JG.accumulate_hessian(None, xs)
    return JG.gptq_quantize_matrix(w, H, bits=bits, sym=sym,
                                   group_size=group_size, act_order=act_order)


def _real_pair(res, bits=4, perm=None):
    """JAX's and the port's realized storage of a GPTQ result (permuted
    rows with ``a_perm`` when ``perm``); the leaves must be equal."""
    wj = res.w if perm is None else res.w[perm]
    pj = {"b": None, **JK.quantize_weights_real(
        wj, bits, pack=False, scale=res.scale, zero=res.zero)}
    pt = {"b": None, **TK.quantize_weights_real(
        _t(wj), bits, pack=False, scale=_t(res.scale),
        zero=None if res.zero is None else _t(res.zero))}
    if perm is not None:
        pj["a_perm"] = perm.astype(jnp.int32)
        pt["a_perm"] = _t(np.asarray(perm, np.int32))
    for k, v in pj.items():
        if v is not None:
            _eq(pt[k], v, k)
    return pj, pt


def _qlinear_pair(x, pj, pt, kw, state=None):
    st_j = st_t = None
    if state is not None:
        st_j = {"t.site": {"act": JQ.QuantParams(*[
            None if v is None else jnp.asarray(v) for v in state])}}
        st_t = {"t.site": {"act": TQ.QuantParams(*[
            None if v is None else _t(v) for v in state])}}
    yj = JL.qlinear(jnp.asarray(x), pj, "t.site", JL.SiteSpec(**kw), st_j,
                    mode="real")
    yt = TL.qlinear(_t(x), pt, "t.site", TL.SiteSpec(**kw), st_t,
                    mode="real")
    _eq(yt, yj, "qlinear real")


class TestAsymGroupedWeightRealize:
    @pytest.mark.parametrize("sym,group", [(False, None), (True, 32),
                                           (False, 32)])
    def test_realized_storage_and_forward_equal(self, rng, sym, group):
        """Storage (codes, 2-D scales, shifted zero points) and the real
        forward bit-equal to JAX's."""
        res = _gptq_site(rng, 64, 48, sym=sym, group_size=group)
        pj, pt = _real_pair(res)
        x = rng.normal(size=(8, 64)).astype(np.float32)
        _qlinear_pair(x, pj, pt, dict(w_bits=4, a_bits=8))


class TestActOrderGroupedRealize:
    @pytest.mark.parametrize("sym", [True, False])
    def test_matrix_level_equal(self, rng, sym):
        """Permuted storage with ``a_perm``: the gathered real forward
        bit-equal to JAX's, at 8 rows and at 40 (the two routes)."""
        res = _gptq_site(rng, 64, 48, sym=sym, group_size=16, act_order=True)
        pj, pt = _real_pair(res, perm=res.perm)
        for M in (8, 40):
            x = rng.normal(size=(M, 64)).astype(np.float32)
            _qlinear_pair(x, pj, pt, dict(w_bits=4, a_bits=8))

    def test_decoder_level(self, rng):
        """JAX's GPTQ driver (act_order × group 16) → each package's
        ``realize_decoder_weights`` on JAX's (L, G, out) grids and (L, in)
        perms: storage leaves bit-equal, real decoder logits within
        DEC_RTOL."""
        from mquant_tpu.gptq.driver import GPTQConfig, gptq_quantize_decoder

        cfg = JLLM.DecoderConfig(vocab=64, hidden=32, n_layers=2, n_heads=4,
                                 n_kv_heads=2, intermediate=64,
                                 dtype=jnp.float32)
        tcfg = TLLM.DecoderConfig(vocab=64, hidden=32, n_layers=2, n_heads=4,
                                  n_kv_heads=2, intermediate=64,
                                  dtype=torch.float32)
        params = JLLM.init_decoder_params(cfg, jax.random.key(0))
        specs_j = {f"llm.{n}": JL.SiteSpec(w_bits=4, a_bits=8)
                   for n in JLLM.LLM_SITES}
        specs_t = {k: TL.SiteSpec(w_bits=4, a_bits=8) for k in specs_j}
        embeds = [jax.random.normal(jax.random.key(1), (1, 16, 32),
                                    jnp.float32) * 0.1]
        qp, rep = gptq_quantize_decoder(
            cfg, params, embeds, specs_j,
            gcfg=GPTQConfig(act_order=True, group_size=16))
        rj = JR.realize_decoder_weights(qp, specs_j, qps=rep["qparams"])
        qps_t = {k: tuple(None if v is None else _t(v) for v in e)
                 for k, e in rep["qparams"].items()}
        rt = TR.realize_decoder_weights(interop.to_torch(qp, device="cpu"),
                                        specs_t, qps=qps_t)
        for n in JLLM.LLM_SITES:
            for k, v in rj["layers"][n].items():
                if v is not None:
                    _eq(rt["layers"][n][k], v, f"{n}.{k}")
        toks = np.asarray(jax.random.randint(jax.random.key(2), (2, 8), 0,
                                             cfg.vocab))
        lj = np.asarray(JLLM.decoder_forward(cfg, rj, jnp.asarray(toks),
                                             specs=specs_j, mode="real")[0])
        lt = TLLM.decoder_forward(tcfg, rt, _t(toks), specs=specs_t,
                                  mode="real")[0].numpy()
        np.testing.assert_allclose(lt, lj, rtol=0,
                                   atol=DEC_RTOL * np.abs(lj).max())


class TestAsymActivations:
    @pytest.mark.parametrize("per_token", [True, False])
    def test_dynamic_asym_equal(self, rng, per_token):
        w = rng.normal(size=(64, 48)).astype(np.float32) * 0.1
        wf = np.asarray(JQ.rtn_fake_quant_weight(jnp.asarray(w), 8))
        pj = {"b": None, **JK.quantize_weights_real(jnp.asarray(wf), 8,
                                                    pack=False)}
        pt = {"b": None, **TK.quantize_weights_real(_t(wf), 8, pack=False)}
        x = (rng.normal(size=(8, 64)) + 3.0).astype(np.float32)
        _qlinear_pair(x, pj, pt, dict(w_bits=8, a_bits=8, a_symmetric=False,
                                      a_per_token=per_token))

    @pytest.mark.parametrize("M", [8, 40])
    def test_static_asym_per_tensor_equal(self, rng, M):
        w = rng.normal(size=(64, 48)).astype(np.float32) * 0.1
        wf = np.asarray(JQ.rtn_fake_quant_weight(jnp.asarray(w), 4))
        pj = {"b": None, **JK.quantize_weights_real(jnp.asarray(wf), 4)}
        pt = {"b": None, **TK.quantize_weights_real(_t(wf), 4)}
        x = (rng.normal(size=(M, 64)) + 2.0).astype(np.float32)
        qp = JQ.scales_from_minmax(jnp.min(x), jnp.max(x),
                                   j_fmt(8, signed=False), symmetric=False)
        _qlinear_pair(x, pj, pt, dict(w_bits=4, a_bits=8, a_static=True,
                                      a_symmetric=False),
                      (np.asarray(qp.scale), np.asarray(qp.zero_point)))


class TestActGroupsize:
    @pytest.mark.parametrize("sym", [True, False])
    def test_a_groupsize_equal(self, rng, sym):
        w = rng.normal(size=(64, 48)).astype(np.float32) * 0.1
        wf = np.asarray(JQ.rtn_fake_quant_weight(jnp.asarray(w), 8))
        pj = {"b": None, **JK.quantize_weights_real(jnp.asarray(wf), 8,
                                                    pack=False)}
        pt = {"b": None, **TK.quantize_weights_real(_t(wf), 8, pack=False)}
        x = (rng.normal(size=(8, 64)) + (0.0 if sym else 1.5)).astype(
            np.float32)
        _qlinear_pair(x, pj, pt, dict(w_bits=8, a_bits=8, a_groupsize=16,
                                      a_symmetric=sym))

    def test_a_groupsize_with_grouped_weights(self, rng):
        res = _gptq_site(rng, 64, 48, sym=True, group_size=32)
        pj, pt = _real_pair(res)
        x = rng.normal(size=(8, 64)).astype(np.float32)
        _qlinear_pair(x, pj, pt, dict(w_bits=4, a_bits=8, a_groupsize=16))


class TestPerChannelStaticFold:
    @pytest.mark.parametrize("sym", [True, False])
    def test_fold_equal(self, rng, sym):
        """Per-channel static scales folded at realize time: each
        package's ``realize_decoder_weights`` on the same RTN weights and
        state gives the same ``w_q`` / ``w_scale`` / ``a_fold`` (and
        ``a_corr`` within A_CORR_RTOL); the real decoder logits within
        DEC_RTOL."""
        cfg = JLLM.DecoderConfig(vocab=64, hidden=32, n_layers=2, n_heads=4,
                                 n_kv_heads=4, intermediate=64,
                                 dtype=jnp.float32)
        tcfg = TLLM.DecoderConfig(vocab=64, hidden=32, n_layers=2, n_heads=4,
                                  n_kv_heads=4, intermediate=64,
                                  dtype=torch.float32)
        kw = dict(w_bits=8, a_bits=8, a_static=True, a_per_channel=True,
                  a_symmetric=sym)
        specs_j = {f"llm.{n}": JL.SiteSpec(**kw) for n in JLLM.LLM_SITES}
        specs_t = {k: TL.SiteSpec(**kw) for k in specs_j}
        params = JLLM.init_decoder_params(cfg, jax.random.key(0))
        params, qps = JR.rtn_quantize_decoder(cfg, params, specs_j,
                                              return_qparams=True)
        fmt = j_fmt(8, signed=sym)
        L = cfg.n_layers

        def mk(C):
            lo = rng.uniform(-0.4 if not sym else -2.0, 0.8, size=(L, C))
            hi = lo + rng.uniform(0.5, 2.0, size=(L, C))
            qp = JQ.scales_from_minmax(jnp.asarray(lo, jnp.float32),
                                       jnp.asarray(hi, jnp.float32), fmt,
                                       symmetric=sym)
            return qp

        shared = {"q": "qkv", "k": "qkv", "v": "qkv", "gate": "gu",
                  "up": "gu", "o": "o", "down": "down"}
        draws = {"qkv": mk(32), "gu": mk(32), "o": mk(32), "down": mk(64)}
        state_j = {f"llm.{n}": {"act": draws[shared[n]]}
                   for n in JLLM.LLM_SITES}
        state_t = {k: {"act": TQ.QuantParams(*[
            None if v is None else _t(v) for v in s["act"]])}
            for k, s in state_j.items()}
        rj = JR.realize_decoder_weights(params, specs_j, qps=qps,
                                        state=state_j)
        rt = TR.realize_decoder_weights(
            interop.to_torch(params, device="cpu"), specs_t,
            qps={k: tuple(None if v is None else _t(v) for v in e)
                 for k, e in qps.items()}, state=state_t)
        for n in JLLM.LLM_SITES:
            for k, v in rj["layers"][n].items():
                if v is None:
                    continue
                if k == "a_corr":
                    np.testing.assert_allclose(
                        rt["layers"][n][k].numpy(), np.asarray(v), rtol=0,
                        atol=A_CORR_RTOL * np.abs(np.asarray(v)).max())
                else:
                    _eq(rt["layers"][n][k], v, f"{n}.{k}")
            assert ("a_corr" in rt["layers"][n]) == (not sym)
        toks = np.asarray(jax.random.randint(jax.random.key(1), (2, 8), 0,
                                             cfg.vocab))
        lj = np.asarray(JLLM.decoder_forward(
            cfg, rj, jnp.asarray(toks), specs=specs_j, state=state_j,
            mode="real")[0])
        lt = TLLM.decoder_forward(tcfg, rt, _t(toks), specs=specs_t,
                                  state=state_t, mode="real")[0].numpy()
        np.testing.assert_allclose(lt, lj, rtol=0,
                                   atol=DEC_RTOL * np.abs(lj).max())


# ---------------------------------------------------------------------------
# the pipeline's refusals
# ---------------------------------------------------------------------------


# (storage, SiteSpec fields, the route): the sites the group-blocked
# epilogue serves, and those the per-channel kernels do
ROUTES = [
    ("per-channel", dict(a_static=True), False),
    ("w_zp", dict(a_static=True), True),
    ("grouped", dict(a_static=True), True),
    ("a_perm", dict(a_static=True), False),
    ("per-channel", dict(a_static=True, a_symmetric=False), True),
    ("per-channel", dict(a_symmetric=False), True),
    ("per-channel", dict(a_groupsize=16), True),
    ("fold", dict(a_static=True, a_per_channel=True, a_symmetric=False),
     False),
]


@pytest.mark.parametrize("storage,kw,grouped", ROUTES)
def test_grouped_route_ahead_equals_at_call(storage, kw, grouped):
    """``qmm.grouped_route`` read ahead from a stacked site and its spec (as
    ``prepare_w4_resident`` keeps such sites unpacked) gives the route that
    ``quantized_matmul_pre`` takes on one layer's site and the activation
    ``_act_int8`` returns."""
    K, N = 64, 24
    g = torch.Generator().manual_seed(0)
    p = {"w_q": torch.randint(-8, 8, (K, N), dtype=torch.int8,
                              generator=g),
         "w_scale": torch.rand(N, generator=g) + 0.1, "b": None}
    st = TQ.QuantParams(torch.tensor(0.05), None)
    if storage == "w_zp":
        p["w_scale"] = p["w_scale"][None]
        p["w_zp"] = torch.ones((1, N))
    elif storage == "grouped":
        p["w_scale"] = torch.rand((4, N), generator=g) + 0.1
    elif storage == "a_perm":
        p["a_perm"] = torch.randperm(K, generator=g).int()
    elif storage == "fold":
        p["a_fold"] = torch.ones(())
        p["a_corr"] = torch.zeros(N)
        st = TQ.QuantParams(torch.full((K,), 0.05), torch.full((K,), 130.))
    if kw.get("a_static") and not kw.get("a_symmetric", True) and \
            storage != "fold":
        st = TQ.QuantParams(torch.tensor(0.05), torch.tensor(130.))
    spec = TL.SiteSpec(w_bits=4, a_bits=8, **kw)
    aq = TK._act_int8(torch.randn((3, K), generator=g), spec, {"act": st},
                      p)
    stacked = {k: v if v is None or k == "a_fold" else v[None]
               for k, v in p.items()}
    assert TK.grouped_route(p, x_zp=aq.zp, a_groupsize=aq.groupsize) \
        == TK.grouped_route(stacked, spec) == grouped


@pytest.mark.parametrize("kw", [
    dict(kv_bits=8), dict(kv_bits=4), dict(w_asym=True),
    dict(w_groupsize=64), dict(a_asym=True), dict(act_per_tensor=False),
    dict(a_groupsize=32)])
def test_check_ported_takes_storage_values(kw):
    """Every A4, A1 and A5 value of the QuantizeConfig passes
    ``check_ported`` (what still raises: ``test_torch_pipeline.py``)."""
    TP.check_ported(TP.QuantizeConfig(**kw))


def test_out_bits_calibrated_state_equals_jax(rng):
    """``finalize_state`` of an output quantizer's ``#out`` stats: the
    site's "out" params equal JAX's, beside its "act" params."""
    from mquant_tpu.calib import calibrate as JCal
    from mquant_tpu.observe import observers as JO
    from mquant_tpu_torch.calib import calibrate as TCal
    from mquant_tpu_torch.observe import observers as TO

    kw = dict(w_bits=8, a_bits=8, a_static=True, out_bits=8,
              a_symmetric=False)
    sj, st = {"s": JL.SiteSpec(**kw)}, {"s": TL.SiteSpec(**kw)}
    stats = {}
    for name, arr in (("s", rng.normal(size=(3,))), ("s#out",
                                                     rng.normal(size=(3,)))):
        lo, hi = np.float32(arr.min()), np.float32(arr.max() + 1)
        stats[name] = (lo, hi, np.float32(5))
    jstate = JCal.finalize_state(sj, {k: JO.ObserverStats(*map(
        jnp.asarray, v)) for k, v in stats.items()})
    tstate = TCal.finalize_state(st, {k: TO.ObserverStats(*map(
        torch.tensor, v)) for k, v in stats.items()})
    assert set(tstate["s"]) == set(jstate["s"]) == {"act", "out"}
    for key in ("act", "out"):
        _eq(tstate["s"][key].scale, jstate["s"][key].scale, key)
        _eq(tstate["s"][key].zero_point, jstate["s"][key].zero_point, key)
