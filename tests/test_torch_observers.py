"""The port's observers and calibration reductions
(``mquant_tpu_torch.observe.observers``, ``calib.calibrate``) against the
JAX package's on the same numpy samples (f32, CPU).

Tolerances: minmax bit-equal (min / max / compare / one division); the
other kinds within f32 rel 1e-6 (ema's blend, the quantiles' interpolation,
the shrink search's loss sums round in other orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mquant_tpu.calib import calibrate as JC
from mquant_tpu.core.formats import get_format as j_fmt
from mquant_tpu.models.layers import SiteSpec as JSpec
from mquant_tpu.observe import observers as JO
from mquant_tpu_torch.calib import calibrate as TC
from mquant_tpu_torch.core.formats import get_format as t_fmt
from mquant_tpu_torch.models.layers import SiteSpec as TSpec
from mquant_tpu_torch.observe import observers as TO

REL = 1e-6
KINDS = [("minmax", False, True), ("minmax", True, True),
         ("minmax", False, False), ("ema", False, True), ("ema", True, False),
         ("percentile", False, True), ("percentile", False, False),
         ("omse", False, True), ("omse", True, False), ("omse", False, False),
         ("ptf", True, False)]


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _close(t, j, kind, what):
    j = np.asarray(j)
    t = t.numpy()
    assert t.shape == j.shape, what
    if kind == "minmax":
        np.testing.assert_array_equal(t, j, err_msg=what)
    else:
        np.testing.assert_allclose(t, j, rtol=REL, atol=0, err_msg=what)


def _samples(rng, n=4):
    # (B, T, C) activations with a few outlier channels and a shifted mean
    xs = []
    for i in range(n):
        x = rng.normal(size=(2, 24, 16)).astype(np.float32) + 0.3 * i
        x[..., 3] *= 6.0
        xs.append(x)
    return xs


def _fold(O, spec, xs, conv, mask=None):
    st = O.init_stats(spec, 16 if spec.per_channel else None,
                      **({} if O is JO else {"device": "cpu"}))
    for x in xs:
        st = O.update(spec, st, conv(x), mask=None if mask is None
                      else conv(mask))
    return st


@pytest.mark.parametrize("kind,per_channel,sym", KINDS)
def test_update_merge_finalize_match_jax(rng, kind, per_channel, sym):
    """update over four batches, the masked update (padded tokens out),
    merge of two running stats, finalize (omse / ptf on the last batch)."""
    js = JO.ObserverSpec(kind=kind, per_channel=per_channel, symmetric=sym)
    ts = TO.ObserverSpec(kind=kind, per_channel=per_channel, symmetric=sym)
    xs = _samples(rng)
    mask = (rng.random((2, 24)) > 0.3).astype(np.float32)
    for m in (None, mask):
        sj = _fold(JO, js, xs, jnp.asarray, m)
        st = _fold(TO, ts, xs, _t, m)
        for f in ("min", "max", "n"):
            _close(getattr(st, f), getattr(sj, f), kind, f"{f} mask={m is not None}")
    a_j, a_t = _fold(JO, js, xs[:2], jnp.asarray), _fold(TO, ts, xs[:2], _t)
    b_j, b_t = _fold(JO, js, xs[2:], jnp.asarray), _fold(TO, ts, xs[2:], _t)
    mj, mt = JO.merge(js, a_j, b_j), TO.merge(ts, a_t, b_t)
    for f in ("min", "max", "n"):
        _close(getattr(mt, f), getattr(mj, f), kind, f"merge {f}")
    fmt_j, fmt_t = j_fmt(8, signed=sym), t_fmt(8, signed=sym)
    sample = xs[-1].reshape(-1, 16)
    qj = JO.finalize(js, mj, fmt_j, jnp.asarray(sample))
    qt = TO.finalize(ts, mt, fmt_t, _t(sample))
    _close(qt.scale, qj.scale, kind, "scale")
    assert (qt.zero_point is None) == (qj.zero_point is None)
    if qj.zero_point is not None:
        _close(qt.zero_point, qj.zero_point, kind, "zero_point")


def test_finalize_needs_sample_and_spec_checks():
    with pytest.raises(ValueError):
        TO.ObserverSpec(kind="percentile", per_channel=True)
    with pytest.raises(ValueError):
        TO.ObserverSpec(kind="nope")
    st = TO.init_stats(TO.ObserverSpec("omse"), device="cpu")
    with pytest.raises(ValueError):
        TO.finalize(TO.ObserverSpec("omse"), st, t_fmt(8))


@pytest.mark.parametrize("observer", ["minmax", "ema", "omse"])
def test_calibrate_stacked_matches_jax(rng, observer):
    """``calibrate``'s merge over batches and ``finalize_state`` on
    layer-stacked stats (L = 3) and an unstacked site, through a forward
    stub that records with each package's Tape."""
    from mquant_tpu.models.layers import Tape as JTape
    from mquant_tpu_torch.models.layers import Tape as TTape

    specs_j = {n: JSpec(a_bits=8, a_static=True, observer=observer)
               for n in ("llm.q", "vis.patch_embed")}
    specs_t = {n: TSpec(a_bits=8, a_static=True, observer=observer)
               for n in ("llm.q", "vis.patch_embed")}
    batches = [(rng.normal(size=(3, 2, 8, 16)).astype(np.float32)
                * (1 + i),) for i in range(3)]

    def fwd(Tape, conv, stack, specs):
        def f(x, collect_samples=False):
            tapes = []
            for layer in x:
                tp = Tape(collect_samples=collect_samples)
                tp.record("llm.q", conv(layer), specs["llm.q"])
                tapes.append(tp)
            t0 = Tape(collect_samples=collect_samples)
            t0.record("vis.patch_embed", conv(x[0]), specs["vis.patch_embed"])
            stats = {"llm.q": type(tapes[0].stats["llm.q"])(*(
                stack([tp.stats["llm.q"][i] for tp in tapes])
                for i in range(3))), **t0.stats}
            samples = {}
            if collect_samples:
                samples = {"llm.q": stack([tp.samples["llm.q"]
                                           for tp in tapes]), **t0.samples}
            return None, (stats, samples)
        return f

    sj = JC.calibrate(fwd(JTape, jnp.asarray, jnp.stack, specs_j), batches,
                      specs_j)
    st = TC.calibrate(fwd(TTape, _t, torch.stack, specs_t), batches, specs_t)
    assert set(st) == set(sj)
    kind = "minmax" if observer == "minmax" else "other"
    for name in sj:
        _close(st[name]["act"].scale, sj[name]["act"].scale, kind, name)
