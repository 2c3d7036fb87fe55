"""The pipeline's gates in the port against the JAX package's, on the same
numpy-drawn inputs at tiny widths (f32, CPU): SmoothQuant migration
(``transform/smooth.py``), sensitivity-based mixed bits and the lm_head
gate (``utils/autobits.py``), the online-Hadamard gate
(``pipeline._choose_online_had_mode``) and the diagnostics' reports.

* Smoothing: ``smooth_scales`` / ``smooth_decoder`` bit-equal given the same
  amax, in f32 and bf16 (float64 arithmetic; the products and quotients
  are exactly rounded on any device, the powers numpy's on the host); the
  float forward kept. The collected amax within 16 f32 ulps of JAX's
  (measured ≤ 11): the image rows reach even the first layer through the
  float ViT and merger, whose f32 sums run in other orders; a text row
  alone would give one ulp.
* Auto bits: ``allocate_bits`` equal on the same inputs; sensitivities
  within 1e-4 relative (measured ≤ 5e-6); equal allocations on a batch
  whose candidates' sensitivities per element stand apart (neighbours in
  the knapsack's order ≥ 1% apart, asserted).
* The head gate: ratios within 1e-4 relative and their excess over 1
  within 1e-2 relative (measured 8e-4); the same pick at gates on either
  side of the W4 ratio.
* The Hadamard gate: the same pick, on the two adversarial patterns of
  ``tests/test_outlier_stress.py`` (spikes within one 128-block: full; a
  dense single block: block), the errors within 1e-4 relative except the
  dense pattern's full candidate, within 5e-4 (measured 1.01e-4: its error
  is 20× the signal, and the f32 sums' order flips the rounding of a few
  int8 / int4 codes; 6e-5 with JAX's captured inputs fed to the port).
* Diagnostics: the config report's and the activation summary's text
  equal to JAX's on the same specs, state and samples; the error report
  within 1e-4 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mquant_tpu import pipeline as JP
from mquant_tpu.models.registry import get_family as j_family
from mquant_tpu.transform import smooth as JS
from mquant_tpu.utils import autobits as JA
from mquant_tpu.utils import diagnostics as JDG
from mquant_tpu_torch import interop
from mquant_tpu_torch import pipeline as TP
from mquant_tpu_torch.models.qwen2vl import Qwen2VLConfig
from mquant_tpu_torch.transform import smooth as TS
from mquant_tpu_torch.utils import autobits as TA
from mquant_tpu_torch.utils import diagnostics as TDG

REL = 1e-4


def _cfgs(**llm):
    fam = j_family("qwen2vl")
    jc = fam.tiny_fn()
    tc = Qwen2VLConfig.tiny()
    if llm:
        jc = dataclasses.replace(jc, llm=dataclasses.replace(jc.llm, **llm))
        tc = dataclasses.replace(tc, llm=dataclasses.replace(tc.llm, **llm))
    return fam, jc, tc


def _batches(fam, jc, n, seed):
    jb = JP.synthetic_calib_batches(fam, jc, n, jax.random.key(seed))
    return jb, [interop.to_torch(b, device="cpu") for b in jb]


@pytest.fixture(scope="module")
def tiny():
    fam, jc, tc = _cfgs()
    pj = fam.init_fn(jc, jax.random.key(0))
    jb, tb = _batches(fam, jc, 2, 5)
    return fam, jc, tc, pj, interop.to_torch(pj, device="cpu"), jb, tb


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16).numpy() if x.dtype == torch.bfloat16
                else x.numpy())
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


# --- smoothing --------------------------------------------------------------


def _amax(rng, L, H):
    return {k: np.abs(rng.normal(size=(L, H))) * rng.choice(
        [1.0, 30.0], size=(L, H), p=[0.9, 0.1]) for k in ("attn", "mlp")}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_smooth_decoder_bit_equal(tiny, dtype):
    fam, jc, tc, pj, pt, _, _ = tiny
    dj, dt = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    llm_j = jax.tree.map(lambda x: x.astype(dj), pj["llm"])
    llm_t = interop.to_torch(jax.tree.map(np.asarray, llm_j), device="cpu")
    amax = _amax(np.random.default_rng(1), jc.llm.n_layers, jc.llm.hidden)
    for key, sites in (("attn", ("q", "k", "v")), ("mlp", ("gate", "up"))):
        sj = JS.smooth_scales(amax[key], [llm_j["layers"][n]["w"]
                                          for n in sites], 0.5)
        st = TS.smooth_scales(amax[key], [llm_t["layers"][n]["w"]
                                          for n in sites], 0.5)
        np.testing.assert_array_equal(st, sj)
    oj = JS.smooth_decoder(llm_j, amax, 0.5)
    ot = TS.smooth_decoder(llm_t, amax, 0.5)
    for n in ("ln1", "ln2", "q", "k", "v", "gate", "up"):
        a, b = _np(oj["layers"][n]["w"]), _np(ot["layers"][n]["w"])
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a, err_msg=n)
    assert ot["layers"]["o"]["w"] is llm_t["layers"]["o"]["w"]


def test_collected_amax_and_fp_preserved(tiny):
    from mquant_tpu_torch.models.qwen2vl import qwen2vl_forward

    fam, jc, tc, pj, pt, jb, tb = tiny
    aj = JS.collect_llm_channel_amax(fam, jc, pj, jb)
    at = TS.collect_llm_channel_amax(tc, pt, tb)
    for k in aj:
        sj = (aj[k] / 127).astype(np.float32)
        st = (at[k] / 127).astype(np.float32)
        ulp = np.spacing(np.maximum(np.abs(sj), np.abs(st)))
        assert (np.abs(st - sj) <= 16 * ulp).all(), k
    sm = {**pt, "llm": TS.smooth_decoder(pt["llm"], at, 0.5)}
    b = tb[0]
    with torch.no_grad():
        ref, _, _ = qwen2vl_forward(tc, pt, b["tokens"], b["patches"],
                                    grid_hw=b["grid_hw"])
        out, _, _ = qwen2vl_forward(tc, sm, b["tokens"], b["patches"],
                                    grid_hw=b["grid_hw"])
    assert not torch.equal(sm["llm"]["layers"]["q"]["w"],
                           pt["llm"]["layers"]["q"]["w"])
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-4,
                               atol=2e-4)


# --- auto bits and the head gate --------------------------------------------


def test_allocate_bits_equal():
    rng = np.random.default_rng(2)
    names = [f"llm.s{i}" for i in range(12)]
    sens = {n: float(rng.random()) for n in names}
    elems = {n: int(rng.integers(100, 10_000)) for n in names}
    elems["llm.s3"] = elems["llm.s4"]
    sens["llm.s3"] = sens["llm.s4"]  # a tie: the same stable order
    for target in (3.0, 4.0, 4.5, 5.0, 6.5, 8.0, 9.0):
        for low, high in ((4, 8), (2, 4)):
            assert TA.allocate_bits(sens, elems, target, low, high) == \
                JA.allocate_bits(sens, elems, target, low, high)


def _specs_pair(**kw):
    qj = JP.QuantizeConfig(rotate=False, lm_head_bits=4, **kw)
    qt = TP.QuantizeConfig(rotate=False, lm_head_bits=4, **kw)
    return JP.build_specs(j_family("qwen2vl"), qj), TP.build_specs(qt)


def test_sensitivities_and_allocation(tiny):
    fam, jc, tc, pj, pt, _, _ = tiny
    jb, tb = _batches(fam, jc, 1, 8)
    sj_specs, st_specs = _specs_pair()
    sj = JA.site_sensitivities(fam, jc, pj, sj_specs, jb[0])
    with torch.no_grad():
        st = TA.site_sensitivities(tc, pt, st_specs, tb[0])
    assert set(st) == set(sj) and len(sj) == 17
    for k in sj:
        assert abs(st[k] - sj[k]) <= REL * sj[k], (k, st[k], sj[k])
    elems = TA.site_weight_elems(pt, st_specs)
    assert elems == JA.site_weight_elems(pj, sj_specs)
    # candidates stand apart: neighbours in the knapsack's order
    order = sorted(sj, key=lambda n: sj[n] / elems[n], reverse=True)
    dens = [sj[n] / elems[n] for n in order]
    assert all(a > b * 1.01 for a, b in zip(dens, dens[1:]))
    for target in (4.5, 5.0, 6.0):
        bj = JA.allocate_bits(sj, elems, target)
        assert TA.allocate_bits(st, elems, target) == bj
        assert 4 in bj.values() and 8 in bj.values()
    bj = JA.allocate_bits(sj, elems, 5.0)
    with torch.no_grad():
        nt, _, bt = TA.autobits_specs(tc, pt, st_specs, tb[0], 5.0)
    assert bt == bj
    assert {k: v.w_bits for k, v in nt.items()} == {
        k: bj.get(k, v.w_bits) for k, v in st_specs.items()}
    assert TA.allocation_report(sj, elems, bj) == JA.allocation_report(
        sj, elems, bj)
    rj = JA.rtn_apply_bits(pj, bj)
    rt = TA.rtn_apply_bits(pt, bt)
    for top, sub, site in (("llm", "layers", "q"), ("vit", "blocks", "fc1"),
                           ("merger", None, "mlp0")):
        node_j = rj[top][sub] if sub else rj[top]
        node_t = rt[top][sub] if sub else rt[top]
        np.testing.assert_array_equal(_np(node_t[site]["w"]),
                                      _np(node_j[site]["w"]))


def test_head_gate(tiny):
    fam, jc, tc, pj, pt, jb, tb = tiny
    sj_specs, st_specs = _specs_pair()
    bj, rj = JA.decide_head_bits(fam, jc, pj, sj_specs, jb[0])
    with torch.no_grad():
        bt, rt = TA.decide_head_bits(tc, pt, st_specs, tb[0])
    for b in (4, 8):
        assert abs(rt[b] - rj[b]) <= REL * rj[b], (b, rt, rj)
        assert abs(rt[b] - rj[b]) <= 1e-2 * (rj[b] - 1), (b, rt, rj)
    assert bt == bj
    for gate, want in ((1 + (rj[4] - 1) / 2, 8), (rj[4] + 0.01, 4)):
        assert JA.decide_head_bits(fam, jc, pj, sj_specs, jb[0],
                                   gate=gate)[0] == want
        with torch.no_grad():
            assert TA.decide_head_bits(tc, pt, st_specs, tb[0],
                                       gate=gate)[0] == want


# --- the online-Hadamard gate -----------------------------------------------


def _inject(params, channels, mags):
    """up[:, :, c] *= m, down[:, c, :] /= m: the float function kept, the
    down inputs spiked (tests/test_outlier_stress.py's construction)."""
    s = np.ones((params["llm"]["layers"]["up"]["w"].shape[-1],), np.float32)
    for c, m in zip(channels, mags):
        s[c] = m
    lay = dict(params["llm"]["layers"])
    lay["up"] = dict(lay["up"], w=lay["up"]["w"] * jnp.asarray(s)[None, None])
    lay["down"] = dict(lay["down"],
                       w=lay["down"]["w"] / jnp.asarray(s)[None, :, None])
    return {**params, "llm": {**params["llm"], "layers": lay}}


@pytest.mark.parametrize("pattern,want", [("inblock", "full"),
                                          ("dense", "block")])
def test_hadamard_gate(pattern, want):
    fam, jc, tc = _cfgs(n_layers=4, intermediate=512)
    params = fam.init_fn(jc, jax.random.key(0))
    rng = np.random.default_rng(3)
    b0, mag = 128, 300.0
    if pattern == "inblock":
        ch = list(b0 + rng.choice(128, 8, replace=False))
        pj = _inject(params, ch, [mag * s for s in rng.choice([-1, 1], 8)])
    else:
        rng.choice(128, 8, replace=False), rng.choice([-1, 1], 8)
        pj = _inject(params, list(range(b0, b0 + 128)),
                     list(mag / 4 * rng.choice([-1.0, 1.0], 128)))
    jb, tb = _batches(fam, jc, 1, 5)
    pick_j, ej = JP._choose_online_had_mode(fam, jc, pj, jb[0])
    with torch.no_grad():
        pick_t, et = TP._choose_online_had_mode(
            tc, interop.to_torch(pj, device="cpu"), tb[0])
    assert pick_j == pick_t == want
    assert set(et) == set(ej) == {"full", "block"}
    for k in ej:
        tol = 5e-4 if (pattern, k) == ("dense", "full") else REL
        assert abs(et[k] - ej[k]) <= tol * ej[k], (k, et, ej)
    lo, hi = sorted(ej.values())
    assert hi > lo * (1 + 100 * REL)


# --- diagnostics --------------------------------------------------------------


def test_diagnostics_reports(tiny):
    from mquant_tpu_torch.models.qwen2vl import qwen2vl_forward

    fam, jc, tc, pj, pt, jb, tb = tiny
    sj_specs, st_specs = _specs_pair()
    sj_specs = {k: v for k, v in sj_specs.items() if k != "llm.lm_head"}
    st_specs = {k: v for k, v in st_specs.items() if k != "llm.lm_head"}
    state_j = JP.calibrate_activations(fam, jc, pj, sj_specs, jb)
    state_t = interop.to_torch(jax.tree.map(np.asarray, state_j),
                               device="cpu")
    assert TDG.quant_config_report(st_specs, state_t) == \
        JDG.quant_config_report(sj_specs, state_j)
    assert TDG.quant_config_report(st_specs) == JDG.quant_config_report(
        sj_specs)

    def fwd(b, collect_samples=False):
        logits, _, st = qwen2vl_forward(tc, pt, b["tokens"], b["patches"],
                                        grid_hw=b["grid_hw"], specs=st_specs,
                                        mode="calib", collect_stats=True,
                                        collect_samples=collect_samples)
        return logits, st

    def jfwd(b, collect_samples=False):
        logits, _, st = fam.forward_fn(jc, pj, b["tokens"], b["patches"],
                                       specs=sj_specs, mode="calib",
                                       collect_stats=True,
                                       collect_samples=collect_samples,
                                       grid_hw=b["grid_hw"])
        return logits, st

    with torch.no_grad():
        smp_t = TDG.capture_activations(fwd, tb[0])
    smp_j = JDG.capture_activations(jfwd, jb[0])
    assert set(smp_t) == set(smp_j) and smp_t["llm.q"].ndim == 3
    assert TDG.activation_summary(smp_j) == JDG.activation_summary(smp_j)
    assert TDG.activation_summary(smp_t).splitlines()[0] == \
        JDG.activation_summary(smp_j).splitlines()[0]
    q = JP.QuantizeConfig(rotate=False, llm_w_rtn=True, llm_w_bits=3)
    pqj, _ = JP.quantize_weights(fam, jc, pj, sj_specs, q, None)
    pqt = interop.to_torch(jax.tree.map(np.asarray, pqj), device="cpu")
    rj = JDG.quant_error_report(fam, jc, pj, pqj, jb[0], sj_specs, state_j)
    with torch.no_grad():
        rt = TDG.quant_error_report(tc, pt, pqt, tb[0], st_specs, state_t)
    assert set(rt) == {"visual_only", "llm_only", "all"}
    for k in rj:
        assert abs(rt[k] - rj[k]) <= REL * rj[k], (k, rt, rj)


def test_misc_utilities(tmp_path):
    """``utils/misc.py``: the seeded generator, the log file, the memory
    report without a card, the profiler trace and the step timer."""
    import logging

    from mquant_tpu_torch.utils import misc

    g = misc.seed_everything(3)
    assert isinstance(g, torch.Generator) and g.initial_seed() == 3
    a = torch.rand(4, generator=g)
    assert torch.equal(a, torch.rand(4, generator=misc.seed_everything(3)))
    log = misc.config_logging(str(tmp_path / "logs" / "run.log"))
    log.info("hello")
    logging.getLogger("mquant_tpu_torch.pipeline").info("world")
    for h in logging.getLogger().handlers:
        h.flush()
    text = (tmp_path / "logs" / "run.log").read_text()
    assert "hello" in text and "world" in text
    assert misc.device_memory_stats() == {}
    assert misc.cleanup_memory(log) == {}
    with misc.profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(8) @ torch.ones(8)
    assert (tmp_path / "trace" / "trace.json").exists() and prof is not None
    t = misc.Timer()
    for _ in range(3):
        with t("step", sync="cpu"):
            pass
    assert len(t.times["step"]) == 3 and t.report().startswith("step: n=3")
    logging.basicConfig(force=True)
