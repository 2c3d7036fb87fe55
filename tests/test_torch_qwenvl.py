"""The port's Qwen-VL family (``mquant_tpu_torch.models.{qwenvl,resampler,
vision}``, the family's branches of ``transform.vlm_recipes`` and
``gptq.modules``, the registry and the config codec) against the JAX
package's at ``QwenVLConfig.tiny()`` (f32, CPU), on the same numpy-drawn
inputs and JAX-initialized params handed to the port through
``interop.to_torch``. The params are "spiced": non-unit norms with biases
(ln_pre, ln_post, the resampler's ln_q / ln_kv / ln_post) and random
biases, so each fold and rotation is exercised.

The HF checkpoint loader ``load_qwenvl`` is held bit-equal to JAX's
loader on a checkpoint whose heads, q / k / v thirds and ``w1`` / ``w2``
all differ. Also held here: the pieces of the path no served model ran
before: the
order-172 Hadamard block (Qwen-VL-Chat's intermediate 11008 = 172 · 64)
and ``online_hadamard`` over it, and the decoder at G = 1 (32 / 32 heads
at full size) with dynamic NTK past a short ``ntk_seq_length``.

Tolerances, each the JAX tests' own: patches, the 172 block and integer
codes bit-equal; bf16 Hadamard products bit-equal, f32 ones within 1e-6 of
the largest magnitude (172-term sums in each package's order); f32
forwards within 1e-5 of the largest magnitude
(``tests/test_torch_slice.py``'s rule); static activation stats within rel
1e-5; transformed trees within one ulp of each leaf
(``tests/test_torch_transforms.py``'s rule); the fused-and-rotated
forward against the fused one within 5e-3 (``tests/test_torch_glm4v.py``'s
rule).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mquant_tpu.calib import calibrate as JCAL
from mquant_tpu.gptq import core as JG
from mquant_tpu.gptq import modules as JGM
from mquant_tpu.kernels import fwht as JF
from mquant_tpu.models import llm as JLLM
from mquant_tpu.models import loader as JL
from mquant_tpu.models import qwenvl as JQ
from mquant_tpu.models import resampler as JR
from mquant_tpu.models import vision as JV
from mquant_tpu.models.layers import SiteSpec as JSpec
from mquant_tpu.models.registry import get_family as j_family
from mquant_tpu.serve.generate import Generator as JGenerator
from mquant_tpu.transform import hadamard as JH
from mquant_tpu.transform import vlm_recipes as JVR
from mquant_tpu.utils import checkpoint as JC
from mquant_tpu_torch import interop
from mquant_tpu_torch.calib import calibrate as TCAL
from mquant_tpu_torch.gptq import core as TG
from mquant_tpu_torch.gptq import modules as TGM
from mquant_tpu_torch.kernels import fwht as TF
from mquant_tpu_torch.models import llm as TLLM
from mquant_tpu_torch.models import loader as TL
from mquant_tpu_torch.models import layers as TLy
from mquant_tpu_torch.models import qwenvl as TQ
from mquant_tpu_torch.models import resampler as TR
from mquant_tpu_torch.models import vision as TV
from mquant_tpu_torch.models.layers import SiteSpec as TSpec
from mquant_tpu_torch.models.registry import SUPPORTED_MODELS, family_of
from mquant_tpu_torch.models.registry import get_family as t_family
from mquant_tpu_torch.serve.generate import Generator as TGenerator
from mquant_tpu_torch.transform import hadamard as TH
from mquant_tpu_torch.transform import vlm_recipes as TVR
from mquant_tpu_torch.utils import checkpoint as TC
from mquant_tpu_torch.utils import safetensors as TST

from test_torch_engine import Model
from test_torch_internvl import _codes, _spiced
from test_torch_internvl_pipeline import _bit_equal
from test_torch_transforms import _ulp_equal

RTOL = 1e-5
STATE_RTOL = 1e-5
IMG = 16  # a 4 × 4 patch grid at the tiny patch 4, pooled into 4 queries
RES_SITES = ("kv_proj", "q", "k", "v", "out", "proj_fc")


@pytest.fixture(scope="module")
def tiny():
    jc = JQ.QwenVLConfig.tiny()
    tc = TQ.QwenVLConfig.tiny()
    pj = _spiced(JQ.init_qwenvl_params(jc, jax.random.key(0)), 1)
    rng = np.random.default_rng(2)
    img = rng.standard_normal((1, IMG, IMG, 3)).astype(np.float32)
    n_img = jc.resampler.n_queries
    toks = rng.integers(0, 200, size=(1, n_img + 9))
    toks[0, 3:3 + n_img] = jc.image_token_id
    pj_patches, _ = JV.patchify_2d(jnp.asarray(img), jc.patch)
    pt_patches, _ = TV.patchify_2d(torch.from_numpy(img), tc.patch)
    return dict(jc=jc, tc=tc, pj=pj, pt=interop.to_torch(pj, device="cpu"),
                toks=toks, patches_j=pj_patches, patches_t=pt_patches)


def _close(t, j, rtol=RTOL, what=""):
    j = np.asarray(j, np.float64)
    np.testing.assert_allclose(t.detach().double().numpy(), j, rtol=0,
                               atol=rtol * np.abs(j).max(), err_msg=what)


def _specs(Spec, w_bits=None):
    """Static int8 activations at every site of the three subsystems (the
    pipeline's), weights at ``w_bits``."""
    s = {}
    for pre, sites in (("vis", JV.VIT_SITES + ("patch_embed",)),
                       ("res", RES_SITES),
                       ("llm", ("q", "k", "v", "o", "gate", "up", "down"))):
        for n in sites:
            s[f"{pre}.{n}"] = Spec(w_bits=w_bits, a_bits=8, a_static=True)
    return s


def _mode_kw(mode, prefixes, calib_fn=None):
    """(JAX kwargs, port kwargs) of a module call in ``mode``: W8 and JAX's
    static state from ``calib_fn`` in "fake", the stats and samples in
    "calib"."""
    keep = lambda s: {k: v for k, v in s.items()  # noqa: E731
                      if k.split(".")[0] in prefixes}
    w = 8 if mode == "fake" else None
    kw_j = dict(specs=keep(_specs(JSpec, w)), mode=mode,
                collect_stats=mode == "calib",
                collect_samples=mode == "calib")
    kw_t = dict(kw_j, specs=keep(_specs(TSpec, w)))
    if mode == "fake":
        specs = keep(_specs(JSpec))
        stats, samples = calib_fn(specs)
        sj = JCAL.finalize_state(specs, stats, samples)
        kw_j["state"] = sj
        kw_t["state"] = interop.to_torch(jax.tree.map(np.asarray, sj),
                                         device="cpu")
    return kw_j, kw_t


def _stats_close(st, sj):
    assert set(st[0]) == set(sj[0])
    for k in sj[0]:
        for a, b in zip(st[0][k], sj[0][k]):
            _close(a, b, STATE_RTOL, k)
        _close(st[1][k], sj[1][k], what=k)


# ---------------------------------------------------------------------------
# configs and the registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["tiny", "qwenvl_chat"])
def test_config_round_trips_both_ways(preset):
    """JAX's config dict → the port's config (the port's preset: the
    CLIP tower's pre_norm / post_norm, the resampler, dynamic NTK); the
    port's config dict → JAX's ``config_from_dict`` → JAX's preset; the
    tanh GELU reads back too."""
    cj = getattr(JQ.QwenVLConfig, preset)()
    ct = getattr(TQ.QwenVLConfig, preset)()
    back = TC.config_from_dict(json.loads(json.dumps(JC.config_to_dict(cj))))
    assert back == ct
    assert JC.config_from_dict(json.loads(json.dumps(
        TC.config_to_dict(ct)))) == cj
    assert ct.vit.pre_norm and ct.vit.post_norm
    assert ct.llm.n_heads == ct.llm.n_kv_heads  # G = 1
    cj = dataclasses.replace(cj, vit=dataclasses.replace(cj.vit,
                                                         act="gelu_tanh"))
    back = TC.config_from_dict(json.loads(json.dumps(JC.config_to_dict(cj))))
    assert back.vit.act == "gelu_tanh"


@pytest.mark.parametrize("name", ["Qwen-VL-Chat", "qwenvl", "qwen_vl"])
def test_registry_matches_jax(name):
    """The family a name picks, its presets, subsystems and the config's
    own family; every supported name resolves as JAX's does, and
    MiniCPM-V alone still raises naming A12c."""
    fj, ft = j_family(name), t_family(name)
    assert ft.name == fj.name == "qwenvl"
    assert ft.subsystems == fj.subsystems == ("vis", "res", "llm")
    assert ft.config_fn() == TQ.QwenVLConfig.qwenvl_chat()
    assert ft.tiny_fn() == TQ.QwenVLConfig.tiny()
    assert ft.forward_fn is TQ.qwenvl_forward
    assert family_of(ft.tiny_fn()).name == "qwenvl"
    assert "Qwen-VL-Chat" in SUPPORTED_MODELS
    assert [t_family(n).name for n in SUPPORTED_MODELS] == [
        j_family(n).name for n in SUPPORTED_MODELS]
    with pytest.raises(NotImplementedError, match="A12c"):
        t_family("MiniCPM-V-2_6")


def test_init_params_layout():
    """The port's random params have JAX's tree: the same keys in the same
    order, shapes and dtypes (other values: another RNG); ``fc_sub_mean``
    is the exact centering matrix."""
    jc, tc = JQ.QwenVLConfig.tiny(), TQ.QwenVLConfig.tiny()
    pj = JQ.init_qwenvl_params(jc, jax.random.key(0))
    pt = t_family("qwenvl").init_fn(tc, torch.Generator().manual_seed(0),
                                    device="cpu")

    def walk(t, j, where=""):
        if isinstance(j, dict):
            assert list(t) == list(j), where
            for k in j:
                walk(t[k], j[k], f"{where}/{k}")
            return
        if j is None:
            assert t is None, where
            return
        assert tuple(t.shape) == np.asarray(j).shape, where
        assert str(t.dtype).removeprefix("torch.") == np.asarray(
            j).dtype.name, where

    walk(pt, pj)
    np.testing.assert_array_equal(pt["vit"]["fc_sub_mean"]["w"].numpy(),
                                  np.asarray(pj["vit"]["fc_sub_mean"]["w"]))


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_tanh_matches_jax(dtype):
    """``layers.gelu_tanh`` against ``jax.nn.gelu(approximate=True)`` over
    [-8, 8]: bf16 bit-equal (each op rounded where JAX's rounds), f32
    within 2 ulp (the two backends' tanh)."""
    x = np.linspace(-8, 8, 4001).astype(np.float32)
    yj = np.asarray(jax.nn.gelu(jnp.asarray(x).astype(dtype),
                                approximate=True).astype(jnp.float32))
    yt = TLy.gelu_tanh(torch.from_numpy(x).to(getattr(torch, dtype))
                       ).float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(yt, yj)
    else:
        np.testing.assert_allclose(yt, yj, rtol=0,
                                   atol=2 * np.spacing(np.abs(yj)).max())


@pytest.mark.parametrize("act", ["gelu", "gelu_tanh"])
@pytest.mark.parametrize("mode", ["fp", "fake", "calib"])
def test_vit_matches_jax(tiny, mode, act):
    """The CLIP-style tower: patch embed, learned positions, ln_pre,
    ``fc_sub_mean`` (float, never quantized), the blocks and ln_post; in
    fp, fake (W8, JAX's static state) and calib mode (the stats and
    samples of the patch embed and the blocks' sites); ``vit_preamble``
    (the GPTQ driver's block-0 inputs) too."""
    jc = dataclasses.replace(tiny["jc"].vit, act=act)
    tc = dataclasses.replace(tiny["tc"].vit, act=act)
    pj, pt = tiny["pj"]["vit"], tiny["pt"]["vit"]
    xj, xt = tiny["patches_j"], tiny["patches_t"]

    def calib(specs):
        return JV.vit_forward(jc, pj, xj, specs=specs, mode="calib",
                              collect_stats=True, collect_samples=True)[1]

    kw_j, kw_t = _mode_kw(mode, ("vis",), calib)
    yj, sj = JV.vit_forward(jc, pj, xj, **kw_j)
    yt, st = TV.vit_forward(tc, pt, xt, **kw_t)
    assert yt.shape == (1, 16, 32)
    _close(yt, yj)
    if mode == "calib":
        _stats_close(st, sj)
        assert "vis.fc_sub_mean" not in st[0]
    _close(TV.vit_preamble(tc, pt, xt), JV.vit_preamble(jc, pj, xj))


def test_sincos_2d_pos_embed_equals_jax():
    """MiniCPM-V's key position table, bit-equal (the same numpy ops)."""
    for dim, gh, gw in ((64, 4, 4), (32, 3, 5)):
        np.testing.assert_array_equal(TR.sincos_2d_pos_embed(dim, gh, gw),
                                      JR.sincos_2d_pos_embed(dim, gh, gw))


@pytest.mark.parametrize("mode", ["fp", "fake", "calib"])
def test_resampler_matches_jax(tiny, mode):
    """``resampler_forward`` on tower features (16 keys): kv_proj,
    ln_kv, the key position table, the queries' ln_q, the non-causal
    cross-attention, out, ln_post, proj_fc; in fp, fake and calib mode
    (the six sites' stats and samples). A key mask raises naming A6."""
    jc, tc = tiny["jc"].resampler, tiny["tc"].resampler
    pj, pt = tiny["pj"]["res"], tiny["pt"]["res"]
    x = np.random.default_rng(5).standard_normal((1, 16, 32)).astype(
        np.float32)

    def calib(specs):
        return JR.resampler_forward(jc, pj, jnp.asarray(x), specs=specs,
                                    mode="calib", collect_stats=True,
                                    collect_samples=True)[1]

    kw_j, kw_t = _mode_kw(mode, ("res",), calib)
    yj, sj = JR.resampler_forward(jc, pj, jnp.asarray(x), **kw_j)
    yt, st = TR.resampler_forward(tc, pt, torch.from_numpy(x), **kw_t)
    assert yt.shape == (1, 4, 64)
    _close(yt, yj)
    if mode == "calib":
        _stats_close(st, sj)
        assert list(st[0]) == [f"res.{s}" for s in RES_SITES]
    with pytest.raises(NotImplementedError, match="A6"):
        TR.resampler_forward(tc, pt, torch.from_numpy(x),
                             key_mask=torch.ones(1, 16))


def _state(tiny):
    """JAX's static activation state of the tiny model, calibrated on the
    fixture's prompt, and the port's copy of it."""
    specs = _specs(JSpec)
    _, _, (stats, samples) = JQ.qwenvl_forward(
        tiny["jc"], tiny["pj"], jnp.asarray(tiny["toks"]),
        tiny["patches_j"], specs=specs, mode="calib", collect_stats=True)
    sj = JCAL.finalize_state(specs, stats, samples)
    return sj, interop.to_torch(jax.tree.map(np.asarray, sj), device="cpu")


@pytest.mark.parametrize("mode", ["fp", "calib", "fake"])
def test_qwenvl_forward_matches_jax(tiny, mode):
    """The end-to-end forward CLIP tower → resampler → the pooled rows
    spliced at the image tokens → the decoder: logits in fp, calib (the
    stats of every subsystem's sites) and fake mode (W8 weights, JAX's
    calibrated static int8 activations); text-only too."""
    jc, tc = tiny["jc"], tiny["tc"]
    kw_j = dict(mode=mode, collect_stats=mode == "calib")
    kw_t = dict(kw_j)
    if mode != "fp":
        kw_j["specs"] = _specs(JSpec, None if mode == "calib" else 8)
        kw_t["specs"] = _specs(TSpec, None if mode == "calib" else 8)
    if mode == "fake":
        kw_j["state"], kw_t["state"] = _state(tiny)
    lj, _, sj = JQ.qwenvl_forward(jc, tiny["pj"], jnp.asarray(tiny["toks"]),
                                  tiny["patches_j"], **kw_j)
    lt, _, st = TQ.qwenvl_forward(tc, tiny["pt"],
                                  torch.from_numpy(tiny["toks"]),
                                  tiny["patches_t"], **kw_t)
    assert lt.shape == (1, tiny["toks"].shape[1], jc.llm.vocab)
    _close(lt, lj)
    if mode == "calib":
        assert set(st[0]) == set(sj[0])
        assert {k.split(".")[0] for k in st[0]} == {"vis", "res", "llm"}
        for k in sj[0]:
            for a, b in zip(st[0][k], sj[0][k]):
                _close(a, b, STATE_RTOL, k)
    lj, _, _ = JQ.qwenvl_forward(jc, tiny["pj"],
                                 jnp.asarray(tiny["toks"][:, 9:]), **kw_j)
    lt, _, _ = TQ.qwenvl_forward(tc, tiny["pt"],
                                 torch.from_numpy(tiny["toks"][:, 9:]),
                                 **kw_t)
    _close(lt, lj)


def test_calibrate_state_matches_jax(tiny):
    """``calib.calibrate`` over the family's forward: the finalized static
    scales of every site within rel 1e-5."""
    sj, _ = _state(tiny)
    specs = _specs(TSpec)

    def fwd(b, collect_samples=False):
        logits, _, st = TQ.qwenvl_forward(
            tiny["tc"], tiny["pt"], torch.from_numpy(tiny["toks"]),
            tiny["patches_t"], specs=specs, mode="calib",
            collect_stats=True, collect_samples=collect_samples)
        return logits, st

    st = TCAL.calibrate(fwd, [(None,)], specs)
    assert set(st) == set(sj)
    assert {f"res.{s}" for s in RES_SITES} <= set(st)
    for k in sj:
        _close(st[k]["act"].scale, sj[k]["act"].scale, STATE_RTOL, k)


# ---------------------------------------------------------------------------
# the transforms
# ---------------------------------------------------------------------------


def _rotations(jc, seed=7):
    """JAX's prepare_vlm draws: Q_v, k_r, Q_l from split(key, 3); the
    resampler's Q_kv, Q_q, Q_o from split(k_r, 3)."""
    k_v, k_r, k_l = jax.random.split(jax.random.key(seed), 3)
    W = jc.resampler.width
    rot = {"vit": JH.get_orthogonal_matrix(jc.vit.width, "hadamard", k_v),
           "llm": JH.get_orthogonal_matrix(jc.llm.hidden, "hadamard", k_l)}
    rot.update({f"res_{s}": JH.get_orthogonal_matrix(W, "hadamard", k)
                for s, k in zip(("kv", "q", "o"), jax.random.split(k_r, 3))})
    return {k: torch.from_numpy(np.asarray(v)) for k, v in rot.items()}


@pytest.mark.parametrize("kw", [
    dict(rotate=False),
    dict(online_had_down=True, split_down=True),
    dict(online_had_down=True, online_had_mode="block", split_down=False,
         online_had_visual=True, split_visual=True),
    dict(rotate_llm=False)],
    ids=["fuse", "full_split", "block_visual", "vision_only"])
def test_prepare_vlm_matches_jax(tiny, kw):
    """The qwenvl branch: the tower fused with ln_pre kept and the patch
    embed uncentered, ln_post folded into the resampler's kv_proj in
    float64 before its own fusion (ln_kv, ln_q, ln_post folded, the key
    positions divided by ln_kv's γ); Q_v into ``fc_sub_mean``'s output
    and kv_proj's input, Q_kv / Q_q / Q_o on the cross-attention, Q_l
    into proj_fc's output; leaf by leaf within one ulp, the same info."""
    jc, tc = tiny["jc"], tiny["tc"]
    pj, ij = JVR.prepare_vlm("qwenvl", jc, tiny["pj"], jax.random.key(7),
                             **kw)
    pt, it = TVR.prepare_vlm("qwenvl", tc, tiny["pt"],
                             rotations=_rotations(jc), **kw)
    _ulp_equal(pt, pj)
    assert set(it) == set(ij)
    if "llm" in ij:
        assert dataclasses.asdict(it["llm"]) == dataclasses.asdict(ij["llm"])
    if kw.get("rotate", True):
        assert it["resampler_rotated"] and it["vit_rotated"]
        # the patch embed and its positions stay unrotated
        assert torch.equal(pt["vit"]["patch_embed"]["w"],
                           tiny["pt"]["vit"]["patch_embed"]["w"])


def test_prepare_vlm_keeps_the_fused_function(tiny):
    """The port's own invariance: the fused-and-rotated model in fake mode
    (only the online Hadamard and the RMS split on) against the fused
    model in fp, logits within 5e-3: the rotation through
    ``fc_sub_mean``, the cross-attention's three rotations and Q_l
    through proj_fc keep the function."""
    tc = tiny["tc"]
    toks = torch.from_numpy(tiny["toks"])
    fused, _ = TVR.prepare_vlm("qwenvl", tc, tiny["pt"], rotate=False)
    ref, _, _ = TQ.qwenvl_forward(tc, fused, toks, tiny["patches_t"])
    prepared, info = TVR.prepare_vlm("qwenvl", tc, tiny["pt"],
                                     torch.Generator().manual_seed(7),
                                     online_had_down=True, split_down=True)
    assert info["resampler_rotated"]
    out, _, _ = TQ.qwenvl_forward(
        tc, prepared, toks, tiny["patches_t"],
        specs={"llm.down": TSpec(online_had="full", split=True)},
        mode="fake")
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=5e-3,
                               atol=5e-3)
    raw, _, _ = TQ.qwenvl_forward(tc, tiny["pt"], toks, tiny["patches_t"])
    np.testing.assert_allclose(ref.numpy(), raw.numpy(), rtol=5e-3,
                               atol=5e-3)


# ---------------------------------------------------------------------------
# visual GPTQ of the resampler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act_order", [False, True])
def test_gptq_quantize_resampler_matches_jax(tiny, act_order, monkeypatch):
    """``gptq_quantize_resampler`` over four batches of 64 tower rows,
    [kv_proj] → [k, v, q] → [out] → [proj_fc] at W8: every Hessian the
    port accumulates within rel 1e-5 of JAX's, and each site's walk given
    JAX's weight and Hessian held by ``tests/test_torch_gptq.py``'s rule:
    scales bit-equal, ≥ 99.9% of the codes equal, each difference one
    code."""
    jc, tc = tiny["jc"], tiny["tc"]
    rng = np.random.default_rng(6)
    xs = [rng.standard_normal((1, 64, 32)).astype(np.float32)
          for _ in range(4)]
    specs_j = {k: v for k, v in _specs(JSpec, 8).items()
               if k.startswith("res.")}
    specs_t = {k: v for k, v in _specs(TSpec, 8).items()
               if k.startswith("res.")}
    log_j, log_t = [], []

    def rec(mod, log):
        saved = mod.gptq_quantize_matrix

        def wrapped(W, H, *a, **kw):
            res = saved(W, H, *a, **kw)
            log.append((np.asarray(W), np.asarray(H), res))
            return res
        return wrapped

    monkeypatch.setattr(JG, "gptq_quantize_matrix", rec(JG, log_j))
    monkeypatch.setattr(TG, "gptq_quantize_matrix", rec(TG, log_t))
    pj, rj = JGM.gptq_quantize_resampler(
        jc, tiny["pj"], [jnp.asarray(x) for x in xs], specs_j,
        JGM.GPTQConfig(act_order=act_order))
    pt, rt = TGM.gptq_quantize_resampler(
        tc, tiny["pt"], [torch.from_numpy(x) for x in xs], specs_t,
        TGM.GPTQConfig(act_order=act_order))
    monkeypatch.undo()
    assert rt == rj == {"fallbacks": [], "sites": 6}
    assert len(log_t) == len(log_j) == 6
    order = ("kv_proj", "k", "v", "q", "out", "proj_fc")
    for (Wt, Ht, _), (Wj, Hj, resj), site in zip(log_t, log_j, order):
        np.testing.assert_allclose(Ht, Hj, rtol=1e-5,
                                   atol=1e-5 * np.abs(Hj).max(),
                                   err_msg=site)
        if site == "kv_proj":  # the first stage's weights are the float ones
            np.testing.assert_array_equal(Wt, Wj)
        res = TG.gptq_quantize_matrix(torch.from_numpy(Wj.copy()),
                                      torch.from_numpy(Hj.copy()), bits=8,
                                      act_order=act_order)
        np.testing.assert_array_equal(res.scale.numpy(),
                                      np.asarray(resj.scale))
        ct, cj = _codes(res.w, res.scale), _codes(resj.w, resj.scale)
        assert (ct == cj).mean() >= 0.999, site
        assert np.abs(ct - cj).max() <= 1, site
    np.testing.assert_array_equal(
        pt["res"]["kv_proj"]["w"].numpy(), log_t[0][2].w.numpy())
    assert pt["llm"] is tiny["pt"]["llm"]


# ---------------------------------------------------------------------------
# the order-172 Hadamard, G = 1 and dynamic NTK
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [344, 11008])
def test_hadamard_172_matches_jax(n):
    """Qwen-VL-Chat's intermediate 11008 = 172 · 64 (and the tests' 344 =
    172 · 2): no pad; the seeded order-172 block (a random orthogonal
    matrix, not a Hadamard one) bit-equal to JAX's, the transform matrix
    too; ``online_hadamard`` on bf16 rows bit-equal to JAX's, on f32 rows
    within 1e-6 of the largest magnitude (the 172-term sums run in each
    package's order), and orthonormal."""
    assert TH.auto_pad_size(n) == JH.auto_pad_size(n) == n
    hj, kj = JH.get_hadK(n)
    ht, kt = TH.get_hadK(n)
    assert kt == kj == 172
    np.testing.assert_array_equal(np.asarray(ht), np.asarray(hj))
    if n == 344:
        np.testing.assert_array_equal(TH.transform_matrix(n),
                                      JH.transform_matrix(n))
    x = np.random.default_rng(8).standard_normal((8, n)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    np.testing.assert_array_equal(
        TF.online_hadamard(torch.from_numpy(x).bfloat16()).float().numpy(),
        np.asarray(JF.online_hadamard(xb).astype(jnp.float32)))
    yj = np.asarray(JF.online_hadamard(jnp.asarray(x)))
    yt = TF.online_hadamard(torch.from_numpy(x))
    _close(yt, yj, 1e-6)
    np.testing.assert_allclose(np.linalg.norm(yt.numpy(), axis=-1),
                               np.linalg.norm(x, axis=-1), rtol=1e-5)


@pytest.mark.parametrize("quantized", [False, 8])
def test_decoder_g1_dynamic_ntk_matches_jax(quantized):
    """Qwen's decoder shape at the tiny size: 4 / 4 heads (G = 1), q/k/v
    biases, dynamic NTK over ``ntk_seq_length`` 8, so a 12-token prefill
    scales theta (α > 1): the prefill and two decode steps into an fp or
    int8 cache, logits against JAX's; then the Generator's greedy tokens
    equal to JAX's."""
    m = Model(43, n_heads=4, n_kv_heads=4, use_dynamic_ntk=True,
              ntk_seq_length=8)
    assert TLLM.ntk_alpha_for(m.tc, 12) == JLLM.ntk_alpha_for(m.jc, 12) > 1
    toks = np.random.default_rng(3).integers(0, 96, (2, 14))
    cj = JLLM.init_cache(m.jc, 2, 32, quantized=quantized)
    ct = TLLM.init_cache(m.tc, 2, 32, device="cpu", quantized=quantized)
    lj, cj, _ = JLLM.decoder_forward(m.jc, m.pj, jnp.asarray(toks[:, :12]),
                                     cache=cj, prefill_fresh=True)
    lt, ct, _ = TLLM.decoder_forward(m.tc, m.pt, torch.from_numpy(
        toks[:, :12]), cache=ct, prefill_fresh=True)
    _close(lt, lj)
    for i in (12, 13):
        lj, cj, _ = JLLM.decoder_forward(m.jc, m.pj,
                                         jnp.asarray(toks[:, i:i + 1]),
                                         cache=cj)
        lt, ct, _ = TLLM.decoder_forward(m.tc, m.pt, torch.from_numpy(
            toks[:, i:i + 1]), cache=ct)
        _close(lt, lj)
    gj = JGenerator(m.jc, m.pj, max_len=64, kv_quant=quantized)
    gt = TGenerator(m.tc, m.pt, max_len=64, kv_quant=quantized)
    want = np.asarray(gj.generate_on_device(jnp.asarray(toks[:1]), 8))
    np.testing.assert_array_equal(
        gt.generate_on_device(torch.from_numpy(toks[:1]), 8).numpy(), want)


# ---------------------------------------------------------------------------
# the HF checkpoint loader
# ---------------------------------------------------------------------------


def _hf_checkpoint(cfg, path, dtype=torch.bfloat16, seed=0):
    """A tiny HF Qwen-VL-Chat checkpoint (Qwen's and the visual tower's
    names and layouts: fused ``c_attn``, ``w1`` / ``w2``, the per-head
    interleaved ``in_proj``, ``attn_pool``, the matrix ``proj``) of random
    values, written with the port's safetensors writer as one file."""
    g = torch.Generator().manual_seed(seed)
    lc, vc, rc = cfg.llm, cfg.vit, cfg.resampler
    Hd, I, W, D = lc.hidden, lc.intermediate, vc.width, rc.width

    def r(*shape):
        return torch.randn(shape, generator=g).to(dtype)

    t = {"transformer.wte.weight": r(lc.vocab, Hd),
         "transformer.ln_f.weight": r(Hd), "lm_head.weight": r(lc.vocab, Hd)}
    for i in range(lc.n_layers):
        b = f"transformer.h.{i}."
        t.update({b + "attn.c_attn.weight": r(3 * Hd, Hd),
                  b + "attn.c_attn.bias": r(3 * Hd),
                  b + "attn.c_proj.weight": r(Hd, Hd),
                  b + "ln_1.weight": r(Hd), b + "ln_2.weight": r(Hd),
                  b + "mlp.w1.weight": r(I, Hd),
                  b + "mlp.w2.weight": r(I, Hd),
                  b + "mlp.c_proj.weight": r(Hd, I)})
    vp = "transformer.visual."
    p = cfg.patch
    t.update({vp + "conv1.weight": r(W, 3, p, p),
              vp + "positional_embedding": r(vc.n_pos, W),
              vp + "ln_pre.weight": r(W), vp + "ln_pre.bias": r(W),
              vp + "ln_post.weight": r(D), vp + "ln_post.bias": r(D),
              vp + "proj": r(D, rc.out_dim)})
    for i in range(vc.n_layers):
        b = f"{vp}transformer.resblocks.{i}."
        t.update({b + "attn.in_proj.weight": r(3 * W, W),
                  b + "attn.in_proj.bias": r(3 * W),
                  b + "attn.out_proj.weight": r(W, W),
                  b + "attn.out_proj.bias": r(W),
                  b + "ln_1.weight": r(W), b + "ln_1.bias": r(W),
                  b + "ln_2.weight": r(W), b + "ln_2.bias": r(W),
                  b + "mlp.c_fc.weight": r(vc.mlp_width, W),
                  b + "mlp.c_fc.bias": r(vc.mlp_width),
                  b + "mlp.c_proj.weight": r(W, vc.mlp_width),
                  b + "mlp.c_proj.bias": r(W)})
    ap = vp + "attn_pool."
    t.update({ap + "query": r(rc.n_queries, D),
              ap + "kv_proj.weight": r(D, W),
              ap + "ln_q.weight": r(D), ap + "ln_q.bias": r(D),
              ap + "ln_kv.weight": r(D), ap + "ln_kv.bias": r(D),
              ap + "attn.in_proj_weight": r(3 * D, D),
              ap + "attn.in_proj_bias": r(3 * D),
              ap + "attn.out_proj.weight": r(D, D),
              ap + "attn.out_proj.bias": r(D),
              ap + "pos_embed": r(vc.n_pos, D)})
    os.makedirs(path, exist_ok=True)
    TST.save_file(t, os.path.join(path, "model.safetensors"),
                  metadata={"format": "pt"})
    return t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_qwenvl_bit_equal_to_jax(tmp_path, dtype):
    """``load_model("qwenvl", ...)`` against JAX's loader on the same
    checkpoint: every leaf bit-equal (f32 and bf16 trees); ``c_attn`` split
    into [q | k | v] thirds, gate = ``w2`` and up = ``w1``, the visual
    ``in_proj`` de-interleaved per head, ``attn_pool``'s ``in_proj`` in
    thirds, ``proj`` as ``res.proj_fc`` with a zero bias, the exact
    ``fc_sub_mean``, the visual ln_post (after the pool, output_dim wide)
    as ``res.ln_post``. The one leaf the port does not take: JAX's copy of
    that norm as the tower's ``ln_post``, which does not fit the tower's
    width (ROADMAP C-w25; HF's tower has no norm after its blocks)."""
    jc = j_family("qwenvl").tiny_fn()
    tc = TQ.QwenVLConfig.tiny()
    t = _hf_checkpoint(tc, str(tmp_path))
    pj = JL.load_model("qwenvl", jc, str(tmp_path),
                       dtype=getattr(jnp, dtype))
    pt = TL.load_model("qwenvl", tc, str(tmp_path),
                       dtype=getattr(torch, dtype), device="cpu")
    pj = dict(pj, vit=dict(pj["vit"]))
    jln = pj["vit"].pop("ln_post")
    assert np.asarray(jln["w"]).shape == (tc.resampler.width,) != (
        tc.vit.width,)
    assert "ln_post" not in pt["vit"]
    _bit_equal(pt, pj)
    dt = getattr(torch, dtype)
    Hd = tc.llm.hidden
    b = "transformer.h.1."
    ca = t[b + "attn.c_attn.weight"].to(dt)
    lay = pt["llm"]["layers"]
    for j, s in enumerate("qkv"):
        assert torch.equal(lay[s]["w"][1].T, ca[j * Hd:(j + 1) * Hd]), s
    assert torch.equal(lay["gate"]["w"][1].T, t[b + "mlp.w2.weight"].to(dt))
    assert torch.equal(lay["up"]["w"][1].T, t[b + "mlp.w1.weight"].to(dt))
    W, H = tc.vit.width, tc.vit.n_heads
    hd = W // H
    vb = "transformer.visual.transformer.resblocks.0."
    inw = t[vb + "attn.in_proj.weight"].to(dt)
    blk = pt["vit"]["blocks"]
    for h in range(H):  # head h's q rows are in_proj rows 3·hd·h …
        for j, s in enumerate("qkv"):
            lo = (3 * h + j) * hd
            assert torch.equal(blk[s]["w"][0][:, h * hd:(h + 1) * hd].T,
                               inw[lo:lo + hd]), (h, s)
    assert not torch.equal(blk["k"]["w"][0], blk["v"]["w"][0])
    ap = "transformer.visual.attn_pool."
    D = tc.resampler.width
    inw = t[ap + "attn.in_proj_weight"].to(dt)
    for j, s in enumerate("qkv"):
        assert torch.equal(pt["res"][s]["w"].T, inw[j * D:(j + 1) * D]), s
    assert torch.equal(pt["res"]["proj_fc"]["w"],
                       t["transformer.visual.proj"].to(dt))
    assert not pt["res"]["proj_fc"]["b"].any()
    fc = pt["vit"]["fc_sub_mean"]["w"].double()
    assert torch.allclose(fc, torch.eye(W, dtype=torch.float64) - 1 / W)
