"""The port's InternVL2 family (``mquant_tpu_torch.models.{internvl,
projectors,vision}``, the family's branches of ``transform.vlm_recipes``
and ``gptq.modules``, the registry and the config codec) against the JAX
package's at ``InternVLConfig.tiny()`` (f32, CPU), on the same numpy-drawn
inputs and JAX-initialized params handed to the port through
``interop.to_torch``. The params are "spiced": non-unit norms with biases,
LayerScale gains and q/k/v / o / fc biases off their init values, so each
fold is exercised.

Tolerances, each the JAX tests' own: patches, pixel shuffles and integer
codes bit-equal; f32 forwards within 1e-5 of the largest magnitude (the
slice's rule, ``tests/test_torch_slice.py``: the two packages sum in other
orders); static activation stats within rel 1e-5; transformed trees within
one ulp of each leaf (``tests/test_torch_transforms.py``'s rule); the
fused-and-rotated forward against the fused one within 5e-3
(``tests/test_vlm_recipes.py``: the mlp1 LayerNorm spans the four
pixel-shuffled stream vectors, so fusing it is approximate in both
packages, and the oracle of the rotation is the fused model).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mquant_tpu.calib import calibrate as JCAL
from mquant_tpu.gptq import core as JG
from mquant_tpu.gptq import modules as JGM
from mquant_tpu.models import internvl as JI
from mquant_tpu.models import projectors as JPR
from mquant_tpu.models import vision as JV
from mquant_tpu.models.layers import SiteSpec as JSpec
from mquant_tpu.models.registry import get_family as j_family
from mquant_tpu.transform import hadamard as JH
from mquant_tpu.transform import vlm_recipes as JVR
from mquant_tpu.utils import checkpoint as JC
from mquant_tpu_torch import interop
from mquant_tpu_torch.calib import calibrate as TCAL
from mquant_tpu_torch.gptq import core as TG
from mquant_tpu_torch.gptq import modules as TGM
from mquant_tpu_torch.models import internvl as TI
from mquant_tpu_torch.models import projectors as TPR
from mquant_tpu_torch.models import vision as TV
from mquant_tpu_torch.models.layers import SiteSpec as TSpec
from mquant_tpu_torch.models.registry import family_of
from mquant_tpu_torch.models.registry import get_family as t_family
from mquant_tpu_torch.transform import vlm_recipes as TVR
from mquant_tpu_torch.utils import checkpoint as TC

from test_torch_transforms import _ulp_equal

RTOL = 1e-5
STATE_RTOL = 1e-5
IMG = 16  # a 4 × 4 patch grid at the tiny patch 4: 4 image tokens
GRID = (IMG // 4, IMG // 4)


def _spiced(params, seed):
    """Every norm off unit weight and zero bias, the LayerScale gains and
    the q/k/v / o / fc / mlp1 biases random (JAX's init leaves them
    constant)."""
    rng = np.random.default_rng(seed)

    def walk(tree, key=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if tree is None:
            return None
        a = np.asarray(tree)
        if key == "w" and a.ndim <= 2 and np.all(a == a.flat[0]):
            return jnp.asarray(a + 0.3 * rng.standard_normal(a.shape),
                               a.dtype)  # norms and LayerScale gains
        if key == "b":
            return jnp.asarray(0.1 * rng.standard_normal(a.shape), a.dtype)
        return tree

    return walk(params)


@pytest.fixture(scope="module")
def tiny():
    jc = JI.InternVLConfig.tiny()
    tc = TI.InternVLConfig.tiny()
    pj = _spiced(JI.init_internvl_params(jc, jax.random.key(0)), 1)
    rng = np.random.default_rng(2)
    img = rng.standard_normal((1, IMG, IMG, 3)).astype(np.float32)
    n_img = (GRID[0] // 2) * (GRID[1] // 2)
    toks = rng.integers(0, 200, size=(1, n_img + 9))
    toks[0, 3:3 + n_img] = jc.image_token_id
    pj_patches, _ = JV.patchify_2d(jnp.asarray(img), jc.patch)
    pt_patches, _ = TV.patchify_2d(torch.from_numpy(img), tc.patch)
    return dict(jc=jc, tc=tc, pj=pj, pt=interop.to_torch(pj, device="cpu"),
                img=img, toks=toks, patches_j=pj_patches,
                patches_t=pt_patches)


def _close(t, j, rtol=RTOL, what=""):
    j = np.asarray(j, np.float64)
    np.testing.assert_allclose(t.detach().double().numpy(), j, rtol=0,
                               atol=rtol * np.abs(j).max(), err_msg=what)


def _specs(Spec, w_bits=None):
    """Static int8 activations at every site of the three subsystems (the
    pipeline's), weights at ``w_bits``."""
    s = {}
    for pre, sites in (("vis", JV.VIT_SITES + ("patch_embed",)),
                       ("proj", ("fc1", "fc2")),
                       ("llm", ("q", "k", "v", "o", "gate", "up", "down"))):
        for n in sites:
            s[f"{pre}.{n}"] = Spec(w_bits=w_bits, a_bits=8, a_static=True)
    return s


# ---------------------------------------------------------------------------
# configs and the registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["tiny", "internvl2_8b"])
def test_config_round_trips_both_ways(preset):
    """JAX's config dict → the port's config (the port's preset); the
    port's config dict → JAX's ``config_from_dict`` → JAX's preset."""
    cj = getattr(JI.InternVLConfig, preset)()
    ct = getattr(TI.InternVLConfig, preset)()
    back = TC.config_from_dict(json.loads(json.dumps(JC.config_to_dict(cj))))
    assert back == ct
    assert JC.config_from_dict(json.loads(json.dumps(
        TC.config_to_dict(ct)))) == cj
    assert ct.vit.n_pos and ct.vit.layerscale and not ct.llm.mrope_sections


@pytest.mark.parametrize("name", ["InternVL2-8B", "internvl", "intern_vl2"])
def test_registry_matches_jax(name):
    """The family a name picks, its presets, subsystems and the config's
    own family."""
    fj, ft = j_family(name), t_family(name)
    assert ft.name == fj.name == "internvl"
    assert ft.subsystems == fj.subsystems == ("vis", "proj", "llm")
    assert ft.config_fn() == TI.InternVLConfig.internvl2_8b()
    assert ft.tiny_fn() == TI.InternVLConfig.tiny()
    assert ft.forward_fn is TI.internvl_forward
    assert family_of(ft.tiny_fn()).name == "internvl"
    assert family_of(t_family("qwen2vl").tiny_fn()).name == "qwen2vl"


def test_init_params_layout():
    """The port's random params have JAX's tree: the same keys in the same
    order, shapes and dtypes (other values: another RNG)."""
    jc, tc = JI.InternVLConfig.tiny(), TI.InternVLConfig.tiny()
    pj = JI.init_internvl_params(jc, jax.random.key(0))
    pt = t_family("internvl").init_fn(tc, torch.Generator().manual_seed(0),
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
    np.testing.assert_array_equal(pt["vit"]["blocks"]["ls1"]["w"].numpy(),
                                  np.full((2, 32), 0.1, np.float32))


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------


def test_patchify_2d_equals_jax(tiny):
    """Patches and grid coordinates bit-equal, at a non-square image."""
    img = np.random.default_rng(3).standard_normal((2, 8, 12, 3)).astype(
        np.float32)
    xj, gj = JV.patchify_2d(jnp.asarray(img), 4)
    xt, gt = TV.patchify_2d(torch.from_numpy(img), 4)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(tiny["patches_t"].numpy(),
                                  np.asarray(tiny["patches_j"]))


@pytest.mark.parametrize("factor,grid", [(2, (4, 4)), (2, (2, 6)),
                                         (3, (6, 3))])
def test_pixel_shuffle_equals_jax(factor, grid):
    x = np.random.default_rng(4).standard_normal(
        (2, grid[0] * grid[1], 5)).astype(np.float32)
    yj = JPR.pixel_shuffle(jnp.asarray(x), *grid, factor)
    yt = TPR.pixel_shuffle(torch.from_numpy(x), *grid, factor)
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


def test_vit_layerscale_and_positions_match_jax(tiny):
    """InternViT in fp: learned positions after the patch embed, ls1 / ls2
    on the branch outputs; the preamble alone too."""
    jc, tc = tiny["jc"], tiny["tc"]
    hj = JV.vit_preamble(jc.vit, tiny["pj"]["vit"], tiny["patches_j"])
    ht = TV.vit_preamble(tc.vit, tiny["pt"]["vit"], tiny["patches_t"])
    _close(ht, hj, what="preamble")
    fj, _ = JV.vit_forward(jc.vit, tiny["pj"]["vit"], tiny["patches_j"])
    ft, _ = TV.vit_forward(tc.vit, tiny["pt"]["vit"], tiny["patches_t"])
    _close(ft, fj, what="features")
    # without the gains the output moves: LayerScale is applied
    no_ls = dict(tiny["pt"]["vit"])
    no_ls["blocks"] = {k: v for k, v in no_ls["blocks"].items()
                       if k not in ("ls1", "ls2")}
    f0, _ = TV.vit_forward(tc.vit, no_ls, tiny["patches_t"])
    assert (f0 - ft).abs().max() > 1e-2


@pytest.mark.parametrize("mode", ["fp", "calib"])
def test_mlp1_matches_jax(tiny, mode):
    """mlp1 on pixel-shuffled features; in calib mode the stats and samples
    of proj.fc1 / proj.fc2."""
    x = np.random.default_rng(5).standard_normal((1, 4, 128)).astype(
        np.float32)
    kw = dict(specs=_specs(JSpec), mode=mode, collect_stats=mode == "calib",
              collect_samples=mode == "calib")
    yj, sj = JPR.mlp1_forward(tiny["jc"].mlp1, tiny["pj"]["proj"],
                              jnp.asarray(x), **kw)
    kw["specs"] = _specs(TSpec)
    yt, st = TPR.mlp1_forward(tiny["tc"].mlp1, tiny["pt"]["proj"],
                              torch.from_numpy(x), **kw)
    _close(yt, yj)
    if mode == "calib":
        assert set(st[0]) == set(sj[0]) == {"proj.fc1", "proj.fc2"}
        for k in sj[0]:
            for a, b in zip(st[0][k], sj[0][k]):
                _close(a, b, STATE_RTOL, k)
            _close(st[1][k], sj[1][k], what=k)


def _state(tiny):
    """JAX's static activation state of the tiny model, calibrated on the
    fixture's prompt, and the port's copy of it."""
    specs = _specs(JSpec)
    _, _, (stats, samples) = JI.internvl_forward(
        tiny["jc"], tiny["pj"], jnp.asarray(tiny["toks"]),
        tiny["patches_j"], GRID, specs=specs, mode="calib",
        collect_stats=True)
    sj = JCAL.finalize_state(specs, stats, samples)
    return sj, interop.to_torch(jax.tree.map(np.asarray, sj), device="cpu")


@pytest.mark.parametrize("mode", ["fp", "calib", "fake"])
def test_internvl_forward_matches_jax(tiny, mode):
    """The end-to-end forward ViT → pixel shuffle → mlp1 → splice →
    InternLM2 decoder: logits in fp, calib (the stats of every subsystem's
    sites) and fake mode (W8 weights fake-quantized, JAX's calibrated
    static int8 activations)."""
    jc, tc = tiny["jc"], tiny["tc"]
    kw_j = dict(mode=mode, collect_stats=mode == "calib")
    kw_t = dict(kw_j)
    if mode != "fp":
        kw_j["specs"] = _specs(JSpec, None if mode == "calib" else 8)
        kw_t["specs"] = _specs(TSpec, None if mode == "calib" else 8)
    if mode == "fake":
        kw_j["state"], kw_t["state"] = _state(tiny)
    lj, _, sj = JI.internvl_forward(jc, tiny["pj"], jnp.asarray(tiny["toks"]),
                                    tiny["patches_j"], GRID, **kw_j)
    lt, _, st = TI.internvl_forward(tc, tiny["pt"],
                                    torch.from_numpy(tiny["toks"]),
                                    tiny["patches_t"], GRID, **kw_t)
    assert lt.shape == (1, tiny["toks"].shape[1], jc.llm.vocab)
    _close(lt, lj)
    if mode == "calib":
        assert set(st[0]) == set(sj[0])
        assert {k.split(".")[0] for k in st[0]} == {"vis", "proj", "llm"}
        for k in sj[0]:
            for a, b in zip(st[0][k], sj[0][k]):
                _close(a, b, STATE_RTOL, k)
    # text-only: the decoder over 1-D positions alone
    lj, _, _ = JI.internvl_forward(jc, tiny["pj"],
                                   jnp.asarray(tiny["toks"][:, 8:]), **kw_j)
    lt, _, _ = TI.internvl_forward(tc, tiny["pt"],
                                   torch.from_numpy(tiny["toks"][:, 8:]),
                                   **kw_t)
    _close(lt, lj)


def test_calibrate_state_matches_jax(tiny):
    """``calib.calibrate`` over the family's forward: the finalized static
    scales of every site within rel 1e-5."""
    sj, _ = _state(tiny)
    specs = _specs(TSpec)

    def fwd(b, collect_samples=False):
        logits, _, st = TI.internvl_forward(
            tiny["tc"], tiny["pt"], torch.from_numpy(tiny["toks"]),
            tiny["patches_t"], GRID, specs=specs, mode="calib",
            collect_stats=True, collect_samples=collect_samples)
        return logits, st

    st = TCAL.calibrate(fwd, [(None,)], specs)
    assert set(st) == set(sj)
    for k in sj:
        _close(st[k]["act"].scale, sj[k]["act"].scale, STATE_RTOL, k)


# ---------------------------------------------------------------------------
# the transforms
# ---------------------------------------------------------------------------


def test_fuse_vit_folds_layerscale_like_jax(tiny):
    """LayerScale into o / fc2, the position table centered with the patch
    embed, ln1 / ln2 folded: leaf by leaf within one ulp. The fused tower
    computes the same features up to each row's mean, which the fusion
    centres away (2e-4, ``tests/test_transforms.py``'s rule; mlp1's
    LayerNorm removes the mean), where o's and fc2's biases are zero, as
    at init: the centering
    of a stacked bias subtracts its mean over all layers, not each
    layer's, in both packages (ROADMAP C-w23), so spiced biases move the
    function."""
    jc, tc = tiny["jc"], tiny["tc"]
    fj = JVR.fuse_vit(jc.vit, tiny["pj"]["vit"])
    ft = TVR.fuse_vit(tc.vit, tiny["pt"]["vit"])
    _ulp_equal(ft, fj)
    assert "b" not in ft["blocks"]["ln1"]
    np.testing.assert_array_equal(ft["blocks"]["ls1"]["w"].numpy(), 1.0)
    vit = {**tiny["pt"]["vit"], "blocks": dict(tiny["pt"]["vit"]["blocks"])}
    for s in ("o", "fc2"):
        vit["blocks"][s] = {**vit["blocks"][s],
                            "b": torch.zeros_like(vit["blocks"][s]["b"])}
    a, _ = TV.vit_forward(tc.vit, vit, tiny["patches_t"])
    b, _ = TV.vit_forward(tc.vit, TVR.fuse_vit(tc.vit, vit),
                          tiny["patches_t"])
    _close(b, a - a.mean(dim=-1, keepdim=True), 2e-4)


def test_fuse_mlp1_matches_jax(tiny):
    _ulp_equal(TVR.fuse_mlp1(tiny["pt"]["proj"]),
               JVR.fuse_mlp1(tiny["pj"]["proj"]))


def _rotations(jc, seed=7):
    """JAX's prepare_vlm draws: Q_v from split(key, 3)[0], Q_l from [2]."""
    k_v, _, k_l = jax.random.split(jax.random.key(seed), 3)
    return {"vit": JH.get_orthogonal_matrix(jc.vit.width, "hadamard", k_v),
            "llm": JH.get_orthogonal_matrix(jc.llm.hidden, "hadamard", k_l)}


@pytest.mark.parametrize("kw", [
    dict(rotate=False),
    dict(online_had_down=True, split_down=True),
    dict(online_had_down=True, online_had_mode="block", split_down=False,
         online_had_visual=True, split_visual=True)],
    ids=["fuse", "full_split", "block_visual"])
def test_prepare_vlm_matches_jax(tiny, kw):
    """The internvl branch: fuse (ViT with LayerScale, mlp1), rotate_vit,
    mlp1.fc1 rotated block-diagonally (4 repeats of Q_v), the LLM rotation
    folded into proj.fc2's output; leaf by leaf within one ulp, the same
    info."""
    jc, tc = tiny["jc"], tiny["tc"]
    rot = _rotations(jc)
    pj, ij = JVR.prepare_vlm("internvl", jc, tiny["pj"], jax.random.key(7),
                             **kw)
    pt, it = TVR.prepare_vlm("internvl", tc, tiny["pt"], rotations={
        k: torch.from_numpy(np.asarray(v)) for k, v in rot.items()}, **kw)
    _ulp_equal(pt, pj)
    assert set(it) == set(ij)
    if "llm" in ij:
        assert dataclasses.asdict(it["llm"]) == dataclasses.asdict(ij["llm"])


def test_prepare_vlm_keeps_the_fused_function(tiny):
    """The port's own invariance: the fused-and-rotated model in fake mode
    (only the online Hadamard and the RMS split on) against the fused
    model in fp, logits within 5e-3."""
    tc = tiny["tc"]
    toks = torch.from_numpy(tiny["toks"])
    fused, _ = TVR.prepare_vlm("internvl", tc, tiny["pt"], rotate=False)
    ref, _, _ = TI.internvl_forward(tc, fused, toks, tiny["patches_t"], GRID)
    prepared, _ = TVR.prepare_vlm("internvl", tc, tiny["pt"],
                                  torch.Generator().manual_seed(7),
                                  online_had_down=True, split_down=True)
    out, _, _ = TI.internvl_forward(
        tc, prepared, toks, tiny["patches_t"], GRID,
        specs={"llm.down": TSpec(online_had="full", split=True)},
        mode="fake")
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=5e-3,
                               atol=5e-3)


# ---------------------------------------------------------------------------
# visual GPTQ of mlp1
# ---------------------------------------------------------------------------


def _codes(w, scale):
    return np.round(np.asarray(w, np.float64) / np.asarray(scale, np.float64))


@pytest.mark.parametrize("act_order", [False, True])
def test_gptq_quantize_mlp1_matches_jax(tiny, act_order, monkeypatch):
    """``gptq_quantize_mlp1`` over three batches of pixel-shuffled
    features, [fc1] → [fc2] at W8: every Hessian the port accumulates
    within rel 1e-5 of JAX's, and each site's codes, given JAX's Hessian,
    bit-equal to JAX's (the walk is held to JAX's on equal Hessians: the
    two packages' f32 sums differ in their last bits)."""
    jc, tc = tiny["jc"], tiny["tc"]
    rng = np.random.default_rng(6)
    xs = [rng.standard_normal((1, 4, 128)).astype(np.float32)
          for _ in range(3)]
    specs_j = {k: v for k, v in _specs(JSpec, 8).items()
               if k.startswith("proj.")}
    specs_t = {k: v for k, v in _specs(TSpec, 8).items()
               if k.startswith("proj.")}
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
    gj = JGM.GPTQConfig(act_order=act_order)
    gt = TGM.GPTQConfig(act_order=act_order)
    pj, rj = JGM.gptq_quantize_mlp1(jc, tiny["pj"],
                                    [jnp.asarray(x) for x in xs], specs_j,
                                    gj)
    pt, rt = TGM.gptq_quantize_mlp1(tc, tiny["pt"],
                                    [torch.from_numpy(x) for x in xs],
                                    specs_t, gt)
    monkeypatch.undo()
    assert rt == rj == {"fallbacks": [], "sites": 2}
    assert len(log_t) == len(log_j) == 2
    for (Wt, Ht, _), (Wj, Hj, resj), site in zip(log_t, log_j,
                                                  ("fc1", "fc2")):
        np.testing.assert_allclose(Ht, Hj, rtol=1e-5,
                                   atol=1e-5 * np.abs(Hj).max())
        if site == "fc1":  # the stage's weights are the same float ones
            np.testing.assert_array_equal(Wt, Wj)
        res = TG.gptq_quantize_matrix(torch.from_numpy(Wj.copy()),
                                      torch.from_numpy(Hj.copy()), bits=8,
                                      act_order=act_order)
        np.testing.assert_array_equal(res.scale.numpy(),
                                      np.asarray(resj.scale))
        np.testing.assert_array_equal(_codes(res.w, res.scale),
                                      _codes(resj.w, resj.scale),
                                      err_msg=site)
    # the module's own result: fc1 exactly the walk on its Hessian
    np.testing.assert_array_equal(
        pt["proj"]["fc1"]["w"].numpy(), log_t[0][2].w.numpy())
    assert pt["llm"] is tiny["pt"]["llm"]
