"""The port's offline transforms (``mquant_tpu_torch.transform``: fuse,
rotate, recipes, vlm_recipes) against the JAX package's on the same tiny
params, and the port's own invariance: the float forward before and after
a transform agrees within the JAX tests' tolerances
(``tests/test_transforms.py``: 2e-4 after fusion, 2e-3 after rotation;
``tests/test_vlm_recipes.py``: 5e-3 for the whole VLM).

The rotations are JAX's matrices passed in (the two packages draw from
different RNGs). Leaves: equal, or within one ulp of their dtype (both
packages compute in float64 and round once; the products sum in other
orders). An entry that is a cancellation residue of the float64 sums (the
centred ViT ``o``: -4.2188006e-10 against -4.2188011e-10, two ulps of
itself, 5e-17 at a leaf whose largest entry is 0.63) differs by the sums'
own rounding: every entry is within one ulp of itself or within 2⁻⁴⁰ of its
leaf's largest magnitude."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mquant_tpu.models import llm as JLLM
from mquant_tpu.models import qwen2vl as JQ2
from mquant_tpu.models.vision import patchify_qwen2vl
from mquant_tpu.transform import hadamard as JH
from mquant_tpu.transform import recipes as JR
from mquant_tpu.transform import vlm_recipes as JVR
from mquant_tpu_torch import interop
from mquant_tpu_torch.models import llm as TLLM
from mquant_tpu_torch.models import qwen2vl as TQ2
from mquant_tpu_torch.models.layers import SiteSpec as TSpec
from mquant_tpu_torch.transform import hadamard as TH
from mquant_tpu_torch.transform import recipes as TR
from mquant_tpu_torch.transform import vlm_recipes as TVR

CFG_J = JLLM.DecoderConfig(vocab=97, hidden=64, n_layers=2, n_heads=4,
                           n_kv_heads=2, intermediate=96, dtype=jnp.float32)
# 100 is no K·2^p: the full Hadamard pads it
CFG_PAD_J = dataclasses.replace(CFG_J, intermediate=100)


def _cfg_t(cfg_j, **kw):
    d = {f.name: getattr(cfg_j, f.name)
         for f in dataclasses.fields(TLLM.DecoderConfig)}
    d.update(dtype=torch.float32, **kw)
    return TLLM.DecoderConfig(**d)


def _spiced(params, seed):
    """Non-unit norm weights (and biases on q/k/v) so fusion is tested."""
    k = jax.random.key(seed)
    p = dict(params)
    lay = dict(p["layers"])
    for i, s in enumerate(("ln1", "ln2")):
        lay[s] = {"w": 1.0 + 0.3 * jax.random.normal(
            jax.random.fold_in(k, i), lay[s]["w"].shape)}
    for i, s in enumerate(("q", "k", "v")):
        lay[s] = {**lay[s], "b": 0.1 * jax.random.normal(
            jax.random.fold_in(k, 10 + i), lay[s]["b"].shape)}
    p["layers"] = lay
    p["ln_f"] = {"w": 1.0 + 0.3 * jax.random.normal(
        jax.random.fold_in(k, 2), p["ln_f"]["w"].shape)}
    return p


def _ulp_equal(t, j, where=""):
    """Port tree ``t`` equals JAX tree ``j``: the same keys and None slots,
    leaves of the same shape and dtype within one ulp."""
    if isinstance(j, dict):
        assert isinstance(t, dict) and set(t) == set(j), (where, set(t),
                                                          set(j))
        for k in j:
            _ulp_equal(t[k], j[k], f"{where}/{k}")
        return
    if j is None:
        assert t is None, where
        return
    ref = np.asarray(j)
    assert tuple(t.shape) == ref.shape, where
    assert str(t.dtype).removeprefix("torch.") == ref.dtype.name, where
    got = t.numpy()
    if ref.dtype.kind in "iu":
        np.testing.assert_array_equal(got, ref, err_msg=where)
        return
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(ref)))
    floor = 2.0 ** -40 * float(np.abs(ref).max(initial=0.0))
    bad = np.abs(got.astype(np.float64) - ref) > np.maximum(ulp, floor)
    assert not bad.any(), f"{where}: {bad.sum()} leaves beyond one ulp"


@pytest.fixture(scope="module")
def dec():
    pj = _spiced(JLLM.init_decoder_params(CFG_J, jax.random.key(0)), 1)
    toks = np.asarray(jax.random.randint(jax.random.key(2), (2, 12), 0,
                                         CFG_J.vocab))
    Q = JH.get_orthogonal_matrix(CFG_J.hidden, "hadamard", jax.random.key(7))
    pt = interop.to_torch(pj, device="cpu")
    ref = TLLM.decoder_forward(_cfg_t(CFG_J), pt, torch.from_numpy(toks))[0]
    return dict(pj=pj, pt=pt, toks=toks, Q=Q, ref=ref)


def test_fuse_decoder_matches_jax(dec):
    _ulp_equal(TR.fuse_decoder(_cfg_t(CFG_J), dec["pt"]),
               JR.fuse_decoder(CFG_J, dec["pj"]))


@pytest.mark.parametrize("case", ["plain", "full", "block", "padded"])
def test_rotate_decoder_matches_jax(dec, case):
    """The hidden-stream and OV rotations, with the online Hadamard folded
    into ``down`` over the whole intermediate (96 = 12·8), in I ⊗ H₁₂₈
    blocks (96 padded to 128) and over a padded width (100 → auto_pad_size),
    JAX's Q passed to both."""
    cfg_j = CFG_PAD_J if case == "padded" else CFG_J
    if case == "padded":
        pj = JLLM.init_decoder_params(cfg_j, jax.random.key(3))
        pt = interop.to_torch(pj, device="cpu")
    else:
        pj, pt = dec["pj"], dec["pt"]
    kw = dict(online_had_down=case != "plain",
              online_had_mode="block" if case == "block" else "full")
    rj, ij = JR.rotate_decoder(cfg_j, JR.fuse_decoder(cfg_j, pj), None,
                               Q=dec["Q"], **kw)
    rt, it = TR.rotate_decoder(_cfg_t(cfg_j), TR.fuse_decoder(
        _cfg_t(cfg_j), pt), Q=torch.from_numpy(np.asarray(dec["Q"])), **kw)
    _ulp_equal(rt, rj)
    assert dataclasses.asdict(it) == dataclasses.asdict(ij)
    if case == "padded":
        assert it.down_pad == TH.auto_pad_size(100) > 100
    _ulp_equal(TR.split_decoder_down(rt), JR.split_decoder_down(rj))


def test_rotate_requires_fuse(dec):
    with pytest.raises(ValueError):
        TR.rotate_decoder(_cfg_t(CFG_J), dec["pt"],
                          torch.Generator().manual_seed(0))


def _fake(cfg, params, toks, specs):
    return TLLM.decoder_forward(cfg, params, torch.from_numpy(toks),
                                specs=specs, mode="fake")[0]


@pytest.mark.parametrize("mode", ["hadamard", "random"])
def test_fuse_rotate_invariance(dec, mode):
    cfg = _cfg_t(CFG_J)
    fused = TR.fuse_decoder(cfg, dec["pt"])
    out = TLLM.decoder_forward(cfg, fused, torch.from_numpy(dec["toks"]))[0]
    np.testing.assert_allclose(out.numpy(), dec["ref"].numpy(), rtol=2e-4,
                               atol=2e-4)
    rot, info = TR.rotate_decoder(cfg, fused,
                                  torch.Generator().manual_seed(7), mode=mode)
    assert info.hidden_rotated and info.ov_rotated
    out = TLLM.decoder_forward(cfg, rot, torch.from_numpy(dec["toks"]))[0]
    np.testing.assert_allclose(out.numpy(), dec["ref"].numpy(), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("had,inter,split", [
    ("full", 96, False), ("full", 100, False), ("full", 96, True),
    ("block", 96, False), ("block", 256, False), ("block", 96, True)])
def test_online_hadamard_invariance(had, inter, split):
    """The folded online Hadamard (padded where 100 is no K·2^p or 96 no
    multiple of 128) and the RMS split leave the forward unchanged with the
    run-time transform on ``down``'s input; fp mode rejoins the split
    column on a model without the fold."""
    cfg_j = dataclasses.replace(CFG_J, intermediate=inter)
    pj = JLLM.init_decoder_params(cfg_j, jax.random.key(inter))
    pt = interop.to_torch(pj, device="cpu")
    cfg = _cfg_t(cfg_j)
    toks = np.asarray(jax.random.randint(jax.random.key(4), (1, 8), 0,
                                         cfg.vocab))
    ref = TLLM.decoder_forward(cfg, pt, torch.from_numpy(toks))[0]
    fused = TR.fuse_decoder(cfg, pt)
    rot, info = TR.rotate_decoder(cfg, fused, torch.Generator().manual_seed(5),
                                  online_had_down=True, online_had_mode=had)
    assert info.online_had_down and info.online_had_mode == had
    cfg2 = dataclasses.replace(cfg, intermediate_pad=info.down_pad)
    spec = TSpec(online_had=had, head_dim=128 if had == "block" else 0,
                 split=split)
    if split:
        rot = TR.split_decoder_down(rot)
        assert rot["layers"]["down"]["w_col0"].shape == (2, 1, cfg.hidden)
        plain = TR.split_decoder_down(fused)
        out_fp = TLLM.decoder_forward(cfg, plain, torch.from_numpy(toks))[0]
        np.testing.assert_allclose(out_fp.numpy(), ref.numpy(), rtol=2e-3,
                                   atol=2e-3)
    out = _fake(cfg2, rot, toks, {"llm.down": spec})
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-3, atol=2e-3)


def _vlm_spiced(params, seed):
    """Non-trivial LayerNorm / RMSNorm affines everywhere (the JAX test's
    ``spice``)."""
    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) and k.startswith("ln"):
                kk = jax.random.fold_in(jax.random.key(seed), len(out)
                                        + 17 * len(path))
                nv = {**v, "w": v["w"] + 0.2 * jax.random.normal(
                    kk, v["w"].shape)}
                if v.get("b") is not None:
                    nv["b"] = v["b"] + 0.1 * jax.random.normal(
                        jax.random.fold_in(kk, 1), v["b"].shape)
                out[k] = nv
            elif isinstance(v, dict):
                out[k] = walk(v, path + (k,))
            else:
                out[k] = v
        return out
    return walk(params, ())


@pytest.fixture(scope="module")
def vlm():
    cfg_j = JQ2.Qwen2VLConfig.tiny()
    pj = _vlm_spiced(JQ2.init_qwen2vl_params(cfg_j, jax.random.key(0)), 5)
    images = jax.random.normal(jax.random.key(1), (1, 16, 16, 3), jnp.float32)
    patches, grid = patchify_qwen2vl(images, patch=4)
    n_img = patches.shape[1] // 4
    toks = np.full((1, n_img + 6), 7, np.int64)
    toks[:, 3:3 + n_img] = cfg_j.image_token_id
    key = jax.random.key(7)
    k_v, _, k_l = jax.random.split(key, 3)
    Qv = JH.get_orthogonal_matrix(cfg_j.vit.width, "hadamard", k_v)
    Ql = JH.get_orthogonal_matrix(cfg_j.llm.hidden, "hadamard", k_l)
    return dict(cfg_j=cfg_j, cfg_t=TQ2.Qwen2VLConfig.tiny(), pj=pj,
                pt=interop.to_torch(pj, device="cpu"), toks=toks, key=key,
                patches=np.asarray(patches), grid=np.asarray(grid),
                rot={"vit": torch.from_numpy(np.asarray(Qv)),
                     "llm": torch.from_numpy(np.asarray(Ql))})


def _vlm_forward(v, params, specs=None, mode="fp"):
    return TQ2.qwen2vl_forward(
        v["cfg_t"], params, torch.from_numpy(v["toks"]),
        torch.from_numpy(v["patches"]), torch.from_numpy(v["grid"]),
        specs=specs, mode=mode)[0]


@pytest.mark.parametrize("kw", [
    dict(online_had_down=True, split_down=True),
    dict(online_had_down=True, online_had_mode="block", split_down=True,
         online_had_visual=True, split_visual=True),
    dict(rotate=False)])
def test_prepare_vlm_matches_jax(vlm, kw):
    """``prepare_vlm``'s qwen2vl branch leaf by leaf, with JAX's Q_v and
    Q_l (split from the key as JAX's ``prepare_vlm`` splits it) passed to
    the port."""
    pj, ij = JVR.prepare_vlm("qwen2vl", vlm["cfg_j"], vlm["pj"], vlm["key"],
                             **kw)
    pt, it = TVR.prepare_vlm("qwen2vl", vlm["cfg_t"], vlm["pt"],
                             rotations=vlm["rot"], **kw)
    _ulp_equal(pt, pj)
    assert set(it) == set(ij)
    for k in ij:
        if k == "llm":
            assert dataclasses.asdict(it[k]) == dataclasses.asdict(ij[k])
        else:
            assert it[k] == ij[k], k


def test_prepare_vlm_invariance(vlm):
    """The whole VLM's float logits before and after fuse → rotate →
    online Hadamard → split (the JAX test's 5e-3), fuse alone 2e-3."""
    ref = _vlm_forward(vlm, vlm["pt"])
    fused, _ = TVR.prepare_vlm("qwen2vl", vlm["cfg_t"], vlm["pt"],
                               rotate=False)
    np.testing.assert_allclose(_vlm_forward(vlm, fused).numpy(), ref.numpy(),
                               rtol=2e-3, atol=2e-3)
    prepared, _ = TVR.prepare_vlm("qwen2vl", vlm["cfg_t"], vlm["pt"],
                                  torch.Generator().manual_seed(7),
                                  online_had_down=True, split_down=True)
    assert prepared["llm"]["layers"]["down"].get("w_col0") is not None
    out = _vlm_forward(vlm, prepared,
                       {"llm.down": TSpec(online_had="full", split=True)},
                       "fake")
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=5e-3, atol=5e-3)


def test_other_families_raise(vlm):
    """The resampler families' branches are not ported (A12c); GLM-4V's
    is (``tests/test_torch_glm4v.py``)."""
    with pytest.raises(NotImplementedError, match="A12"):
        TVR.prepare_vlm("minicpmv", vlm["cfg_t"], vlm["pt"])
    assert "glm4v" in TVR._PRODUCER


def test_random_rotations_orthogonal():
    gen = torch.Generator().manual_seed(3)
    for mode in ("hadamard", "random"):
        Q = TH.get_orthogonal_matrix(96, mode, gen, device="cpu")
        np.testing.assert_allclose((Q @ Q.T).numpy(), np.eye(96), atol=1e-12)
    a = TH.random_hadamard_matrix(64, torch.Generator().manual_seed(1), "cpu")
    b = TH.random_hadamard_matrix(64, torch.Generator().manual_seed(1), "cpu")
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        TH.get_orthogonal_matrix(8, "nope", gen, device="cpu")
