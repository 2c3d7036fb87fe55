"""The port's GLM-4V family (``mquant_tpu_torch.models.{glm4v,projectors,
llm}``, the family's branches of ``transform.vlm_recipes`` and
``gptq.modules``, the registry and the config codec) against the JAX
package's at ``GLM4VConfig.tiny()`` (f32, CPU), on the same numpy-drawn
inputs and JAX-initialized params handed to the port through
``interop.to_torch``. The params are "spiced": non-unit norms with biases,
q/k/v / conv biases and the boi / eoi rows off their init values, so each
fold and rotation is exercised.

ChatGLM's rotary (half of each head, interleaved (re, im) pairs) is held
bit-equal to JAX's ``_apply_rope`` in f32 and bf16, then through every
decoder path that applies it: prefill and decode steps into an fp or int8
cache (host, 0-d and per-row positions), the Generator's graph and eager
loops, the engine with and without speculation.

Tolerances, each the JAX tests' own: rotary, patches and integer codes
bit-equal; f32 forwards within 1e-5 of the largest magnitude (the slice's
rule, ``tests/test_torch_slice.py``); static activation stats within rel
1e-5; transformed trees within one ulp of each leaf
(``tests/test_torch_transforms.py``'s rule); the fused-and-rotated forward
against the fused one within 5e-3 (``tests/test_torch_internvl.py``'s
rule: the fusion and rotation are exact, the online Hadamard and the RMS
split round in f32).
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
from mquant_tpu.models import glm4v as JGL
from mquant_tpu.models import llm as JLLM
from mquant_tpu.models import projectors as JPR
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
from mquant_tpu_torch.models import glm4v as TGL
from mquant_tpu_torch.models import llm as TLLM
from mquant_tpu_torch.models import projectors as TPR
from mquant_tpu_torch.models import vision as TV
from mquant_tpu_torch.models.layers import SiteSpec as TSpec
from mquant_tpu_torch.models.registry import SUPPORTED_MODELS, family_of
from mquant_tpu_torch.models.registry import get_family as t_family
from mquant_tpu_torch.serve.generate import Generator as TGenerator
from mquant_tpu_torch.transform import vlm_recipes as TVR
from mquant_tpu_torch.utils import checkpoint as TC

from test_torch_engine import Model, _ids, assert_same
from test_torch_internvl import _codes, _spiced
from test_torch_transforms import _ulp_equal

RTOL = 1e-5
STATE_RTOL = 1e-5
IMG = 16  # a 4 × 4 patch grid at the tiny patch 4: 2 + 4 image tokens
GRID = (IMG // 4, IMG // 4)
GLM_ROPE = dict(rope_partial=0.5, rope_interleaved=True, rope_theta=10000.0)


@pytest.fixture(scope="module")
def tiny():
    jc = JGL.GLM4VConfig.tiny()
    tc = TGL.GLM4VConfig.tiny()
    pj = _spiced(JGL.init_glm4v_params(jc, jax.random.key(0)), 1)
    rng = np.random.default_rng(2)
    for t in ("boi", "eoi"):  # zero rows at init: spiced apart
        pj["proj"][t]["w"] = jnp.asarray(
            rng.standard_normal((1, jc.llm.hidden)).astype(np.float32))
    img = rng.standard_normal((1, IMG, IMG, 3)).astype(np.float32)
    n_img = 2 + (GRID[0] // 2) * (GRID[1] // 2)
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
                       ("proj", TPR.GLU_SITES),
                       ("llm", ("q", "k", "v", "o", "gate", "up", "down"))):
        for n in sites:
            s[f"{pre}.{n}"] = Spec(w_bits=w_bits, a_bits=8, a_static=True)
    return s


# ---------------------------------------------------------------------------
# configs and the registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["tiny", "glm4v_9b"])
def test_config_round_trips_both_ways(preset):
    """JAX's config dict → the port's config (the port's preset, the
    interleaved rotary included); the port's config dict → JAX's
    ``config_from_dict`` → JAX's preset."""
    cj = getattr(JGL.GLM4VConfig, preset)()
    ct = getattr(TGL.GLM4VConfig, preset)()
    back = TC.config_from_dict(json.loads(json.dumps(JC.config_to_dict(cj))))
    assert back == ct
    assert JC.config_from_dict(json.loads(json.dumps(
        TC.config_to_dict(ct)))) == cj
    assert ct.llm.rope_interleaved and ct.llm.rope_partial == 0.5
    assert ct.llm.n_heads // ct.llm.n_kv_heads == (16 if preset != "tiny"
                                                   else 2)


@pytest.mark.parametrize("name", ["GLM-4V-9B", "glm4v", "glm_4v"])
def test_registry_matches_jax(name):
    """The family a name picks, its presets, subsystems and the config's
    own family; the port's supported names all resolve (Qwen-VL-Chat's
    too), and the MiniCPM-V family still raises naming A12c."""
    fj, ft = j_family(name), t_family(name)
    assert ft.name == fj.name == "glm4v"
    assert ft.subsystems == fj.subsystems == ("vis", "proj", "llm")
    assert ft.config_fn() == TGL.GLM4VConfig.glm4v_9b()
    assert ft.tiny_fn() == TGL.GLM4VConfig.tiny()
    assert ft.forward_fn is TGL.glm4v_forward
    assert family_of(ft.tiny_fn()).name == "glm4v"
    assert "GLM-4V-9B" in SUPPORTED_MODELS
    assert [t_family(n).name for n in SUPPORTED_MODELS] == [
        j_family(n).name for n in SUPPORTED_MODELS]
    assert t_family("Qwen-VL-Chat").name == "qwenvl"
    for other in ("MiniCPM-V-2_6", "minicpm_v"):
        with pytest.raises(NotImplementedError, match="A12c"):
            t_family(other)


def test_init_params_layout():
    """The port's random params have JAX's tree: the same keys in the same
    order, shapes and dtypes (other values: another RNG)."""
    jc, tc = JGL.GLM4VConfig.tiny(), TGL.GLM4VConfig.tiny()
    pj = JGL.init_glm4v_params(jc, jax.random.key(0))
    pt = t_family("glm4v").init_fn(tc, torch.Generator().manual_seed(0),
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
    assert not pt["proj"]["boi"]["w"].any()


# ---------------------------------------------------------------------------
# ChatGLM's rotary
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("partial", [0.5, 1.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_interleaved_rope_bit_equal_to_jax(partial, dtype):
    """``_apply_rope`` with ``rope_interleaved`` on q (B, T, H, hd) and k
    (B, T, KVH, hd) at positions up to 4000, on JAX's tables: bit-equal to
    JAX's in f32 and bf16; the channels past rd pass through untouched."""
    kw = dict(vocab=64, hidden=256, n_layers=1, n_heads=4, n_kv_heads=2,
              intermediate=64, rope_partial=partial, rope_interleaved=True,
              rope_theta=10000.0)
    jc = JLLM.DecoderConfig(dtype=getattr(jnp, dtype), **kw)
    tc = TLLM.DecoderConfig(dtype=getattr(torch, dtype), **kw)
    rng = np.random.default_rng(5)
    pos = np.stack([np.arange(7), np.arange(3993, 4000)]).astype(np.int32)
    q = rng.standard_normal((2, 7, 4, 64)).astype(np.float32)
    k = rng.standard_normal((2, 7, 2, 64)).astype(np.float32)
    cj, sj = JLLM.rope_tables(jc, jnp.asarray(pos), jnp.float32)
    ct, st = (torch.from_numpy(np.array(t)) for t in (cj, sj))
    assert ct.shape == (2, 7, int(64 * partial))
    qj, kj = (jnp.asarray(a).astype(dtype) for a in (q, k))
    qt, kt = (torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in (qj, kj))
    oj = JLLM._apply_rope(jc, qj, kj, cj, sj)
    ot = TLLM._apply_rope(tc, qt, kt, ct, st)
    for a, b in zip(ot, oj):
        assert a.dtype == qt.dtype
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b.astype(jnp.float32)))
    rd = int(64 * partial)
    assert torch.equal(ot[0][..., rd:], qt[..., rd:])
    # pairs, not halves: rotate-half would give other values
    rh = TLLM._apply_rope(dataclasses.replace(tc, rope_interleaved=False),
                          qt, kt, ct, st)
    assert not torch.equal(rh[0], ot[0])


def _glm_model(seed):
    return Model(seed, **GLM_ROPE)


def _logits_close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=0,
                               atol=RTOL * np.abs(j).max())


@pytest.mark.parametrize("quantized", [False, 8])
@pytest.mark.parametrize("pos", ["device", "per_row"])
def test_decoder_paths_with_glm_rope_match_jax(quantized, pos):
    """A ChatGLM-flagged decoder (partial interleaved rotary): a fresh
    prefill then two decode steps into an fp or int8 cache, the position
    a 0-d or a per-row tensor, logits against JAX's; then the Generator's
    graph loop and eager loop give JAX's greedy tokens."""
    m = _glm_model(41)
    toks = np.random.default_rng(2).integers(0, 96, (2, 10))
    cj = JLLM.init_cache(m.jc, 2, 32, quantized=quantized)
    ct = TLLM.init_cache(m.tc, 2, 32, device="cpu", quantized=quantized)
    lj, cj, _ = JLLM.decoder_forward(m.jc, m.pj, jnp.asarray(toks[:, :8]),
                                     cache=cj, prefill_fresh=True)
    lt, ct, _ = TLLM.decoder_forward(m.tc, m.pt, torch.from_numpy(
        toks[:, :8]), cache=ct, prefill_fresh=True)
    _logits_close(lt, lj)
    if pos == "per_row":
        cj["pos"] = jnp.full((2,), 8, jnp.int32)
        ct["pos"] = torch.full((2,), 8, dtype=torch.int32)
    for i in (8, 9):
        lj, cj, _ = JLLM.decoder_forward(m.jc, m.pj,
                                         jnp.asarray(toks[:, i:i + 1]),
                                         cache=cj)
        lt, ct, _ = TLLM.decoder_forward(m.tc, m.pt, torch.from_numpy(
            toks[:, i:i + 1]), cache=ct)
        _logits_close(lt, lj)
    gj = JGenerator(m.jc, m.pj, max_len=64, kv_quant=quantized)
    gt = TGenerator(m.tc, m.pt, max_len=64, kv_quant=quantized)
    want = np.asarray(gj.generate_on_device(jnp.asarray(toks[:1]), 8))
    np.testing.assert_array_equal(
        gt.generate_on_device(torch.from_numpy(toks[:1]), 8).numpy(), want)
    lg, cache = gt.prefill(torch.from_numpy(toks[:1]))
    tok = lg.argmax(-1).to(torch.int32)[:, None]
    np.testing.assert_array_equal(
        gt._decode_loop(tok, cache, 8, None).numpy(), want)


@pytest.mark.parametrize("spec_k", [0, 3])
def test_engine_with_glm_rope_matches_jax(spec_k):
    """The engine's per-row positions and speculation's verify window over
    the ChatGLM rotary: a burst of three prompts equal to JAX's engine
    (tokens and logprobs) and each to the port's Generator alone."""
    m = _glm_model(42)
    prompts = [list(range(10, 22)) + [3, 1, 4], [7, 7, 8, 9, 7, 7, 8],
               list(range(40, 61))]
    out = assert_same(*m.engines(slots=3, max_len=128, steps_per_block=2,
                                 spec_k=spec_k, sample_top_k=0),
                      _ids(*prompts))
    for p, o in zip(prompts, out):
        assert o == m.solo(p, 7)


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["fp", "fake", "calib"])
def test_glu_projector_matches_jax(tiny, mode):
    """The GLU projector on ViT features (2 × 2 merge, conv, linear_proj,
    LayerNorm, GELU, silu(gate) · h_to_4h, 4h_to_h, [boi | x | eoi] / 8):
    in fp, fake (W8 weights, JAX's static state from a calib pass) and
    calib mode (the stats and samples of the five sites)."""
    jc, tc = tiny["jc"], tiny["tc"]
    x = np.random.default_rng(5).standard_normal((1, 16, 32)).astype(
        np.float32)
    kw_j = dict(specs=_specs(JSpec, 8 if mode == "fake" else None),
                mode=mode, collect_stats=mode == "calib",
                collect_samples=mode == "calib")
    kw_t = dict(kw_j, specs=_specs(TSpec, 8 if mode == "fake" else None))
    if mode == "fake":
        specs = _specs(JSpec)
        _, (stats, samples) = JPR.glu_projector_forward(
            jc.proj, tiny["pj"]["proj"], jnp.asarray(x), *GRID, specs=specs,
            mode="calib", collect_stats=True, collect_samples=True)
        sj = JCAL.finalize_state(specs, stats, samples)
        kw_j["state"] = sj
        kw_t["state"] = interop.to_torch(jax.tree.map(np.asarray, sj),
                                         device="cpu")
    yj, sj = JPR.glu_projector_forward(jc.proj, tiny["pj"]["proj"],
                                       jnp.asarray(x), *GRID, **kw_j)
    yt, st = TPR.glu_projector_forward(tc.proj, tiny["pt"]["proj"],
                                       torch.from_numpy(x), *GRID, **kw_t)
    assert yt.shape == (1, 2 + 4, 64)
    _close(yt, yj)
    _close(yt[:, 0], tiny["pt"]["proj"]["boi"]["w"] / 8.0)
    if mode == "calib":
        assert list(st[0]) == list(sj[0]) == [f"proj.{s}"
                                              for s in TPR.GLU_SITES]
        for k in sj[0]:
            for a, b in zip(st[0][k], sj[0][k]):
                _close(a, b, STATE_RTOL, k)
            _close(st[1][k], sj[1][k], what=k)


def _state(tiny):
    """JAX's static activation state of the tiny model, calibrated on the
    fixture's prompt, and the port's copy of it."""
    specs = _specs(JSpec)
    _, _, (stats, samples) = JGL.glm4v_forward(
        tiny["jc"], tiny["pj"], jnp.asarray(tiny["toks"]),
        tiny["patches_j"], GRID, specs=specs, mode="calib",
        collect_stats=True)
    sj = JCAL.finalize_state(specs, stats, samples)
    return sj, interop.to_torch(jax.tree.map(np.asarray, sj), device="cpu")


@pytest.mark.parametrize("mode", ["fp", "calib", "fake"])
def test_glm4v_forward_matches_jax(tiny, mode):
    """The end-to-end forward EVA2CLIP → GLU projector → splice of boi,
    the image rows and eoi → ChatGLM: logits in fp, calib (the stats of
    every subsystem's sites) and fake mode (W8 weights, JAX's calibrated
    static int8 activations); text-only too."""
    jc, tc = tiny["jc"], tiny["tc"]
    kw_j = dict(mode=mode, collect_stats=mode == "calib")
    kw_t = dict(kw_j)
    if mode != "fp":
        kw_j["specs"] = _specs(JSpec, None if mode == "calib" else 8)
        kw_t["specs"] = _specs(TSpec, None if mode == "calib" else 8)
    if mode == "fake":
        kw_j["state"], kw_t["state"] = _state(tiny)
    lj, _, sj = JGL.glm4v_forward(jc, tiny["pj"], jnp.asarray(tiny["toks"]),
                                  tiny["patches_j"], GRID, **kw_j)
    lt, _, st = TGL.glm4v_forward(tc, tiny["pt"],
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
    lj, _, _ = JGL.glm4v_forward(jc, tiny["pj"],
                                 jnp.asarray(tiny["toks"][:, 9:]), **kw_j)
    lt, _, _ = TGL.glm4v_forward(tc, tiny["pt"],
                                 torch.from_numpy(tiny["toks"][:, 9:]),
                                 **kw_t)
    _close(lt, lj)


def test_calibrate_state_matches_jax(tiny):
    """``calib.calibrate`` over the family's forward: the finalized static
    scales of every site within rel 1e-5."""
    sj, _ = _state(tiny)
    specs = _specs(TSpec)

    def fwd(b, collect_samples=False):
        logits, _, st = TGL.glm4v_forward(
            tiny["tc"], tiny["pt"], torch.from_numpy(tiny["toks"]),
            tiny["patches_t"], GRID, specs=specs, mode="calib",
            collect_stats=True, collect_samples=collect_samples)
        return logits, st

    st = TCAL.calibrate(fwd, [(None,)], specs)
    assert set(st) == set(sj)
    assert {f"proj.{s}" for s in TPR.GLU_SITES} <= set(st)
    for k in sj:
        _close(st[k]["act"].scale, sj[k]["act"].scale, STATE_RTOL, k)


# ---------------------------------------------------------------------------
# the transforms
# ---------------------------------------------------------------------------


def _rotations(jc, seed=7):
    """JAX's prepare_vlm draws: Q_v from split(key, 3)[0], Q_l from [2]
    (GLM-4V's tower takes no rotation)."""
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
    """The glm4v branch: the decoder fused and rotated, the tower neither
    (whatever the visual flags say), Q_l folded into proj.4h_to_h's output
    and the boi / eoi rows; leaf by leaf within one ulp, the same info."""
    jc, tc = tiny["jc"], tiny["tc"]
    rot = _rotations(jc)
    pj, ij = JVR.prepare_vlm("glm4v", jc, tiny["pj"], jax.random.key(7),
                             **kw)
    pt, it = TVR.prepare_vlm("glm4v", tc, tiny["pt"], rotations={
        k: torch.from_numpy(np.asarray(v)) for k, v in rot.items()}, **kw)
    _ulp_equal(pt, pj)
    assert set(it) == set(ij) and "vit_rotated" not in it
    if "llm" in ij:
        assert dataclasses.asdict(it["llm"]) == dataclasses.asdict(ij["llm"])
    assert pt["vit"] is tiny["pt"]["vit"]
    for s in ("conv", "linear_proj", "gate", "h_to_4h"):
        assert pt["proj"][s] is tiny["pt"]["proj"][s]


def test_prepare_vlm_keeps_the_fused_function(tiny):
    """The port's own invariance: the fused-and-rotated model in fake mode
    (only the online Hadamard and the RMS split on) against the fused
    model in fp, logits within 5e-3: the rotated boi / eoi rows and
    image rows enter the rotated stream."""
    tc = tiny["tc"]
    toks = torch.from_numpy(tiny["toks"])
    fused, _ = TVR.prepare_vlm("glm4v", tc, tiny["pt"], rotate=False)
    ref, _, _ = TGL.glm4v_forward(tc, fused, toks, tiny["patches_t"], GRID)
    prepared, _ = TVR.prepare_vlm("glm4v", tc, tiny["pt"],
                                  torch.Generator().manual_seed(7),
                                  online_had_down=True, split_down=True)
    out, _, _ = TGL.glm4v_forward(
        tc, prepared, toks, tiny["patches_t"], GRID,
        specs={"llm.down": TSpec(online_had="full", split=True)},
        mode="fake")
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=5e-3,
                               atol=5e-3)


# ---------------------------------------------------------------------------
# visual GPTQ of the GLU projector
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act_order", [False, True])
def test_gptq_quantize_glu_matches_jax(tiny, act_order, monkeypatch):
    """``gptq_quantize_glu`` over eight batches of ViT features of an 8 × 8
    patch grid (128 rows a site: full-rank Hessians), [conv] →
    [linear_proj] → [gate, h_to_4h] → [4h_to_h] at W8: every Hessian the
    port accumulates within rel 1e-5 of JAX's, and each site's walk given
    JAX's weight and Hessian held by ``tests/test_torch_gptq.py``'s rule:
    scales bit-equal, ≥ 99.9% of the codes equal, each difference one code
    (the two packages' f32 sums differ in their last bits)."""
    jc, tc = tiny["jc"], tiny["tc"]
    rng = np.random.default_rng(6)
    grid = (8, 8)
    xs = [rng.standard_normal((1, 64, 32)).astype(np.float32)
          for _ in range(8)]
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
    pj, rj = JGM.gptq_quantize_glu(
        jc, tiny["pj"], [(jnp.asarray(x), *grid) for x in xs], specs_j,
        JGM.GPTQConfig(act_order=act_order))
    pt, rt = TGM.gptq_quantize_glu(
        tc, tiny["pt"], [(torch.from_numpy(x), *grid) for x in xs], specs_t,
        TGM.GPTQConfig(act_order=act_order))
    monkeypatch.undo()
    assert rt == rj == {"fallbacks": [], "sites": 5}
    assert len(log_t) == len(log_j) == 5
    for (Wt, Ht, _), (Wj, Hj, resj), site in zip(log_t, log_j,
                                                  TPR.GLU_SITES):
        np.testing.assert_allclose(Ht, Hj, rtol=1e-5,
                                   atol=1e-5 * np.abs(Hj).max(),
                                   err_msg=site)
        if site == "conv":  # the first stage's weights are the float ones
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
        pt["proj"]["conv"]["w"].numpy(), log_t[0][2].w.numpy())
    assert pt["llm"] is tiny["pt"]["llm"]
