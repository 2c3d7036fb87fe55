"""The deploy path at the tiny Qwen2-VL against the JAX package: an artifact
of the JAX pipeline (the three configurations of ``test_torch_artifact``,
one pipeline run each per module) through the port's
``build_runner_from_artifact(device="cpu")`` and through JAX's, and the
pieces the runner is made of: the fake path of ``qlinear``,
``dynamic_fake_quant``, ``qwen2vl_forward``, the chat template, the image
buckets and the registry.

Tolerances: the fake path's integer codes round as JAX's; the float sums
between them run in other orders (f32), so the prefill logits are held to
PREFILL_RTOL of their largest magnitude, and greedy tokens must be equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mquant_tpu.core import quant as JQ
from mquant_tpu.models import buckets as JB
from mquant_tpu.models import layers as JL
from mquant_tpu.models import qwen2vl as JQ2
from mquant_tpu.models import vision as JV
from mquant_tpu.models.registry import get_family as j_family
from mquant_tpu.serve import chat as JCH
from mquant_tpu.serve.server import build_runner_from_artifact as j_build
from mquant_tpu.utils import checkpoint as JC
from mquant_tpu_torch.core import quant as TQ
from mquant_tpu_torch.evaluation.adapter import ByteTokenizer, VLMRunner
from mquant_tpu_torch.models import buckets as TB
from mquant_tpu_torch.models import layers as TL
from mquant_tpu_torch.models import qwen2vl as TQ2
from mquant_tpu_torch.models import vision as TV
from mquant_tpu_torch.models.registry import get_family as t_family
from mquant_tpu_torch.serve import chat as TCH
from mquant_tpu_torch.serve.server import build_runner_from_artifact
from mquant_tpu_torch.utils import checkpoint as TC
from test_torch_artifact import ARTIFACT_CONFIGS, make_artifacts

PREFILL_RTOL = 1e-5
NAMES = list(ARTIFACT_CONFIGS)


class IdTokenizer(ByteTokenizer):
    """ByteTokenizer whose decode gives the token ids, so that the runners'
    outputs compare token for token."""

    def decode(self, ids):
        return [int(i) for i in ids]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    return make_artifacts(tmp_path_factory)


@pytest.fixture(scope="module")
def runners(artifacts):
    """name → (JAX runner, port runner) on the same artifact."""
    return {n: (j_build(a, tokenizer=IdTokenizer(), max_len=64),
                build_runner_from_artifact(a, tokenizer=IdTokenizer(),
                                           max_len=64, device="cpu"))
            for n, a in artifacts.items()}


def _image(seed, h=24, w=24, uint8=False):
    rng = np.random.default_rng(seed)
    img = rng.random((h, w, 3))
    return (img * 255).astype(np.uint8) if uint8 else img.astype(np.float32)


def _prompts():
    return [{"text": "what is this?", "image": _image(1)},
            {"text": "a text-only prompt, somewhat longer than the rest"},
            {"text": "and this one?", "image": _image(2, 16, 32)}]


def test_default_mode_follows_the_artifact(runners):
    assert runners["a_real_full"][1].mode == "real"
    assert runners["b_fake"][1].mode == "fake"
    assert runners["c_real_block_head8_vissplit"][1].mode == "real"
    # the LLM is held once, in the Generator's serving layout
    r = runners["a_real_full"][1]
    assert r.params["llm"] is r.gen.params
    assert "w_q_fused" in r.gen.params["layers"]["gate"]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("which", [0, 1, 2])
def test_generate_tokens_equal_jax(runners, name, which):
    """An image prompt, a text-only prompt and a 2:1 image (its own
    bucket): 8 greedy tokens through each package's runner."""
    rj, rt = runners[name]
    p = _prompts()[which]
    assert rt.generate(p, max_new_tokens=8) == rj.generate(
        p, max_new_tokens=8)


@pytest.mark.parametrize("name", NAMES)
def test_generate_batch_tokens_equal_jax(runners, name):
    """Three prompts (two with images, one text only) in one ragged batch,
    6 tokens each; each port row also equals the prompt served alone."""
    rj, rt = runners[name]
    ps = _prompts()
    got = rt.generate_batch(ps, max_new_tokens=6)
    assert got == rj.generate_batch(ps, max_new_tokens=6)
    assert got == [rt.generate(p, max_new_tokens=6) for p in ps]


def test_multi_image_prompt_equals_jax(runners):
    rj, rt = runners["a_real_full"]
    p = {"text": "compare them", "image": [_image(3), _image(4, 32, 16,
                                                             uint8=True)]}
    assert rt.generate(p, max_new_tokens=6) == rj.generate(p,
                                                           max_new_tokens=6)
    tj, _ = rj.build_inputs(p)
    tt, _ = rt.build_inputs(p)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))


@pytest.mark.parametrize("name", NAMES)
def test_prefill_logits_match_jax(runners, name):
    """The image prompt's spliced embeddings and prefill logits."""
    rj, rt = runners[name]
    p = _prompts()[0]
    tj, ej = rj.build_inputs(p)
    tt, et = rt.build_inputs(p)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    from mquant_tpu.evaluation.adapter import _embed_with_quant as j_embed

    gj = [e.pop("mrope_grid") for _, e, _ in ej]
    et_emb, pos = rt._embeds(tt, et)
    ej_emb = j_embed(rj.fam, rj.cfg, rj.params,
                     {"tokens": tj, "images": ej}, rj.specs, rj.state,
                     rj.mode)
    np.testing.assert_array_equal(
        pos, JQ2.mrope_positions(np.asarray(tj), rj.cfg.image_token_id,
                                 grid_thw=gj))
    mag = float(np.abs(np.asarray(ej_emb)).max())
    np.testing.assert_allclose(et_emb.numpy(), np.asarray(ej_emb), rtol=0,
                               atol=PREFILL_RTOL * mag)
    lj, _ = rj.gen.prefill(ej_emb, positions=jnp.asarray(pos))
    lt, _ = rt.gen.prefill(et_emb, positions=torch.from_numpy(pos))
    lj = np.asarray(lj)
    np.testing.assert_allclose(lt.numpy(), lj, rtol=0,
                               atol=PREFILL_RTOL * np.abs(lj).max())


def test_generate_eos_cut_equals_jax(artifacts):
    """The runner's eos cut: with eos the 4th token of the free run, both
    packages return the 3 tokens before it (the decode loop runs on past
    eos; ``generate`` drops the rest)."""
    art = artifacts["a_real_full"]
    p = _prompts()[0]
    free = IdTokenizer()
    free.eos_id = -1
    seq = build_runner_from_artifact(art, tokenizer=free, max_len=64,
                                     device="cpu").generate(p,
                                                            max_new_tokens=7)
    tok = IdTokenizer()
    tok.eos_id = seq[3]
    cut = seq[:seq.index(seq[3])]
    rt = build_runner_from_artifact(art, tokenizer=tok, max_len=64,
                                    device="cpu")
    rj = j_build(art, tokenizer=tok, max_len=64)
    assert rt.generate(p, max_new_tokens=7) == cut
    assert rj.generate(p, max_new_tokens=7) == cut


@pytest.mark.parametrize("name", NAMES)
def test_qwen2vl_forward_matches_jax(artifacts, name):
    """The whole-VLM forward (ViT → merger → splice → decoder logits at
    every position) on the artifact's weights in its serving mode."""
    art = artifacts[name]
    pj, sj, spj, mj = JC.load_artifact(art)
    pt, st, spt, mt = TC.load_artifact(art, device="cpu")
    cj = JC.config_from_dict(mj["config_dict"])
    ct = TC.config_from_dict(mt["config_dict"])
    mode = "real" if mj["quantize_config"]["realize_int"] else "fake"
    rng = np.random.default_rng(5)
    img = rng.normal(size=(1, 16, 16, 3)).astype(np.float32)
    toks = rng.integers(0, 200, size=(1, 12))
    toks[0, 2:6] = cj.image_token_id
    patches_j, grid_j = JV.patchify_qwen2vl(jnp.asarray(img), patch=cj.patch)
    patches_t, grid_t = TV.patchify_qwen2vl(torch.from_numpy(img),
                                            patch=ct.patch)
    pos = JQ2.mrope_positions(toks, cj.image_token_id, grid_thw=(1, 4, 4))
    lj, _, _ = JQ2.qwen2vl_forward(cj, pj, jnp.asarray(toks), patches_j,
                                   grid_j, specs=spj, state=sj, mode=mode,
                                   positions=jnp.asarray(pos))
    lt, cache, stats = TQ2.qwen2vl_forward(
        ct, pt, torch.from_numpy(toks), patches_t, grid_t, specs=spt,
        state=st, mode=mode, positions=torch.from_numpy(pos))
    assert cache is None and stats is None
    lj = np.asarray(lj)
    np.testing.assert_allclose(lt.numpy(), lj, rtol=0,
                               atol=PREFILL_RTOL * np.abs(lj).max())


# ---------------------------------------------------------------------------
# the fake path of qlinear and its quantizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("per_token", [True, False])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("bits,clip", [(8, 1.0), (4, 0.9)])
def test_dynamic_fake_quant_bit_equal_jax(per_token, symmetric, bits, clip):
    x = np.random.default_rng(6).normal(size=(2, 5, 24)).astype(np.float32)
    kw = dict(bits=bits, per_token=per_token, symmetric=symmetric,
              clip_ratio=clip)
    np.testing.assert_array_equal(
        TQ.dynamic_fake_quant(torch.from_numpy(x), **kw).numpy(),
        np.asarray(JQ.dynamic_fake_quant(jnp.asarray(x), **kw)))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    out = TQ.dynamic_fake_quant(xb, **kw)
    ref = JQ.dynamic_fake_quant(jnp.asarray(x, jnp.bfloat16), **kw)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref, np.float32))


def test_dynamic_fake_quant_groups_raise():
    """Per-token-per-group dynamic fake quantization (ported): bit-equal to
    JAX's, sym and asym, f32 and bf16."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(2, 3, 16)) + 0.3).astype(np.float32)
    for sym in (True, False):
        kw = dict(groupsize=4, symmetric=sym)
        np.testing.assert_array_equal(
            TQ.dynamic_fake_quant(torch.from_numpy(x), **kw).numpy(),
            np.asarray(JQ.dynamic_fake_quant(jnp.asarray(x), **kw)))
        out = TQ.dynamic_fake_quant(torch.from_numpy(x).bfloat16(), **kw)
        ref = JQ.dynamic_fake_quant(jnp.asarray(x, jnp.bfloat16), **kw)
        np.testing.assert_array_equal(out.float().numpy(),
                                      np.asarray(ref, np.float32))


def _site_cases():
    """(spec kwargs, split storage, static state): the fake path's
    branches: static per-tensor and dynamic per-token / per-tensor scales,
    asymmetric, the online Hadamard (full over 48 = 12·4, block 4×16), the
    RMS split, split storage rejoined where the spec has no split, and a
    static site whose calibration has not run (x passes through)."""
    base = dict(w_bits=8, a_bits=8)
    return [
        (dict(base, a_static=True), False, True),
        (dict(base, a_static=False), False, False),
        (dict(base, a_static=False, a_per_token=False), False, False),
        (dict(base, a_static=False, a_symmetric=False), False, False),
        (dict(base, a_static=True, a_symmetric=False), False, True),
        (dict(base, a_static=True, online_had="full", split=True), True,
         True),
        (dict(base, a_static=True, online_had="block", head_dim=16), False,
         True),
        (dict(base, a_static=True), True, True),
        (dict(base, a_static=True), False, False),
        (dict(w_bits=8, a_bits=None), False, False),
    ]


@pytest.mark.parametrize("mode", ["fake", "real"])
@pytest.mark.parametrize("case", range(len(_site_cases())))
def test_qlinear_fake_path_matches_jax(mode, case):
    """Float weights in "fake" mode, and in "real" mode on a site without
    ``w_q`` (an artifact's ViT): the JAX function's fake path."""
    spec_kw, split, static = _site_cases()[case]
    rng = np.random.default_rng(case)
    x = rng.normal(size=(2, 3, 48)).astype(np.float32)
    w = (rng.normal(size=(48, 20)) * 0.2).astype(np.float32)
    p = {"w": w, "b": (rng.normal(size=(20,)) * 0.1).astype(np.float32)}
    if split:
        p = {"w_col0": w[:1], "w": w[1:], "b": p["b"]}
    state = None
    if static:
        zp = 3.0 if spec_kw.get("a_symmetric") is False else None
        state = {"s": {"act": JQ.QuantParams(np.float32(0.02),
                                             None if zp is None
                                             else np.float32(zp))}}
    yj = JL.qlinear(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                    "s", JL.SiteSpec(**spec_kw), state, mode)
    st = None if state is None else {"s": {"act": TQ.QuantParams(
        torch.tensor(0.02), None if state["s"]["act"].zero_point is None
        else torch.tensor(3.0))}}
    yt = TL.qlinear(torch.from_numpy(x),
                    {k: torch.from_numpy(v) for k, v in p.items()}, "s",
                    TL.SiteSpec(**spec_kw), st, mode)
    yj = np.asarray(yj)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0,
                               atol=PREFILL_RTOL * np.abs(yj).max())


def test_fake_path_refusals():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 8)).astype(np.float32)
    w = rng.normal(size=(8, 4)).astype(np.float32)
    kw = dict(w_bits=8, a_bits=8, a_groupsize=4)
    yj = np.asarray(JL.qlinear(jnp.asarray(x), {"w": jnp.asarray(w)}, "s",
                               JL.SiteSpec(**kw), None, "fake"))
    np.testing.assert_allclose(  # per-group activations: ported
        TL.qlinear(torch.from_numpy(x), {"w": torch.from_numpy(w)}, "s",
                   TL.SiteSpec(**kw), None, "fake").numpy(), yj, rtol=0,
        atol=PREFILL_RTOL * np.abs(yj).max())
    with pytest.raises(ValueError, match="float weights"):
        TL.qlinear(torch.zeros(2, 8), {"w_q": torch.zeros(8, 4)}, "s",
                   TL.SiteSpec(w_bits=8, a_bits=8), None, "fake")
    with pytest.raises(NotImplementedError, match="A6"):
        TV.vit_forward(TQ2.Qwen2VLConfig.tiny().vit, {}, torch.zeros(1, 4, 96),
                       token_mask=torch.ones(1, 4))


def test_runner_refusals(artifacts):
    pt, st, spt, mt = TC.load_artifact(artifacts["a_real_full"],
                                       device="cpu")
    cfg = TC.config_from_dict(mt["config_dict"])
    with pytest.raises(NotImplementedError, match="A6"):
        VLMRunner("qwen2vl", cfg, pt, pad_to_max=True)
    for kvq in (True, 4):  # quantized KV caches: ported
        assert VLMRunner("qwen2vl", cfg, pt, kv_quant=kvq).gen.kv_quant == kvq
    with pytest.raises(NotImplementedError, match="A12"):
        VLMRunner("minicpmv", cfg, pt)


# ---------------------------------------------------------------------------
# the pieces copied from the JAX package's jax-free modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["qwen2vl", "qwenvl", "internvl",
                                    "minicpmv", "glm4v"])
@pytest.mark.parametrize("n_images", [0, 1, 3])
@pytest.mark.parametrize("history", [None, [("hi", "hello"), ("q", None)]])
def test_chat_prompt_equals_jax(family, n_images, history):
    enc = ByteTokenizer().encode
    kw = dict(system=None if n_images else "Be brief.", history=history,
              max_window_size=80, encode=enc)
    n = [5 + i for i in range(n_images)]
    assert TCH.build_multi_image_prompt(family, "what?", n, **kw) == \
        JCH.build_multi_image_prompt(family, "what?", n, **kw)


@pytest.mark.parametrize("hw,uint8", [((24, 24), False), ((16, 40), True),
                                      ((50, 20), False), ((7, 9), True)])
def test_prepare_image_equals_jax(hw, uint8):
    spec = JB.BucketSpec(patch=4, buckets=((16, 16), (16, 32), (32, 16),
                                           (32, 32)))
    img = _image(int(sum(hw)), *hw, uint8=uint8)
    oj, gj, mj = JB.prepare_image(img, spec)
    ot, gt, mt = TB.prepare_image(img, TB.BucketSpec(spec.patch,
                                                     spec.buckets))
    np.testing.assert_array_equal(ot, oj)
    assert gt == gj and mt is mj is None
    d = TB.BucketSpec.default()
    assert d == TB.BucketSpec(**dataclasses.asdict(JB.BucketSpec.default()))
    assert TB.max_bucket_tokens(d) == JB.max_bucket_tokens(
        JB.BucketSpec.default())
    with pytest.raises(NotImplementedError, match="A6"):
        TB.prepare_image(img, d, max_tokens=4096)


@pytest.mark.parametrize("name", ["qwen2vl", "Qwen2-VL-2B", "qwen2_vl_72b",
                                  "qwen2vl7b"])
def test_registry_matches_jax(name):
    assert t_family(name).name == j_family(name).name == "qwen2vl"


@pytest.mark.parametrize("name", ["Qwen-VL-Chat", "MiniCPM-V-2_6",
                                  "GLM-4V-9B"])
def test_registry_refuses_other_families(name):
    """MiniCPM-V raises A12c; GLM-4V's and Qwen-VL's names are ported and
    pick JAX's family."""
    assert j_family(name).name
    if name != "MiniCPM-V-2_6":
        assert t_family(name).name == j_family(name).name
        assert t_family(name).name in ("glm4v", "qwenvl")
    else:
        with pytest.raises(NotImplementedError, match="A12"):
            t_family(name)
    with pytest.raises(ValueError):
        t_family("llama")
