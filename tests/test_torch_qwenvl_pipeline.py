"""The port's Qwen-VL family through its entry points, against the JAX
package's at ``QwenVLConfig.tiny()`` (f32, CPU): ``run_pipeline``, the
artifact, ``build_runner_from_artifact`` / ``VLMRunner`` (image and text
prompts, the resampler's pooled rows at the image tokens, 1-D positions),
the server (``build_server_from_artifact``) and dataset calibration. The
"k172" variant, the checkpoint loader's pipeline and the CLIs are in
``tests/test_torch_qwenvl_k172.py``, which runs this file's checks.

The pipelines start from JAX's params, calibration batches and rotations
(the packages draw from different RNGs; the resampler's Q_kv, Q_q, Q_o
from split(k_r, 3) as JAX's ``rotate_resampler`` draws them): "rtn" (RTN
LLM, realized, an int8 lm_head, two decode steps folded into the
calibration) and "gptq" (GPTQ without act_order on the LLM and, through
``visual_w_rtn=False``, on the patch embed, the tower and the resampler;
realized). Tolerances, those of ``tests/test_torch_glm4v_pipeline.py``:
integer codes bit-equal (every code in "rtn"; in "gptq" at least 99% a
site); float leaves within one bf16 ulp; static scales within rel 1e-5
("rtn") and 1e-3 ("gptq"): the two pipelines' scales part where their
calibration forwards do (ROADMAP C-w24,
:func:`test_static_scales_part_in_the_forward`). The RTN artifact's
params.msgpack is JAX's byte for byte; the port's ``save_artifact`` of a
loaded artifact writes JAX's files. Runner and server: on the same
artifact, greedy tokens equal to JAX's.
"""

import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mquant_tpu import pipeline as JP
from mquant_tpu.calib import calibrate as JCAL
from mquant_tpu.evaluation.adapter import VLMRunner as JRunner
from mquant_tpu.models.registry import get_family as j_family
from mquant_tpu.serve.server import build_runner_from_artifact as j_build
from mquant_tpu.serve.server import \
    build_server_from_artifact as j_build_server
from mquant_tpu.transform import hadamard as JH
from mquant_tpu.utils import checkpoint as JC
from mquant_tpu_torch import interop
from mquant_tpu_torch import pipeline as TP
from mquant_tpu_torch.calib import calibrate as TCAL
from mquant_tpu_torch.evaluation.adapter import VLMRunner as TRunner
from mquant_tpu_torch.models import qwenvl as TQ
from mquant_tpu_torch.serve.server import (build_runner_from_artifact,
                                           build_server_from_artifact)
from mquant_tpu_torch.utils import checkpoint as TC

from test_torch_internvl_pipeline import _batches_to_torch
from test_torch_pipeline import BF16_EPS, IdTokenizer, _leaves, _np
from test_torch_server import _png_url, _same

RTN = dict(llm_w_rtn=True, realize_int=True, lm_head_bits=8,
           calib_decode_steps=2)
CONFIGS = {"rtn": RTN, "gptq": dict(visual_w_rtn=False, realize_int=True)}
# "k172" (tests/test_torch_qwenvl_k172.py): the "rtn" flags at 172 · 2, the
# seeded order-172 block ⊗ H₂
INTERMEDIATE = {"k172": 344}
# four calibration batches of 4 + 32 tokens (144 token rows: full-rank
# Hessians at every LLM site); seed 4's text ids miss the image token
BASE = dict(calib_num=64, nsamples=8, seed=4)
# "gptq" calibrates on 32² images: 64 patches a batch, so the resampler's
# k / v Hessians (64 wide) are full-rank and the two packages' visual GPTQ
# codes, and with them the image rows the LLM's GPTQ sees, agree
IMAGE = {"gptq": 32}
STATE_RTOL = {"rtn": 1e-5, "gptq": 1e-3, "k172": 1e-5}
FILES = ("params.msgpack", "state.msgpack", "meta.json")
# the resampler's 6 sites, the patch embed and 2 blocks × 6 ViT sites
VIS_GPTQ_SITES = 6 + 1 + 2 * 6


def _cfgs(name):
    """JAX's and the port's tiny configs of a run (intermediate 344 for
    "k172")."""
    jc, tc = j_family("qwenvl").tiny_fn(), TQ.QwenVLConfig.tiny()
    inter = INTERMEDIATE.get(name)
    if inter:
        jc = dataclasses.replace(jc, llm=dataclasses.replace(
            jc.llm, intermediate=inter))
        tc = dataclasses.replace(tc, llm=dataclasses.replace(
            tc.llm, intermediate=inter))
    return jc, tc


def _jax_inputs(q, cfg, image_size=16):
    """JAX's run_pipeline inputs, drawn as it draws them: params from the
    seed's key, synthetic batches of ``image_size``² images from
    fold_in(key, 2), the rotations from
    split(fold_in(key, 1), 3) = (k_v, k_r, k_l), the resampler's from
    split(k_r, 3) = (Q_kv, Q_q, Q_o)."""
    fam = j_family("qwenvl")
    key = jax.random.key(q.seed)
    params = fam.init_fn(cfg, key)
    batches = JP.synthetic_calib_batches(
        fam, cfg, max(1, q.calib_num // 16), jax.random.fold_in(key, 2),
        image_size=image_size)
    for b in batches:
        n_img = int((np.asarray(b["tokens"]) == cfg.image_token_id).sum())
        assert n_img == b["tokens"].shape[0] * cfg.resampler.n_queries
    k_v, k_r, k_l = jax.random.split(jax.random.fold_in(key, 1), 3)
    W = cfg.resampler.width

    def orth(n, k):
        return JH.get_orthogonal_matrix(n, q.rotate_mode, k)

    rot = {"vit": orth(cfg.vit.width, k_v), "llm": orth(cfg.llm.hidden, k_l)}
    rot.update({f"res_{s}": orth(W, k)
                for s, k in zip(("kv", "q", "o"), jax.random.split(k_r, 3))})
    return params, batches, rot


def _capture(mod, log):
    """Wrap ``mod.finalize_state`` to record the (specs, merged stats) it
    gets."""
    saved = mod.finalize_state

    def wrapped(specs, stats, samples=None):
        log.append((specs, stats))
        return saved(specs, stats, samples)
    mod.finalize_state = wrapped
    return saved


def pipeline_pair(name, kw, tmp_path_factory):
    """Both packages' ``run_pipeline("Qwen-VL-Chat")`` from JAX's inputs
    at run ``name``'s config: the two artifact directories, the port's
    config and info, and each pipeline's (specs, merged calibration stats)
    as its ``finalize_state`` got them."""
    jc, tc = _cfgs(name)
    qj = JP.QuantizeConfig(**BASE, **kw)
    params, batches, rot = _jax_inputs(qj, jc, IMAGE.get(name, 16))
    art_j = str(tmp_path_factory.mktemp(f"{name}_jax"))
    art_t = str(tmp_path_factory.mktemp(f"{name}_port"))
    stats_j, stats_t = [], []
    saved = (_capture(JCAL, stats_j), _capture(TCAL, stats_t))
    try:
        JP.run_pipeline("Qwen-VL-Chat", qj, params=params, cfg=jc,
                        calib_batches=batches, artifact_dir=art_j)
        res = TP.run_pipeline(
            "Qwen-VL-Chat", TP.QuantizeConfig(**BASE, **kw),
            params=interop.to_torch(params, device="cpu"), cfg=tc,
            calib_batches=_batches_to_torch(batches), artifact_dir=art_t,
            rotations={k: torch.from_numpy(np.asarray(v))
                       for k, v in rot.items()}, device="cpu")
    finally:
        JCAL.finalize_state, TCAL.finalize_state = saved
    return dict(art_j=art_j, art_t=art_t, cfg=res[0], info=res[4],
                stats_j=stats_j[-1], stats_t=stats_t[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {name: pipeline_pair(name, kw, tmp_path_factory)
            for name, kw in CONFIGS.items()}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_artifact_matches_jax(runs, name):
    """The port's artifact, read by JAX's ``load_artifact``, against JAX's
    leaf by leaf; specs (the resampler's sites included), config and
    quantize config equal; the LLM and visual GPTQ without fallback."""
    check_artifact(runs[name], name)


def check_artifact(r, name):
    """:func:`test_artifact_matches_jax`'s checks on one run ``r``."""
    pj, sj, spj, mj = JC.load_artifact(r["art_j"])
    pt, st, spt, mt = JC.load_artifact(r["art_t"])
    assert spt == spj
    assert {f"res.{s}" for s in ("kv_proj", "q", "k", "v", "out",
                                 "proj_fc")} <= set(spt)
    cfg = TC.config_from_dict(mt["config_dict"])
    assert cfg == TC.config_from_dict(mj["config_dict"]) == r["cfg"]
    assert cfg.llm.intermediate_pad == 0 and cfg.vit.pre_norm
    assert cfg.llm.intermediate == INTERMEDIATE.get(name, 96)
    assert mt["quantize_config"] == mj["quantize_config"]
    assert mt["model"] == mj["model"] == "Qwen-VL-Chat"
    lj, lt = _leaves(pj), _leaves(pt)
    assert set(lt) == set(lj)
    assert "/vit/fc_sub_mean/w" in lt and "/res/pos_embed_kv/w" in lt
    low = {}
    for k in sorted(lj):
        if lj[k] is None:
            assert lt[k] is None, k
            continue
        a, b = np.asarray(lj[k]), np.asarray(lt[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if a.dtype.kind in "iu":
            agree = float((a == b).mean())
            if name != "gptq":
                np.testing.assert_array_equal(b, a, err_msg=k)
            elif agree < 0.99:
                low[k] = agree
            continue
        a, b = _np(a), _np(b)
        if name == "gptq" and k.startswith(("/vit/", "/res/")) and (
                "fc_sub_mean" not in k):
            continue  # GPTQ'd float weights: their codes below
        bound = BF16_EPS * np.maximum(np.abs(a), np.abs(b))
        assert (np.abs(a - b) <= bound).all(), k
    assert not low, f"code agreement below 99%: {low}"
    ls_j, ls_t = _leaves(sj), _leaves(st)
    assert set(ls_t) == set(ls_j)
    assert {k.split(".")[0] for k in ls_t} == {"/vis", "/res", "/llm"}
    for k in ls_j:
        if ls_j[k] is None:
            assert ls_t[k] is None, k
            continue
        np.testing.assert_allclose(np.asarray(ls_t[k]), np.asarray(ls_j[k]),
                                   rtol=STATE_RTOL[name], atol=0, err_msg=k)
    assert r["info"]["gptq"].get("fallbacks", []) == []
    assert r["info"]["gptq"].get("sites", 0) == (14 if name == "gptq" else 0)
    if name == "gptq":
        assert r["info"]["vis_gptq"] == {"fallbacks": [],
                                         "sites": VIS_GPTQ_SITES}


def test_static_scales_part_in_the_forward(runs):
    """Where the two pipelines' static scales part (C-w24): the port's
    ``finalize_state`` on JAX's merged calibration stats gives JAX's state
    bit for bit, and at every site whose merged min / max equal JAX's the
    port's own scale equals JAX's; the patch embed's stats (the raw
    patches, no arithmetic before them) are equal. What differs is the
    stats themselves: the float arithmetic of the calibration forwards."""
    r = runs["rtn"]
    (specs_j, sj), (specs, st) = r["stats_j"], r["stats_t"]
    assert set(sj) == set(st)
    state_j = JCAL.finalize_state(specs_j, sj)
    mine = TCAL.finalize_state(specs, {
        k: TCAL.O.ObserverStats(*(torch.from_numpy(np.array(x)) for x in v))
        for k, v in sj.items()})
    own = TCAL.finalize_state(specs, st)
    same_stats = []
    for k in sj:
        want = np.asarray(state_j[k]["act"].scale)
        np.testing.assert_array_equal(mine[k]["act"].scale.numpy(), want,
                                      err_msg=k)
        if all(np.array_equal(np.asarray(a), b.numpy())
               for a, b in zip(sj[k][:2], st[k][:2])):
            same_stats.append(k)
            np.testing.assert_array_equal(own[k]["act"].scale.numpy(), want,
                                          err_msg=k)
    assert "vis.patch_embed" in same_stats


def test_rtn_params_file_equals_jax(runs):
    """The RTN run's params.msgpack, as the port's pipeline wrote it, is
    JAX's byte for byte (the rotated ``fc_sub_mean``, queries and key
    position table included)."""
    params_file_equal(runs["rtn"])


def params_file_equal(r):
    assert filecmp.cmp(os.path.join(r["art_j"], "params.msgpack"),
                       os.path.join(r["art_t"], "params.msgpack"),
                       shallow=False)


def test_visual_gptq_codes_match_jax(runs):
    """The GPTQ'd visual weights: codes round(w / scale) on each site's
    per-channel W8 grid (from JAX's weight) equal to JAX's on ≥ 99%."""
    pj = JC.load_artifact(runs["gptq"]["art_j"])[0]
    pt = JC.load_artifact(runs["gptq"]["art_t"])[0]
    checked = 0
    for grp, sites in (("vit", ("patch_embed",)),
                       ("res", ("kv_proj", "q", "k", "v", "out", "proj_fc")),
                       ("blocks", ("q", "k", "v", "o", "fc1", "fc2"))):
        for s in sites:
            tj = (pj["vit"]["blocks"] if grp == "blocks" else pj[grp])[s]
            tt = (pt["vit"]["blocks"] if grp == "blocks" else pt[grp])[s]
            wj, wt = np.asarray(tj["w"], np.float64), np.asarray(tt["w"],
                                                                 np.float64)
            scale = np.abs(wj).max(axis=-2, keepdims=True) / 127
            scale[scale == 0] = 1
            agree = float((np.round(wj / scale) == np.round(wt / scale))
                          .mean())
            assert agree >= 0.99, (grp, s, agree)
            checked += 1
    assert checked == 13


def test_save_writes_jax_bytes(runs, tmp_path):
    """The port's ``save_artifact`` of JAX's artifact as it loaded it
    writes params.msgpack, state.msgpack and meta.json byte-equal to
    JAX's (``fc_sub_mean.b``, ``kv_proj.b`` and the other None leaves as
    JAX writes them)."""
    for name in CONFIGS:
        art = runs[name]["art_j"]
        pt, st, spt, mt = TC.load_artifact(art, device="cpu")
        assert pt["vit"]["fc_sub_mean"]["b"] is None
        out = str(tmp_path / name)
        TC.save_artifact(out, pt, st, spt, mt)
        for f in FILES:
            assert filecmp.cmp(os.path.join(art, f), os.path.join(out, f),
                               shallow=False), (name, f)


def _prompts():
    rng = np.random.default_rng(3)
    return [{"text": "what is this?",
             "image": rng.random((24, 24, 3)).astype(np.float32)},
            {"text": "describe", "image": rng.random((16, 40, 3)).astype(
                np.float32)},
            {"text": "a text-only prompt"}]


# where the "k172" runners part, the two decoders' logits may differ by
# up to this share of the step's largest logit: the int8 codes that the
# f32 Hadamard's sum orders flip before `down` move the tiny random model's
# logits by 1.3% of the largest at the one step that parts (measured on
# this file's artifacts)
FLIP_RTOL = 2e-2


def _parted_at_near_tie(rj, rt, prompt, out_t, out_j):
    """Where the two runners' greedy tokens part, JAX's tokens up to there
    fed to both runners' prefill: the step's logits agree within FLIP_RTOL
    of the largest, JAX's top two lie closer to each other than the two
    decoders' logits do, and the port's pick is JAX's second (a near tie
    the two roundings break apart)."""
    d = next(i for i, (a, b) in enumerate(zip(out_t, out_j)) if a != b)
    toks, enc = rj.build_inputs(prompt)
    from mquant_tpu.evaluation.adapter import _embed_with_quant
    emb = _embed_with_quant(rj.fam, rj.cfg, rj.params,
                            {"tokens": toks, "images": enc}, rj.specs,
                            rj.state, rj.mode)
    ids = np.asarray(out_j[:d], np.int64)
    if d:
        emb = jnp.concatenate([emb, rj.params["llm"]["embed"]["w"][ids][
            None].astype(emb.dtype)], axis=1)
    rj.gen.ensure_capacity(emb.shape[1] + 1)
    rt.gen.ensure_capacity(emb.shape[1] + 1)
    lj = np.asarray(rj.gen.prefill(emb)[0])[0]
    lt = rt.gen.prefill(torch.from_numpy(np.array(emb)))[0][0].numpy()
    top2 = np.argsort(-lj)[:2]
    noise = np.abs(lt - lj).max()
    assert noise <= FLIP_RTOL * np.abs(lj).max(), d
    assert lj[top2[0]] - lj[top2[1]] <= noise, (d, lj[top2], noise)
    assert out_t[d] == int(lt.argmax()) == top2[1], d


@pytest.mark.parametrize("name", list(CONFIGS))
def test_artifacts_serve_equal_tokens(runs, name):
    """JAX's and the port's artifact each served by both runners: equal
    greedy tokens (:func:`check_serving`)."""
    check_serving(runs[name], name)


def check_serving(r, name):
    """JAX's artifact and the port's, each served by JAX's runner and by
    the port's: equal greedy tokens for image prompts (two buckets: 16
    and 32 patches, 4 pooled rows each) and a text prompt; the port's
    engine gives its runner's own tokens. (The two pipelines' static
    scales differ in their last ulps, C-w24, which the tiny random model
    can turn into another token, so each artifact is held against itself
    in both runners.) In "k172" the f32 online Hadamard's 172-term sums
    run in each package's own order, which flips int8 codes before
    ``down``: there the runners may part, only at a near tie."""
    for art in (r["art_j"], r["art_t"]):
        rj = j_build(art, tokenizer=IdTokenizer(), max_len=96)
        rt = build_runner_from_artifact(art, tokenizer=IdTokenizer(),
                                        max_len=96, device="cpu")
        assert rt.mode == "real" and rt.fam.name == "qwenvl"
        outs = []
        for p in _prompts():
            out = rt.generate(p, max_new_tokens=8)
            want = rj.generate(p, max_new_tokens=8)
            if name == "k172" and out != want:
                _parted_at_near_tie(rj, rt, p, out, want)
            else:
                assert out == want
            outs.append(out)
    toks, encoded = rt.build_inputs(_prompts()[1])
    # 16 × 40 takes the 16 × 32 bucket: a 4 × 8 patch grid, pooled into
    # the resampler's 4 queries
    assert encoded[0][0].shape[1] == 32 and encoded[0][2] == 4
    assert int((toks == rt.cfg.image_token_id).sum()) == 4
    req = rt.engine_request(_prompts()[0])
    assert req["positions"] is None
    assert rt.serve_engine(_prompts(), max_new_tokens=8) == [
        rt.tok.decode(o) for o in outs]


def test_generate_batch_matches_jax(runs):
    """JAX's artifact's ragged batch: the port's runner gives JAX's
    runner's tokens."""
    rj = j_build(runs["rtn"]["art_j"], tokenizer=IdTokenizer(), max_len=96)
    rt = build_runner_from_artifact(runs["rtn"]["art_j"],
                                    tokenizer=IdTokenizer(), max_len=96,
                                    device="cpu")
    assert rt.generate_batch(_prompts(), max_new_tokens=6) == \
        rj.generate_batch(_prompts(), max_new_tokens=6)


def test_calib_batches_from_dataset_match_jax(runs):
    """Dataset calibration rows through the runner: tokens (Qwen-VL's chat
    template and its pooled image span), patches and the patch grid equal
    to JAX's."""
    from mquant_tpu.evaluation.adapter import \
        calib_batches_from_dataset as j_calib
    from mquant_tpu.evaluation.eval import build_dataset as j_dataset
    from mquant_tpu_torch.evaluation.adapter import \
        calib_batches_from_dataset as t_calib
    from mquant_tpu_torch.evaluation.eval import build_dataset as t_dataset

    pt, st, spt, mt = TC.load_artifact(runs["rtn"]["art_t"], device="cpu")
    cfg = TC.config_from_dict(mt["config_dict"])
    jcfg = JC.config_from_dict(mt["config_dict"])
    pj = JC.load_artifact(runs["rtn"]["art_j"])[0]
    bj = j_calib(JRunner("qwenvl", jcfg, pj), j_dataset("SyntheticVQA"), 3)
    bt = t_calib(TRunner("qwenvl", cfg, pt), t_dataset("SyntheticVQA"), 3)
    assert len(bt) == len(bj) == 3
    for a, b in zip(bt, bj):
        assert set(a) == set(b) == {"tokens", "patches", "grid"}
        assert a["grid"] == tuple(b["grid"])
        np.testing.assert_array_equal(a["tokens"].numpy(),
                                      np.asarray(b["tokens"]))
        np.testing.assert_array_equal(a["patches"].numpy(),
                                      np.asarray(b["patches"]))


@pytest.fixture(scope="module")
def server_pair(runs):
    pair = (j_build_server(runs["rtn"]["art_j"], slots=2, max_len=256,
                           port=0),
            build_server_from_artifact(runs["rtn"]["art_j"], slots=2,
                                       max_len=256, port=0, device="cpu"))
    yield pair
    for s in pair:
        s.shutdown()


def test_server_image_and_text_chat_match_jax(server_pair):
    """JAX's qwenvl artifact served by both servers (Qwen-VL's chat
    template): an image chat, a text chat and an id completion, each equal
    to JAX's server."""
    assert server_pair[1].model_name == "qwenvl"
    arr = (np.random.default_rng(0).random((24, 24, 3)) * 255).astype(
        np.uint8)
    st, out = _same(server_pair, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": [
            {"type": "text", "text": "what is this?"},
            {"type": "image_url", "image_url": {"url": _png_url(arr)}}]}],
        "max_tokens": 6})
    assert st == 200, out
    st, out = _same(server_pair, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hello"}], "max_tokens": 4})
    assert st == 200, out
    st, out = _same(server_pair, "/v1/completions",
                    {"prompt": list(range(1, 9)), "max_tokens": 5})
    assert st == 200, out
