"""The port's GLM-4V family through its entry points, against the JAX
package's at ``GLM4VConfig.tiny()`` (f32, CPU): ``run_pipeline``, the
artifact, ``load_glm4v`` and ``run_pipeline(model_dir=)``,
``build_runner_from_artifact`` / ``VLMRunner`` (image and text prompts,
boi / eoi spans, 1-D positions), the server (``build_server_from_artifact``
and the CLI's ``--model glm4v --tiny``) and ``quant_vlm --model
GLM-4V-9B``.

The pipelines start from JAX's params, calibration batches and rotations
(the packages draw from different RNGs): "rtn" (RTN LLM, realized, an
int8 lm_head, two decode steps folded into the calibration), "gptq" (GPTQ
without act_order on the LLM and, through ``visual_w_rtn=False``, on the
patch embed, the tower and the GLU projector; realized) and "pad" (the
"rtn" flags on a decoder of intermediate 214, which the full online
Hadamard pads to 216 = 108 · 2 as it pads GLM-4V-9B's 13696 to 13824 =
108 · 128: ``intermediate_pad`` end to end). Tolerances, those of
``tests/test_torch_internvl_pipeline.py``: integer codes bit-equal (every
code in "rtn" and "pad"; in "gptq" at least 99% a site); float leaves
within one bf16 ulp; static scales within rel 1e-5 ("rtn", "pad") and
1e-3 ("gptq"). The RTN artifacts' params.msgpack are JAX's byte for byte;
the port's ``save_artifact`` of a loaded artifact writes JAX's files. The
loader: every leaf bit-equal to JAX's loader, on a checkpoint whose fused
q | k | v and gate | up halves all differ. Runner and server: on
the same artifact, greedy tokens equal to JAX's.
"""

import dataclasses
import filecmp
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mquant_tpu import pipeline as JP
from mquant_tpu.evaluation.adapter import VLMRunner as JRunner
from mquant_tpu.models import loader as JL
from mquant_tpu.models.registry import get_family as j_family
from mquant_tpu.serve.server import build_runner_from_artifact as j_build
from mquant_tpu.serve.server import \
    build_server_from_artifact as j_build_server
from mquant_tpu.transform import hadamard as JH
from mquant_tpu.utils import checkpoint as JC
from mquant_tpu_torch import interop
from mquant_tpu_torch import pipeline as TP
from mquant_tpu_torch.evaluation.adapter import VLMRunner as TRunner
from mquant_tpu_torch.models import glm4v as TGL
from mquant_tpu_torch.models import loader as TL
from mquant_tpu_torch.serve.server import (build_runner_from_artifact,
                                           build_server_from_artifact)
from mquant_tpu_torch.utils import checkpoint as TC
from mquant_tpu_torch.utils import safetensors as TST

from test_torch_internvl_pipeline import _batches_to_torch, _bit_equal
from test_torch_pipeline import BF16_EPS, IdTokenizer, _leaves, _np
from test_torch_server import _get, _post, _png_url, _same

RTN = dict(llm_w_rtn=True, realize_int=True, lm_head_bits=8,
           calib_decode_steps=2)
CONFIGS = {"rtn": RTN, "gptq": dict(visual_w_rtn=False, realize_int=True),
           "pad": RTN}
INTERMEDIATE = {"pad": 214}  # → 216 = 108 · 2 under the full Hadamard
# four calibration batches (152 token rows: full-rank Hessians at every
# LLM site but down's 216 padded rows); seed 4's text ids miss the image
# token in the tests' 64-bit mode
BASE = dict(calib_num=64, nsamples=8, seed=4)
STATE_RTOL = {"rtn": 1e-5, "gptq": 1e-3, "pad": 1e-5}
FILES = ("params.msgpack", "state.msgpack", "meta.json")
# the GLU projector's sites, the patch embed and 2 blocks × 6 ViT sites
VIS_GPTQ_SITES = 5 + 1 + 2 * 6


def _cfgs(name):
    """JAX's and the port's tiny configs of a run (intermediate 214 for
    "pad")."""
    jc, tc = j_family("glm4v").tiny_fn(), TGL.GLM4VConfig.tiny()
    inter = INTERMEDIATE.get(name)
    if inter:
        jc = dataclasses.replace(jc, llm=dataclasses.replace(
            jc.llm, intermediate=inter))
        tc = dataclasses.replace(tc, llm=dataclasses.replace(
            tc.llm, intermediate=inter))
    return jc, tc


def _jax_inputs(q, cfg):
    """JAX's run_pipeline inputs, drawn as it draws them: params from the
    seed's key, synthetic batches from fold_in(key, 2), the rotations from
    split(fold_in(key, 1), 3)."""
    fam = j_family("glm4v")
    key = jax.random.key(q.seed)
    params = fam.init_fn(cfg, key)
    batches = JP.synthetic_calib_batches(
        fam, cfg, max(1, q.calib_num // 16), jax.random.fold_in(key, 2))
    for b in batches:
        n_img = int((np.asarray(b["tokens"]) == cfg.image_token_id).sum())
        assert n_img == b["tokens"].shape[0] * (2 + 4)
    k_v, _, k_l = jax.random.split(jax.random.fold_in(key, 1), 3)
    rot = {"vit": JH.get_orthogonal_matrix(cfg.vit.width, q.rotate_mode, k_v),
           "llm": JH.get_orthogonal_matrix(cfg.llm.hidden, q.rotate_mode,
                                           k_l)}
    return params, batches, rot


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for name, kw in CONFIGS.items():
        jc, tc = _cfgs(name)
        qj = JP.QuantizeConfig(**BASE, **kw)
        params, batches, rot = _jax_inputs(qj, jc)
        art_j = str(tmp_path_factory.mktemp(f"{name}_jax"))
        art_t = str(tmp_path_factory.mktemp(f"{name}_port"))
        JP.run_pipeline("GLM-4V-9B", qj, params=params, cfg=jc,
                        calib_batches=batches, artifact_dir=art_j)
        res = TP.run_pipeline(
            "GLM-4V-9B", TP.QuantizeConfig(**BASE, **kw),
            params=interop.to_torch(params, device="cpu"), cfg=tc,
            calib_batches=_batches_to_torch(batches), artifact_dir=art_t,
            rotations={k: torch.from_numpy(np.asarray(v))
                       for k, v in rot.items()}, device="cpu")
        out[name] = dict(art_j=art_j, art_t=art_t, cfg=res[0], info=res[4])
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_artifact_matches_jax(runs, name):
    """The port's artifact, read by JAX's ``load_artifact``, against JAX's
    leaf by leaf; specs (the GLU sites included), config (the padded
    intermediate in "pad") and quantize config equal; the LLM and visual
    GPTQ without fallback."""
    r = runs[name]
    pj, sj, spj, mj = JC.load_artifact(r["art_j"])
    pt, st, spt, mt = JC.load_artifact(r["art_t"])
    assert spt == spj
    assert {"proj.conv", "proj.gate", "proj.4h_to_h"} <= set(spt)
    cfg = TC.config_from_dict(mt["config_dict"])
    assert cfg == TC.config_from_dict(mj["config_dict"]) == r["cfg"]
    assert cfg.llm.intermediate_pad == (216 if name == "pad" else 0)
    assert mt["quantize_config"] == mj["quantize_config"]
    assert mt["model"] == mj["model"] == "GLM-4V-9B"
    lj, lt = _leaves(pj), _leaves(pt)
    assert set(lt) == set(lj)
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
        if name == "gptq" and k.startswith(("/vit/", "/proj/")):
            continue  # GPTQ'd float weights: their codes below
        bound = BF16_EPS * np.maximum(np.abs(a), np.abs(b))
        assert (np.abs(a - b) <= bound).all(), k
    assert not low, f"code agreement below 99%: {low}"
    ls_j, ls_t = _leaves(sj), _leaves(st)
    assert set(ls_t) == set(ls_j)
    assert {k.split(".")[0] for k in ls_t} == {"/vis", "/proj", "/llm"}
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


def test_visual_gptq_codes_match_jax(runs):
    """The GPTQ'd visual weights: codes round(w / scale) on each site's
    per-channel W8 grid (from JAX's weight) equal to JAX's on ≥ 99%."""
    pj = JC.load_artifact(runs["gptq"]["art_j"])[0]
    pt = JC.load_artifact(runs["gptq"]["art_t"])[0]
    checked = 0
    for grp, sites in (("vit", ("patch_embed",)),
                       ("proj", ("conv", "linear_proj", "gate", "h_to_4h",
                                 "4h_to_h")),
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
    assert checked == 12


def test_save_writes_jax_bytes(runs, tmp_path):
    """The port's ``save_artifact`` of JAX's artifact as it loaded it
    writes params.msgpack, state.msgpack and meta.json byte-equal to
    JAX's (``proj.linear_proj.b`` and the other None leaves as JAX writes
    them)."""
    for name in CONFIGS:
        art = runs[name]["art_j"]
        pt, st, spt, mt = TC.load_artifact(art, device="cpu")
        assert pt["proj"]["linear_proj"]["b"] is None
        out = str(tmp_path / name)
        TC.save_artifact(out, pt, st, spt, mt)
        for f in FILES:
            assert filecmp.cmp(os.path.join(art, f), os.path.join(out, f),
                               shallow=False), (name, f)


@pytest.mark.parametrize("name", ["rtn", "pad"])
def test_rtn_params_file_equals_jax(runs, name):
    """The RTN runs' params.msgpack, as the port's pipeline wrote it, is
    JAX's byte for byte: the native intermediate and the padded one."""
    r = runs[name]
    assert filecmp.cmp(os.path.join(r["art_j"], "params.msgpack"),
                       os.path.join(r["art_t"], "params.msgpack"),
                       shallow=False)


def _prompts():
    rng = np.random.default_rng(3)
    return [{"text": "what is this?",
             "image": rng.random((24, 24, 3)).astype(np.float32)},
            {"text": "describe", "image": rng.random((16, 40, 3)).astype(
                np.float32)},
            {"text": "a text-only prompt"}]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_artifacts_serve_equal_tokens(runs, name):
    """JAX's artifact and the port's, each served by JAX's runner and by
    the port's: equal greedy tokens for image prompts (two buckets) and a
    text prompt; the port's batch and engine give its runner's own
    tokens. (The two pipelines' static scales differ in their last ulps,
    rel ≤ 4e-7, which the tiny random model can turn into another token,
    so each artifact is held against itself in both runners.)"""
    r = runs[name]
    for art in (r["art_j"], r["art_t"]):
        rj = j_build(art, tokenizer=IdTokenizer(), max_len=96)
        rt = build_runner_from_artifact(art, tokenizer=IdTokenizer(),
                                        max_len=96, device="cpu")
        assert rt.mode == "real" and rt.fam.name == "glm4v"
        outs = []
        for p in _prompts():
            out = rt.generate(p, max_new_tokens=8)
            assert out == rj.generate(p, max_new_tokens=8)
            outs.append(out)
    toks, encoded = rt.build_inputs(_prompts()[1])
    # 16 × 40 takes the 16 × 32 bucket: a 4 × 8 patch grid, 2 + 2 × 4
    # tokens (boi, the image rows, eoi)
    assert encoded[0][1] == {"grid": (4, 8)} and encoded[0][2] == 10
    assert int((toks == rt.cfg.image_token_id).sum()) == 10
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
    """Dataset calibration rows through the runner: tokens (GLM's chat
    template and boi / eoi span), patches and the patch grid equal to
    JAX's."""
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
    bj = j_calib(JRunner("glm4v", jcfg, pj), j_dataset("SyntheticVQA"), 3)
    bt = t_calib(TRunner("glm4v", cfg, pt), t_dataset("SyntheticVQA"), 3)
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
    """JAX's glm4v artifact served by both servers (GLM's chat template):
    an image chat, a text chat and an id completion, each equal to JAX's
    server."""
    assert server_pair[1].model_name == "glm4v"
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


def test_server_cli_tiny_glm4v():
    """``python -m mquant_tpu_torch.serve.server --model glm4v --tiny
    --device cpu --port 0`` serves the tiny GLM-4V: /health and an id
    completion of 4 tokens."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "mquant_tpu_torch.serve.server", "--model",
         "glm4v", "--tiny", "--device", "cpu", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        port = int(re.search(r"http://127\.0\.0\.1:(\d+)", line).group(1))
        st, body = _get(port, "/health")
        assert st == 200 and json.loads(body)["status"] == "ok"
        st, out = _post(port, "/v1/completions",
                        {"prompt": [1, 2, 3], "max_tokens": 4})
        assert st == 200 and len(out["choices"][0]["tokens"]) == 4
    finally:
        proc.kill()
        proc.communicate(timeout=30)


def test_quant_vlm_cli_glm4v(tmp_path):
    """``python -m mquant_tpu_torch.quant_vlm --model GLM-4V-9B --tiny``
    with the headline flags and visual GPTQ (the GLU projector's included)
    exits 0; its artifact serves."""
    art = str(tmp_path / "art")
    res = subprocess.run(
        [sys.executable, "-m", "mquant_tpu_torch.quant_vlm", "--model",
         "GLM-4V-9B", "--tiny", "--device", "cpu", "--rotate",
         "--online_llm_hadamard", "--llm_split", "--act_order",
         "--visual_w_gptq", "--calib_num", "32", "--nsamples", "8",
         "--realize_int", "--artifact", art],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    assert summary["gptq_sites"] == 14 and summary["gptq_fallbacks"] == []
    assert summary["visual_gptq_sites"] == VIS_GPTQ_SITES
    assert summary["visual_gptq_fallbacks"] == []
    runner = build_runner_from_artifact(art, tokenizer=IdTokenizer(),
                                        max_len=64, device="cpu")
    assert runner.fam.name == "glm4v"
    assert len(runner.generate(_prompts()[0], max_new_tokens=4)) == 4


# ---------------------------------------------------------------------------
# the HF checkpoint loader
# ---------------------------------------------------------------------------


def _hf_checkpoint(cfg, path, dtype=torch.bfloat16, seed=0):
    """A tiny HF GLM-4V checkpoint (ChatGLM + EVA2CLIP + GLU projector
    names and layouts) of random values, written with the port's
    safetensors writer as one file."""
    g = torch.Generator().manual_seed(seed)
    lc, vc, pc = cfg.llm, cfg.vit, cfg.proj
    H, KV, hd, Hd = lc.n_heads, lc.n_kv_heads, lc.head_dim, lc.hidden
    W, I, F = vc.width, lc.intermediate, pc.ffn_dim

    def r(*shape):
        return torch.randn(shape, generator=g).to(dtype)

    t = {"transformer.embedding.word_embeddings.weight": r(lc.vocab, Hd),
         "transformer.encoder.final_layernorm.weight": r(Hd),
         "transformer.output_layer.weight": r(lc.vocab, Hd)}
    for i in range(lc.n_layers):
        b = f"transformer.encoder.layers.{i}."
        t.update({
            b + "self_attention.query_key_value.weight":
                r((H + 2 * KV) * hd, Hd),
            b + "self_attention.query_key_value.bias": r((H + 2 * KV) * hd),
            b + "self_attention.dense.weight": r(Hd, H * hd),
            b + "input_layernorm.weight": r(Hd),
            b + "post_attention_layernorm.weight": r(Hd),
            b + "mlp.dense_h_to_4h.weight": r(2 * I, Hd),
            b + "mlp.dense_4h_to_h.weight": r(Hd, I)})
    vp = "transformer.vision."
    p = cfg.patch
    t.update({vp + "patch_embedding.proj.weight": r(W, 3, p, p),
              vp + "patch_embedding.proj.bias": r(W),
              vp + "patch_embedding.position_embedding.weight":
                  r(1 + vc.n_pos, W)})
    for i in range(vc.n_layers):
        b = f"{vp}transformer.layers.{i}."
        t.update({b + "attention.query_key_value.weight": r(3 * W, W),
                  b + "attention.query_key_value.bias": r(3 * W),
                  b + "attention.dense.weight": r(W, W),
                  b + "attention.dense.bias": r(W),
                  b + "input_layernorm.weight": r(W),
                  b + "input_layernorm.bias": r(W),
                  b + "post_attention_layernorm.weight": r(W),
                  b + "post_attention_layernorm.bias": r(W),
                  b + "mlp.fc1.weight": r(vc.mlp_width, W),
                  b + "mlp.fc1.bias": r(vc.mlp_width),
                  b + "mlp.fc2.weight": r(W, vc.mlp_width),
                  b + "mlp.fc2.bias": r(W)})
    t.update({vp + "conv.weight": r(Hd, W, 2, 2), vp + "conv.bias": r(Hd),
              vp + "linear_proj.linear_proj.weight": r(Hd, Hd),
              vp + "linear_proj.norm1.weight": r(Hd),
              vp + "linear_proj.norm1.bias": r(Hd),
              vp + "linear_proj.gate_proj.weight": r(F, Hd),
              vp + "linear_proj.dense_h_to_4h.weight": r(F, Hd),
              vp + "linear_proj.dense_4h_to_h.weight": r(Hd, F),
              vp + "boi": r(1, 1, Hd), vp + "eoi": r(1, 1, Hd)})
    os.makedirs(path, exist_ok=True)
    TST.save_file(t, os.path.join(path, "model.safetensors"),
                  metadata={"format": "pt"})
    return t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_glm4v_bit_equal_to_jax(tmp_path, dtype):
    """``load_model("glm4v", ...)`` against JAX's loader on the same
    checkpoint: every leaf bit-equal (f32 and bf16 trees); the fused
    ``query_key_value`` split as [q | k | v] rows and biases,
    ``dense_h_to_4h`` as [gate | up], the EVA qkv in thirds, the cls row
    of the position table dropped, boi / eoi as (1, hidden) rows."""
    jc = j_family("glm4v").tiny_fn()
    tc = TGL.GLM4VConfig.tiny()
    t = _hf_checkpoint(tc, str(tmp_path))
    pj = JL.load_model("glm4v", jc, str(tmp_path), dtype=getattr(jnp, dtype))
    pt = TL.load_model("glm4v", tc, str(tmp_path),
                       dtype=getattr(torch, dtype), device="cpu")
    _bit_equal(pt, pj)
    dt = getattr(torch, dtype)
    lc = tc.llm
    H, KV, hd, I = lc.n_heads, lc.n_kv_heads, lc.head_dim, lc.intermediate
    b = "transformer.encoder.layers.1."
    qkv = t[b + "self_attention.query_key_value.weight"].to(dt)
    qkvb = t[b + "self_attention.query_key_value.bias"].to(dt)
    lay = pt["llm"]["layers"]
    rows = [0, H * hd, (H + KV) * hd, (H + 2 * KV) * hd]
    for s, (lo, hi) in zip("qkv", zip(rows, rows[1:])):
        assert torch.equal(lay[s]["w"][1].T, qkv[lo:hi]), s
        assert torch.equal(lay[s]["b"][1], qkvb[lo:hi]), s
    assert not torch.equal(lay["k"]["w"][1], lay["v"]["w"][1])
    h4 = t[b + "mlp.dense_h_to_4h.weight"].to(dt)
    assert torch.equal(lay["gate"]["w"][1].T, h4[:I])
    assert torch.equal(lay["up"]["w"][1].T, h4[I:])
    vp = "transformer.vision."
    pos = t[vp + "patch_embedding.position_embedding.weight"]
    assert torch.equal(pt["vit"]["pos_embed"]["w"], pos[1:].to(dt))
    assert torch.equal(pt["proj"]["eoi"]["w"], t[vp + "eoi"][0].to(dt))
    conv = t[vp + "conv.weight"].to(dt)  # (out, C, 2, 2) → (2·2·C, out)
    w = pt["proj"]["conv"]["w"].reshape(2, 2, -1, lc.hidden)
    assert torch.equal(w[1, 0], conv[:, :, 1, 0].T)


def test_run_pipeline_from_checkpoint(tmp_path):
    """``run_pipeline("GLM-4V-9B", model_dir=...)`` loads through
    ``load_glm4v`` (a "load" stage), quantizes and serves its
    artifact."""
    tc = TGL.GLM4VConfig.tiny()
    _hf_checkpoint(tc, str(tmp_path / "ckpt"), dtype=torch.float32)
    art = str(tmp_path / "art")
    _, params, state, specs, info = TP.run_pipeline(
        "GLM-4V-9B", TP.QuantizeConfig(calib_num=16, nsamples=4,
                                       realize_int=True),
        model_dir=str(tmp_path / "ckpt"), tiny=True, artifact_dir=art,
        device="cpu")
    assert "load" in info["stages"] and info["gptq"]["fallbacks"] == []
    runner = build_runner_from_artifact(art, tokenizer=IdTokenizer(),
                                        max_len=64, device="cpu")
    assert len(runner.generate(_prompts()[0], max_new_tokens=3)) == 3
