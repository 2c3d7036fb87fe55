"""The port's InternVL2 family through its entry points, against the JAX
package's at ``InternVLConfig.tiny()`` (f32, CPU): ``run_pipeline``, the
artifact, ``load_internvl`` and ``run_pipeline(model_dir=)``,
``build_runner_from_artifact`` / ``VLMRunner`` (image and text prompts,
1-D positions), the server (``build_server_from_artifact`` and the CLI's
``--model internvl --tiny``) and ``quant_vlm --model InternVL2-8B``.

The pipelines start from JAX's params, calibration batches and rotations
(the packages draw from different RNGs): "rtn" (RTN LLM, realized, an
int8 lm_head, two decode steps folded into the calibration) and "gptq"
(GPTQ without act_order on the LLM and, through ``visual_w_rtn=False``,
on the patch embed, the tower and mlp1; realized). Tolerances: integer
codes bit-equal (every code in "rtn"; in "gptq" at least 99% a site, the
tower's f32 sums running in other orders); float leaves within one bf16
ulp (measured: equal); static scales within rel 1e-5 ("rtn") and 1e-3
("gptq"), as ``tests/test_torch_pipeline.py`` holds Qwen2-VL. The port's
``save_artifact`` of a loaded artifact writes JAX's files byte for byte.
The loader: every leaf bit-equal to JAX's loader, on a checkpoint whose
``wqkv`` GQA groups all differ. Runner and server: greedy tokens equal to
JAX's.
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
from mquant_tpu_torch.models import internvl as TI
from mquant_tpu_torch.models import loader as TL
from mquant_tpu_torch.serve.server import (build_runner_from_artifact,
                                           build_server_from_artifact)
from mquant_tpu_torch.utils import checkpoint as TC
from mquant_tpu_torch.utils import safetensors as TST

from test_torch_pipeline import BF16_EPS, IdTokenizer, _leaves, _np
from test_torch_server import _get, _png_url, _post, _same

CONFIGS = {
    "rtn": dict(llm_w_rtn=True, realize_int=True, lm_head_bits=8,
                calib_decode_steps=2),
    "gptq": dict(visual_w_rtn=False, realize_int=True),
}
BASE = dict(calib_num=32, nsamples=8)
STATE_RTOL = {"rtn": 1e-5, "gptq": 1e-3}
FILES = ("params.msgpack", "state.msgpack", "meta.json")


def _batches_to_torch(batches):
    """JAX's batches on the CPU; the patch grid stays a (gh, gw) tuple."""
    return [{k: v if k == "grid" else interop.to_torch(v, device="cpu")
             for k, v in b.items()} for b in batches]


def _jax_inputs(q):
    """JAX's run_pipeline inputs, drawn as it draws them: params from the
    seed's key, synthetic batches from fold_in(key, 2), the rotations from
    split(fold_in(key, 1), 3). Seed 2's text ids miss the image token (in the
    tests' 64-bit mode)."""
    fam = j_family("internvl")
    cfg = fam.tiny_fn()
    key = jax.random.key(q.seed)
    params = fam.init_fn(cfg, key)
    batches = JP.synthetic_calib_batches(
        fam, cfg, max(1, q.calib_num // 16), jax.random.fold_in(key, 2))
    for b in batches:
        n_img = int((np.asarray(b["tokens"]) == cfg.image_token_id).sum())
        assert n_img == b["tokens"].shape[0] * 4
    k_v, _, k_l = jax.random.split(jax.random.fold_in(key, 1), 3)
    rot = {"vit": JH.get_orthogonal_matrix(cfg.vit.width, q.rotate_mode, k_v),
           "llm": JH.get_orthogonal_matrix(cfg.llm.hidden, q.rotate_mode,
                                           k_l)}
    return params, batches, rot


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for name, kw in CONFIGS.items():
        qj = JP.QuantizeConfig(**BASE, **kw, seed=2)
        params, batches, rot = _jax_inputs(qj)
        art_j = str(tmp_path_factory.mktemp(f"{name}_jax"))
        art_t = str(tmp_path_factory.mktemp(f"{name}_port"))
        JP.run_pipeline("InternVL2-8B", qj, params=params,
                        calib_batches=batches, tiny=True, artifact_dir=art_j)
        res = TP.run_pipeline(
            "InternVL2-8B", TP.QuantizeConfig(**BASE, **kw, seed=2),
            params=interop.to_torch(params, device="cpu"),
            calib_batches=_batches_to_torch(batches), tiny=True,
            artifact_dir=art_t,
            rotations={k: torch.from_numpy(np.asarray(v))
                       for k, v in rot.items()}, device="cpu")
        out[name] = dict(art_j=art_j, art_t=art_t, info=res[4])
    return out


OPTIONS = dict(smooth_alpha=0.5, online_had_mode="auto", lm_head_bits="auto",
               auto_bits=5.0, visual_w_rtn=False, realize_int=True,
               calib_num=32, nsamples=8, seed=2)


def test_gates_decide_alike():
    """SmoothQuant, the online-Hadamard gate (both candidates: intermediate
    256), the head gate and auto bits over the proj sites too, in both
    packages from the same params, batches and rotations: the same picks
    (the gate's errors within rel 1e-3), the same bit allocation and
    specs, no GPTQ fallback, codes ≥ 99% equal in the first layer and
    ≥ 70% after it (``tests/test_torch_pipeline_options.py``'s rule)."""
    qj = JP.QuantizeConfig(**OPTIONS)
    fam = j_family("internvl")
    jc = fam.tiny_fn()
    jc = dataclasses.replace(jc, llm=dataclasses.replace(jc.llm,
                                                         intermediate=256))
    tc = TI.InternVLConfig.tiny()
    tc = dataclasses.replace(tc, llm=dataclasses.replace(tc.llm,
                                                         intermediate=256))
    key = jax.random.key(qj.seed)
    params = fam.init_fn(jc, key)
    batches = JP.synthetic_calib_batches(fam, jc, 2,
                                         jax.random.fold_in(key, 2))
    k_v, _, k_l = jax.random.split(jax.random.fold_in(key, 1), 3)
    rot = {"vit": JH.get_orthogonal_matrix(jc.vit.width, "hadamard", k_v),
           "llm": JH.get_orthogonal_matrix(jc.llm.hidden, "hadamard", k_l)}
    _, pj, _, spj, ij = JP.run_pipeline("InternVL2-8B", qj, params=params,
                                        cfg=jc, calib_batches=batches)
    with torch.no_grad():
        _, pt, _, spt, it = TP.run_pipeline(
            "InternVL2-8B", TP.QuantizeConfig(**OPTIONS),
            params=interop.to_torch(params, device="cpu"), cfg=tc,
            calib_batches=_batches_to_torch(batches),
            rotations={k: torch.from_numpy(np.asarray(v))
                       for k, v in rot.items()}, device="cpu")
    assert it["smooth_alpha"] == ij["smooth_alpha"] == 0.5
    hj, ht = ij["online_had_auto"], it["online_had_auto"]
    assert ht["picked"] == hj["picked"] and set(ht) == {"picked", "full",
                                                        "block"}
    for k in ("full", "block"):
        assert abs(ht[k] - hj[k]) <= 1e-3 * hj[k], (ht, hj)
    assert it["lm_head_bits"] == ij["lm_head_bits"]
    assert it["autobits"] == ij["autobits"]
    assert {"proj.fc1", "proj.fc2"} <= set(it["autobits"])
    assert {k: dataclasses.asdict(v) for k, v in spt.items()} == {
        k: dataclasses.asdict(v) for k, v in spj.items()}
    assert it["gptq"]["fallbacks"] == [] and it["vis_gptq"] == {
        "fallbacks": [], "sites": 15}
    lay_j, lay_t = pj["llm"]["layers"], pt["llm"]["layers"]
    for s in ("q", "k", "v", "o", "gate", "up", "down"):
        a, b = np.asarray(lay_j[s]["w_q"]), lay_t[s]["w_q"].numpy()
        for li in range(a.shape[0]):
            agree = float((a[li] == b[li]).mean())
            assert agree >= (0.99 if li == 0 else 0.7), (s, li, agree)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_artifact_matches_jax(runs, name):
    """The port's artifact, read by JAX's ``load_artifact``, against JAX's
    leaf by leaf; specs (the proj sites included), config and quantize
    config equal; the LLM and visual GPTQ without fallback."""
    r = runs[name]
    pj, sj, spj, mj = JC.load_artifact(r["art_j"])
    pt, st, spt, mt = JC.load_artifact(r["art_t"])
    assert spt == spj
    assert {"proj.fc1", "proj.fc2", "proj.conv"} <= set(spt)
    # the port's configs lack JAX's unported fields: equal once decoded
    assert TC.config_from_dict(mt["config_dict"]) == TC.config_from_dict(
        mj["config_dict"]) == TI.InternVLConfig.tiny()
    assert mt["quantize_config"] == mj["quantize_config"]
    assert mt["model"] == mj["model"] == "InternVL2-8B"
    lj, lt = _leaves(pj), _leaves(pt)
    assert set(lt) == set(lj)
    assert any(k.startswith("/proj/") for k in lj)
    low = {}
    for k in sorted(lj):
        if lj[k] is None:
            assert lt[k] is None, k
            continue
        a, b = np.asarray(lj[k]), np.asarray(lt[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if a.dtype.kind in "iu":
            agree = float((a == b).mean())
            if name == "rtn":
                np.testing.assert_array_equal(b, a, err_msg=k)
            elif agree < 0.99:
                low[k] = agree
            continue
        a, b = _np(a), _np(b)
        if name == "gptq" and k.startswith(("/vit/", "/proj/")):
            # GPTQ'd float weights: their codes on the site's grid
            continue
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
        # patch embed, 2 blocks × 6 sites, mlp1's fc1 and fc2
        assert r["info"]["vis_gptq"] == {"fallbacks": [], "sites": 15}


def test_visual_gptq_codes_match_jax(runs):
    """The GPTQ'd visual weights: codes round(w / scale) on each site's
    per-channel W8 grid (from JAX's weight) equal to JAX's on ≥ 99%."""
    pj = JC.load_artifact(runs["gptq"]["art_j"])[0]
    pt = JC.load_artifact(runs["gptq"]["art_t"])[0]
    checked = 0
    for grp, sites in (("vit", ("patch_embed",)), ("proj", ("fc1", "fc2")),
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
    assert checked == 9


def test_save_writes_jax_bytes(runs, tmp_path):
    """The port's ``save_artifact`` of JAX's artifact as it loaded it
    writes params.msgpack, state.msgpack and meta.json byte-equal to
    JAX's."""
    for name in CONFIGS:
        art = runs[name]["art_j"]
        pt, st, spt, mt = TC.load_artifact(art, device="cpu")
        out = str(tmp_path / name)
        TC.save_artifact(out, pt, st, spt, mt)
        for f in FILES:
            assert filecmp.cmp(os.path.join(art, f), os.path.join(out, f),
                               shallow=False), (name, f)


def test_rtn_params_file_equals_jax(runs):
    """The RTN run's params.msgpack, as the port's pipeline wrote it, is
    JAX's byte for byte (the same tree in the same order: codes, scales
    and float leaves equal)."""
    r = runs["rtn"]
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
    """A runner on the port's artifact (the port's runner) and one on
    JAX's (JAX's runner): equal greedy tokens for image prompts (two
    buckets) and a text prompt, and the batch and the engine give the
    runner's own tokens."""
    r = runs[name]
    rj = j_build(r["art_j"], tokenizer=IdTokenizer(), max_len=96)
    rt = build_runner_from_artifact(r["art_t"], tokenizer=IdTokenizer(),
                                    max_len=96, device="cpu")
    assert rt.mode == "real" and rt.fam.name == "internvl"
    outs = []
    for p in _prompts():
        out = rt.generate(p, max_new_tokens=8)
        assert out == rj.generate(p, max_new_tokens=8)
        outs.append(out)
    toks, encoded = rt.build_inputs(_prompts()[1])
    # 16 × 40 takes the 16 × 32 bucket: a 4 × 8 patch grid, 2 × 4 tokens
    assert encoded[0][1] == {"grid": (4, 8)} and encoded[0][2] == 8
    req = rt.engine_request(_prompts()[0])
    assert req["positions"] is None
    assert rt.serve_engine(_prompts(), max_new_tokens=8) == [
        rt.tok.decode(o) for o in outs]


def test_generate_batch_matches_jax(runs):
    rj = j_build(runs["rtn"]["art_j"], tokenizer=IdTokenizer(), max_len=96)
    rt = build_runner_from_artifact(runs["rtn"]["art_t"],
                                    tokenizer=IdTokenizer(), max_len=96,
                                    device="cpu")
    assert rt.generate_batch(_prompts(), max_new_tokens=6) == \
        rj.generate_batch(_prompts(), max_new_tokens=6)


def test_calib_batches_from_dataset_match_jax(runs):
    """Dataset calibration rows through the runner: tokens, patches and
    the patch grid equal to JAX's."""
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
    bj = j_calib(JRunner("internvl", jcfg, pj), j_dataset("SyntheticVQA"), 3)
    bt = t_calib(TRunner("internvl", cfg, pt), t_dataset("SyntheticVQA"), 3)
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
            build_server_from_artifact(runs["rtn"]["art_t"], slots=2,
                                       max_len=256, port=0, device="cpu"))
    yield pair
    for s in pair:
        s.shutdown()


def test_server_image_and_text_chat_match_jax(server_pair):
    """The served internvl artifact: an image chat (its engine request with
    no M-RoPE positions), a text chat and an id completion, each equal to
    JAX's server."""
    assert server_pair[1].model_name == "internvl"
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


def test_server_cli_tiny_internvl():
    """``python -m mquant_tpu_torch.serve.server --model internvl --tiny
    --device cpu --port 0`` serves the tiny InternVL2: /health and an id
    completion of 4 tokens."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "mquant_tpu_torch.serve.server", "--model",
         "internvl", "--tiny", "--device", "cpu", "--port", "0"],
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


def test_quant_vlm_cli_internvl(tmp_path):
    """``python -m mquant_tpu_torch.quant_vlm --model InternVL2-8B --tiny``
    with the headline flags and visual GPTQ exits 0; its artifact serves."""
    art = str(tmp_path / "art")
    res = subprocess.run(
        [sys.executable, "-m", "mquant_tpu_torch.quant_vlm", "--model",
         "InternVL2-8B", "--tiny", "--device", "cpu", "--rotate",
         "--online_llm_hadamard", "--llm_split", "--act_order",
         "--visual_w_gptq", "--calib_num", "32", "--nsamples", "8",
         "--realize_int", "--artifact", art],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    assert summary["gptq_sites"] == 14 and summary["gptq_fallbacks"] == []
    assert summary["visual_gptq_sites"] == 15
    runner = build_runner_from_artifact(art, tokenizer=IdTokenizer(),
                                        max_len=64, device="cpu")
    assert runner.fam.name == "internvl"
    assert len(runner.generate(_prompts()[0], max_new_tokens=4)) == 4


# ---------------------------------------------------------------------------
# the HF checkpoint loader
# ---------------------------------------------------------------------------


def _hf_checkpoint(cfg, path, dtype=torch.bfloat16, seed=0):
    """A tiny HF InternVL2 checkpoint (InternLM2 + InternViT + mlp1 names
    and layouts) of random values, written with the port's safetensors
    writer as one file."""
    g = torch.Generator().manual_seed(seed)
    lc, vc = cfg.llm, cfg.vit
    H, KV, hd, Hd = lc.n_heads, lc.n_kv_heads, lc.head_dim, lc.hidden
    W, I = vc.width, lc.intermediate

    def r(*shape):
        return torch.randn(shape, generator=g).to(dtype)

    t = {"language_model.model.tok_embeddings.weight": r(lc.vocab, Hd),
         "language_model.model.norm.weight": r(Hd),
         "language_model.output.weight": r(lc.vocab, Hd)}
    for i in range(lc.n_layers):
        b = f"language_model.model.layers.{i}."
        t.update({b + "attention.wqkv.weight": r((H + 2 * KV) * hd, Hd),
                  b + "attention.wo.weight": r(Hd, H * hd),
                  b + "attention_norm.weight": r(Hd),
                  b + "ffn_norm.weight": r(Hd),
                  b + "feed_forward.w1.weight": r(I, Hd),
                  b + "feed_forward.w3.weight": r(I, Hd),
                  b + "feed_forward.w2.weight": r(Hd, I)})
    p = cfg.patch
    n_patch = 16
    t.update({"vision_model.embeddings.patch_embedding.weight": r(W, 3, p, p),
              "vision_model.embeddings.patch_embedding.bias": r(W),
              "vision_model.embeddings.position_embedding": r(1, 1 + n_patch,
                                                              W)})
    for i in range(vc.n_layers):
        b = f"vision_model.encoder.layers.{i}."
        t.update({b + "attn.qkv.weight": r(3 * W, W),
                  b + "attn.qkv.bias": r(3 * W),
                  b + "attn.proj.weight": r(W, W), b + "attn.proj.bias": r(W),
                  b + "ls1": r(W), b + "ls2": r(W),
                  b + "norm1.weight": r(W), b + "norm1.bias": r(W),
                  b + "norm2.weight": r(W), b + "norm2.bias": r(W),
                  b + "mlp.fc1.weight": r(vc.mlp_width, W),
                  b + "mlp.fc1.bias": r(vc.mlp_width),
                  b + "mlp.fc2.weight": r(W, vc.mlp_width),
                  b + "mlp.fc2.bias": r(W)})
    D, out = cfg.mlp1.in_dim, cfg.mlp1.out_dim
    t.update({"mlp1.0.weight": r(D), "mlp1.0.bias": r(D),
              "mlp1.1.weight": r(out, D), "mlp1.1.bias": r(out),
              "mlp1.3.weight": r(out, out), "mlp1.3.bias": r(out)})
    os.makedirs(path, exist_ok=True)
    TST.save_file(t, os.path.join(path, "model.safetensors"),
                  metadata={"format": "pt"})
    return t


def _bit_equal(t, j, where=""):
    if isinstance(j, dict):  # JAX's tree.map sorts the keys
        assert set(t) == set(j), where
        for k in j:
            _bit_equal(t[k], j[k], f"{where}/{k}")
        return
    if j is None:
        assert t is None, where
        return
    a = np.asarray(j)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    b = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    assert b.shape == a.shape, where
    np.testing.assert_array_equal(b, a, err_msg=where)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_internvl_bit_equal_to_jax(tmp_path, dtype):
    """``load_model("internvl", ...)`` against JAX's loader on the same
    checkpoint: every leaf bit-equal (f32 and bf16 trees), and InternLM2's
    wqkv split by GQA group: query head g·G + j is rows (g, j) of the
    (KV, G + 2, hd, hidden) view, k and v rows (g, G) and (g, G + 1)."""
    jc = j_family("internvl").tiny_fn()
    tc = TI.InternVLConfig.tiny()
    t = _hf_checkpoint(tc, str(tmp_path))
    pj = JL.load_model("internvl", jc, str(tmp_path),
                       dtype=getattr(jnp, dtype))
    pt = TL.load_model("internvl", tc, str(tmp_path),
                       dtype=getattr(torch, dtype), device="cpu")
    _bit_equal(pt, pj)
    lc = tc.llm
    H, KV, hd, Hd = lc.n_heads, lc.n_kv_heads, lc.head_dim, lc.hidden
    G = H // KV
    w3 = t["language_model.model.layers.1.attention.wqkv.weight"].reshape(
        KV, G + 2, hd, Hd).to(getattr(torch, dtype))
    lay = pt["llm"]["layers"]
    q = lay["q"]["w"][1].T.reshape(H, hd, Hd)
    k = lay["k"]["w"][1].T.reshape(KV, hd, Hd)
    v = lay["v"]["w"][1].T.reshape(KV, hd, Hd)
    for g in range(KV):
        assert not torch.equal(w3[g, 0], w3[(g + 1) % KV, 0])
        for j in range(G):
            assert torch.equal(q[g * G + j], w3[g, j])
        assert torch.equal(k[g], w3[g, G]) and torch.equal(v[g], w3[g, G + 1])
    pos = t["vision_model.embeddings.position_embedding"]
    assert torch.equal(pt["vit"]["pos_embed"]["w"],
                       pos[0, 1:].to(getattr(torch, dtype)))


def test_run_pipeline_from_checkpoint(tmp_path):
    """``run_pipeline("InternVL2-8B", model_dir=...)`` loads through
    ``load_internvl`` (a "load" stage), quantizes and serves its
    artifact."""
    tc = TI.InternVLConfig.tiny()
    _hf_checkpoint(tc, str(tmp_path / "ckpt"), dtype=torch.float32)
    art = str(tmp_path / "art")
    _, params, state, specs, info = TP.run_pipeline(
        "InternVL2-8B", TP.QuantizeConfig(calib_num=16, nsamples=4,
                                          realize_int=True),
        model_dir=str(tmp_path / "ckpt"), tiny=True, artifact_dir=art,
        device="cpu")
    assert "load" in info["stages"] and info["gptq"]["fallbacks"] == []
    runner = build_runner_from_artifact(art, tokenizer=IdTokenizer(),
                                        max_len=64, device="cpu")
    assert len(runner.generate(_prompts()[0], max_new_tokens=3)) == 3
