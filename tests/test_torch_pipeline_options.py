"""The port's ``run_pipeline`` and CLI with the options ported here, against
the JAX package's, on a tiny HF Qwen2-VL checkpoint that ``transformers``
writes (intermediate 256, so the online-Hadamard gate has both
candidates).

Both packages run from the checkpoint (``model_dir``) with SmoothQuant
(alpha 0.5), ``online_had_mode="auto"``, ``lm_head_bits="auto"``,
``auto_bits=5.0``, visual GPTQ and LLM GPTQ, realized, on JAX's
calibration batches and rotations. The gates decide alike (the same
Hadamard pick, head width and bit allocation), the artifacts' specs and
quantize configs are equal, and the integer codes agree as
``tests/test_torch_pipeline.py``'s GPTQ run does: ≥ 99% in the first
layer, ≥ 70% after it (the second layer's inputs follow the first
layer's flipped codes); the vision tower's and merger's GPTQ weights
≥ 99% equal. The CLI runs ``--tiny --model_dir`` with every new flag and
``--export_safetensors`` on the CPU; JAX's ``import_safetensors`` reads
its files.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from mquant_tpu import pipeline as JP  # noqa: E402
from mquant_tpu.models.registry import get_family as j_family  # noqa: E402
from mquant_tpu.transform import hadamard as JH  # noqa: E402
from mquant_tpu.utils import checkpoint as JC  # noqa: E402
from mquant_tpu_torch import interop  # noqa: E402
from mquant_tpu_torch import pipeline as TP  # noqa: E402
from mquant_tpu_torch.models.qwen2vl import Qwen2VLConfig  # noqa: E402

INTER = 256
OPTIONS = dict(smooth_alpha=0.5, online_had_mode="auto", lm_head_bits="auto",
               auto_bits=5.0, visual_w_rtn=False, realize_int=True,
               calib_num=32, nsamples=8)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from transformers import Qwen2VLConfig as HC
    from transformers import Qwen2VLForConditionalGeneration

    hc = HC(vocab_size=256, hidden_size=64, intermediate_size=INTER,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, rope_theta=1e6, tie_word_embeddings=False,
            rms_norm_eps=1e-6,
            vision_config=dict(depth=2, embed_dim=32, hidden_size=64,
                               num_heads=2, mlp_ratio=1.5, in_chans=3,
                               patch_size=4, spatial_merge_size=2,
                               temporal_patch_size=2),
            rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]},
            image_token_id=255, vision_start_token_id=253,
            vision_end_token_id=254)
    torch.manual_seed(0)
    d = tmp_path_factory.mktemp("hf")
    Qwen2VLForConditionalGeneration(hc).eval().float().save_pretrained(
        d, safe_serialization=True, max_shard_size="300KB")
    return str(d)


def _cfgs():
    fam = j_family("qwen2vl")
    jc = fam.tiny_fn()
    jc = dataclasses.replace(jc, llm=dataclasses.replace(
        jc.llm, intermediate=INTER))
    tc = Qwen2VLConfig.tiny()
    tc = dataclasses.replace(tc, llm=dataclasses.replace(
        tc.llm, intermediate=INTER))
    return fam, jc, tc


@pytest.fixture(scope="module")
def runs(ckpt, tmp_path_factory):
    fam, jc, tc = _cfgs()
    qj = JP.QuantizeConfig(**OPTIONS)
    key = jax.random.key(qj.seed)
    # JAX's synthetic text ids are drawn below min(vocab, 1000), so at vocab
    # 256 they may hit the image token id (255); key 5 draws none
    batches = JP.synthetic_calib_batches(fam, jc, 2, jax.random.key(5))
    k_v, _, k_l = jax.random.split(jax.random.fold_in(key, 1), 3)
    rot = {"vit": JH.get_orthogonal_matrix(jc.vit.width, qj.rotate_mode, k_v),
           "llm": JH.get_orthogonal_matrix(jc.llm.hidden, qj.rotate_mode,
                                           k_l)}
    art_j = str(tmp_path_factory.mktemp("jax"))
    art_t = str(tmp_path_factory.mktemp("port"))
    _, _, _, _, info_j = JP.run_pipeline(
        "qwen2vl", qj, model_dir=ckpt, cfg=jc, calib_batches=batches,
        artifact_dir=art_j)
    with torch.no_grad():
        _, _, _, _, info_t = TP.run_pipeline(
            "qwen2vl", TP.QuantizeConfig(**OPTIONS), model_dir=ckpt, cfg=tc,
            calib_batches=[interop.to_torch(b, device="cpu")
                           for b in batches], artifact_dir=art_t,
            rotations={k: torch.from_numpy(np.asarray(v))
                       for k, v in rot.items()}, device="cpu")
    return dict(art_j=art_j, art_t=art_t, info_j=info_j, info_t=info_t)


def test_gates_decide_alike(runs):
    ij, it = runs["info_j"], runs["info_t"]
    assert it["smooth_alpha"] == ij["smooth_alpha"] == 0.5
    hj, ht = ij["online_had_auto"], it["online_had_auto"]
    assert ht["picked"] == hj["picked"] and set(ht) == {"picked", "full",
                                                        "block"}
    for k in ("full", "block"):
        assert abs(ht[k] - hj[k]) <= 1e-3 * hj[k], (ht, hj)
    assert it["lm_head_bits"] == ij["lm_head_bits"]
    assert it["autobits"] == ij["autobits"]
    assert 4 in it["autobits"].values() and 8 in it["autobits"].values()
    assert it["gptq"]["fallbacks"] == [] and it["vis_gptq"]["fallbacks"] == []
    assert it["vis_gptq"]["sites"] == 15 and it["gptq"]["sites"] == 14
    assert {"load", "smooth", "had_gate", "head_gate", "autobits", "weights",
            "calibrate", "realize", "save"} <= set(it["stages"])


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{pre}/{k}"))
        return out
    if isinstance(tree, tuple):
        return {f"{pre}.scale": tree[0], f"{pre}.zero_point": tree[1]}
    return {pre: tree}


def test_artifacts_agree(runs):
    pj, sj, spj, mj = JC.load_artifact(runs["art_j"])
    pt, st, spt, mt = JC.load_artifact(runs["art_t"])
    assert spt == spj
    assert mt["quantize_config"] == mj["quantize_config"]
    assert mt["autobits"] == mj["autobits"]
    assert mt["quantize_config"]["online_had_mode"] in ("full", "block")
    lj, lt = _flat(pj), _flat(pt)
    assert set(lt) == set(lj)
    agree = {}
    for k, a in lj.items():
        if a is None:
            assert lt[k] is None, k
            continue
        a, b = np.asarray(a), np.asarray(lt[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if a.dtype.kind in "iu" and "/layers/" in k:
            for li in range(a.shape[0]):
                agree[f"{k}[{li}]"] = float((a[li] == b[li]).mean())
        elif k.startswith(("/vit/", "/merger/")) and k.endswith("/w"):
            agree[k] = float((a == b).mean())
    low = {k: v for k, v in agree.items()
           if v < (0.7 if k.endswith("[1]") else 0.99)}
    assert not low, f"code agreement too low: {low} (all: {agree})"
    assert set(_flat(st)) == set(_flat(sj))


def test_cli_new_flags(ckpt, tmp_path):
    art, exp = str(tmp_path / "art"), str(tmp_path / "exp")
    log = str(tmp_path / "logs" / "run.log")
    res = subprocess.run(
        [sys.executable, "-m", "mquant_tpu_torch.quant_vlm", "--tiny",
         "--device", "cpu", "--model_dir", ckpt, "--rotate",
         "--online_llm_hadamard", "--llm_split", "--act_order",
         "--calib_num", "32", "--nsamples", "8", "--smooth_alpha", "0.5",
         "--fp32_had", "--online_had_mode", "auto", "--lm_head_bits", "auto",
         "--lm_head_gate", "1.002", "--auto_bits", "5", "--auto_bits_low",
         "4", "--auto_bits_high", "8", "--visual_w_gptq", "--visual_static",
         "--llm_static", "--log_file", log, "--realize_int", "--artifact",
         art, "--export_safetensors", exp],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    assert summary["gptq_fallbacks"] == [] == summary["visual_gptq_fallbacks"]
    assert summary["visual_gptq_sites"] == 15
    assert summary["lm_head_bits"] in (4, 8)
    assert summary["online_had_auto"]["picked"] in ("full", "block")
    assert "load" in summary["stages"] and summary["autobits"]
    assert "pipeline done" in open(log).read()
    params, md = JC.import_safetensors(f"{exp}/params.safetensors")
    assert md["model"] == "Qwen2-VL-7B" and "config" in md
    assert params["llm"]["layers"]["q"]["w_q"].dtype == np.int8
    state, _ = JC.import_safetensors(f"{exp}/state.safetensors")
    assert type(state["llm.q"]["act"]).__name__ == "QuantParams"
    total = sum(os.path.getsize(f"{exp}/{f}")
                for f in ("params.safetensors", "state.safetensors"))
    assert summary["export_bytes"] == total
