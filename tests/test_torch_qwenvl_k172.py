"""The port's Qwen-VL family at the "k172" variant and its remaining
entry points, against the JAX package's (f32, CPU): ``run_pipeline`` with
the "rtn" flags of ``tests/test_torch_qwenvl_pipeline.py`` on a decoder of
intermediate 344 = 172 · 2, whose full online Hadamard is the seeded
order-172 block ⊗ H₂, as Qwen-VL-Chat's 11008 = 172 · 64 takes it (the
artifact against JAX's leaf by leaf, its params.msgpack byte for byte, the
two runners on each artifact: their greedy tokens part only at a near
tie, the f32 Hadamard's 172-term sums running in each package's order);
``run_pipeline(model_dir=)`` through ``load_qwenvl``; the server CLI's
``--model qwenvl --tiny`` and ``quant_vlm --model Qwen-VL-Chat --tiny``.
A file of its own so that neither pipeline file's fixture takes more
than its share of the suite's time.
"""

import json
import re
import subprocess
import sys

import pytest
import torch

from mquant_tpu_torch import pipeline as TP
from mquant_tpu_torch.models import qwenvl as TQ
from mquant_tpu_torch.serve.server import build_runner_from_artifact

from test_torch_pipeline import IdTokenizer
from test_torch_qwenvl import _hf_checkpoint
from test_torch_qwenvl_pipeline import (RTN, VIS_GPTQ_SITES, _prompts,
                                        check_artifact, check_serving,
                                        params_file_equal, pipeline_pair)
from test_torch_server import _get, _post


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return pipeline_pair("k172", RTN, tmp_path_factory)


def test_artifact_matches_jax(run):
    """The "k172" artifact against JAX's leaf by leaf (every code
    bit-equal, the static scales within rel 1e-5), its intermediate 344
    unpadded."""
    check_artifact(run, "k172")


def test_rtn_params_file_equals_jax(run):
    """The "k172" run's params.msgpack is JAX's byte for byte."""
    params_file_equal(run)


def test_artifacts_serve_equal_tokens(run):
    """Each artifact in both runners: greedy tokens equal, or parted only
    at a near tie (``check_serving``'s "k172" rule)."""
    check_serving(run, "k172")


def test_server_cli_tiny_qwenvl():
    """``python -m mquant_tpu_torch.serve.server --model qwenvl --tiny
    --device cpu --port 0`` serves the tiny Qwen-VL: /health and an id
    completion of 4 tokens."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "mquant_tpu_torch.serve.server", "--model",
         "qwenvl", "--tiny", "--device", "cpu", "--port", "0"],
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


def test_quant_vlm_cli_qwenvl(tmp_path):
    """``python -m mquant_tpu_torch.quant_vlm --model Qwen-VL-Chat
    --tiny`` with the headline flags and visual GPTQ (the resampler's six
    sites included) exits 0; its artifact serves."""
    art = str(tmp_path / "art")
    res = subprocess.run(
        [sys.executable, "-m", "mquant_tpu_torch.quant_vlm", "--model",
         "Qwen-VL-Chat", "--tiny", "--device", "cpu", "--rotate",
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
    assert runner.fam.name == "qwenvl"
    assert len(runner.generate(_prompts()[0], max_new_tokens=4)) == 4


def test_run_pipeline_from_checkpoint(tmp_path):
    """``run_pipeline("Qwen-VL-Chat", model_dir=...)`` loads through
    ``load_qwenvl`` (a "load" stage), quantizes (visual GPTQ, the
    resampler's included) and serves its artifact."""
    tc = TQ.QwenVLConfig.tiny()
    _hf_checkpoint(tc, str(tmp_path / "ckpt"), dtype=torch.float32)
    art = str(tmp_path / "art")
    _, params, state, specs, info = TP.run_pipeline(
        "Qwen-VL-Chat", TP.QuantizeConfig(calib_num=16, nsamples=4,
                                          visual_w_rtn=False,
                                          realize_int=True),
        model_dir=str(tmp_path / "ckpt"), tiny=True, artifact_dir=art,
        device="cpu")
    assert "load" in info["stages"] and info["gptq"]["fallbacks"] == []
    assert info["vis_gptq"]["sites"] == VIS_GPTQ_SITES
    runner = build_runner_from_artifact(art, tokenizer=IdTokenizer(),
                                        max_len=64, device="cpu")
    assert len(runner.generate(_prompts()[0], max_new_tokens=3)) == 3
