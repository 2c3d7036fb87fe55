"""``run_pipeline(calib_dataset=...)`` and the CLI's evaluation in the port,
against the JAX package at the tiny Qwen2-VL.

The calibration set is a circular MMBench TSV with PNG images of two
aspect ratios and a text-only row (so its batches differ in token count and
image bucket). JAX's ``run_pipeline`` and the port's take the same params,
rotations and TSV: the RTN artifacts are equal leaf by leaf, with
``test_torch_pipeline.py``'s bounds (integer codes bit-equal, float leaves
within one bf16 ulp, static activation scales within rel 1e-5). GPTQ with
``act_order`` on those batches runs in the port without an RTN fallback.
The CLI (``python -m mquant_tpu_torch.quant_vlm``) calibrates on a dataset,
evaluates with the engine and a judge artifact, and runs ``--k_bits`` and
``--export_safetensors`` (A9).
"""

import base64
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from mquant_tpu import pipeline as JP
from mquant_tpu.utils import checkpoint as JC
from mquant_tpu_torch import interop
from mquant_tpu_torch import pipeline as TP
from mquant_tpu_torch.utils.png import encode_png
from test_torch_pipeline import BF16_EPS, _jax_inputs, _leaves, _np

RTN = dict(llm_w_rtn=True, realize_int=True, lm_head_bits=4, calib_num=6,
           nsamples=6)


@pytest.fixture(scope="module")
def tsv(tmp_path_factory):
    d = tmp_path_factory.mktemp("calib")

    def b64(seed, h, w):
        rgb = np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                   dtype=np.uint8)
        return base64.b64encode(encode_png(rgb, seed % 5)).decode()

    path = d / "MMBench_calib.tsv"
    rows = ["index\tquestion\tanswer\tA\tB\timage",
            f"0\tWhich one?\tA\tred\tblue\t{b64(1, 16, 16)}",
            f"1\tAnd here?\tB\tcat\tdog\t{b64(2, 16, 32)}",
            "2\tNo picture: yes or no?\tA\tyes\tno\t"]
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def _run_both(tsv, tmp_path_factory, **kw):
    qj = JP.QuantizeConfig(**kw)
    params, _, rot = _jax_inputs(qj)
    art_j = str(tmp_path_factory.mktemp("jax"))
    art_t = str(tmp_path_factory.mktemp("port"))
    JP.run_pipeline("qwen2vl", qj, params=params, calib_dataset=tsv,
                    tiny=True, artifact_dir=art_j)
    info = TP.run_pipeline(
        "qwen2vl", TP.QuantizeConfig(**kw),
        params=interop.to_torch(params, device="cpu"), calib_dataset=tsv,
        tiny=True, artifact_dir=art_t,
        rotations={k: torch.from_numpy(np.asarray(v)) for k, v in rot.items()},
        device="cpu")[4]
    return art_j, art_t, info


def test_dataset_calibrated_rtn_artifact_matches_jax(tsv, tmp_path_factory):
    art_j, art_t, info = _run_both(tsv, tmp_path_factory, **RTN)
    assert "calib_batches" in info["stages"]
    pj, sj, spj, mj = JC.load_artifact(art_j)
    pt, st, spt, mt = JC.load_artifact(art_t)
    assert spt == spj and mt["quantize_config"] == mj["quantize_config"]
    lj, lt = _leaves(pj), _leaves(pt)
    assert set(lt) == set(lj)
    for k in sorted(lj):
        if lj[k] is None:
            assert lt[k] is None, k
            continue
        a, b = np.asarray(lj[k]), np.asarray(lt[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(b, a, err_msg=k)
            continue
        a, b = _np(a), _np(b)
        assert (np.abs(a - b) <= BF16_EPS * np.maximum(np.abs(a), np.abs(b))
                ).all(), k
    ls_j, ls_t = _leaves(sj), _leaves(st)
    assert set(ls_t) == set(ls_j) and ls_j
    for k in ls_j:
        if ls_j[k] is None:
            assert ls_t[k] is None, k
            continue
        np.testing.assert_allclose(np.asarray(ls_t[k]), np.asarray(ls_j[k]),
                                   rtol=1e-5, atol=0, err_msg=k)


def test_dataset_batches_through_gptq(tsv):
    """GPTQ with act_order on batches of three token counts and two image
    buckets (and a text-only row): every site GPTQ'd, no RTN fallback."""
    from mquant_tpu_torch.evaluation.adapter import (
        VLMRunner, calib_batches_from_dataset)
    from mquant_tpu_torch.evaluation.eval import build_dataset
    from mquant_tpu_torch.models.qwen2vl import (Qwen2VLConfig,
                                                 init_qwen2vl_params)

    cfg = Qwen2VLConfig.tiny()
    params = init_qwen2vl_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    batches = calib_batches_from_dataset(
        VLMRunner("qwen2vl", cfg, params), build_dataset(tsv), 6)
    assert len({b["tokens"].shape[1] for b in batches}) >= 3
    assert any(b["patches"] is None for b in batches)
    assert len({b["patches"].shape[1] for b in batches
                if b["patches"] is not None}) == 2
    q = TP.QuantizeConfig(act_order=True, realize_int=True, calib_num=6,
                          nsamples=6, rotate=True, online_llm_hadamard=True,
                          llm_split=True)
    info = TP.run_pipeline("qwen2vl", q, params=params, calib_dataset=tsv,
                           tiny=True, device="cpu")[4]
    assert info["gptq"]["fallbacks"] == [] and info["gptq"]["sites"] == 14


def _cli(*args, timeout=300):
    res = subprocess.run([sys.executable, "-m", "mquant_tpu_torch.quant_vlm",
                          "--tiny", "--device", "cpu", *args],
                         capture_output=True, text=True, timeout=timeout)
    return res


def test_cli_calibrates_and_evaluates(tsv, tmp_path):
    """``--calib_dataset``, ``--dataset_name SyntheticVQA --eval_limit 2
    --eval_batch 2``: the summary carries the metrics, rows and seconds;
    then the MCQ TSV with ``--judge_artifact`` (the first run's)."""
    art = str(tmp_path / "art")
    res = _cli("--calib_dataset", "SyntheticVQA", "--calib_num", "2",
               "--nsamples", "2", "--realize_int", "--artifact", art,
               "--dataset_name", "SyntheticVQA", "--eval_limit", "2",
               "--eval_batch", "2", "--output_dir", str(tmp_path / "out"))
    assert res.returncode == 0, res.stderr[-3000:]
    s = json.loads(res.stdout.strip().splitlines()[-1])
    ev = s["eval"]
    assert ev["dataset"] == "SyntheticVQA" and ev["rows"] == 2
    assert 0.0 <= ev["metrics"]["acc"] <= 100.0 and ev["seconds"] > 0
    assert ev["results_file"].endswith(".csv")
    assert s["gptq_fallbacks"] == [] and s["gptq_sites"] == 14
    res = _cli("--calib_num", "2", "--nsamples", "2", "--dataset_name", tsv,
               "--eval_limit", "2", "--judge_artifact", art,
               "--output_dir", str(tmp_path / "out2"))
    assert res.returncode == 0, res.stderr[-3000:]
    ev = json.loads(res.stdout.strip().splitlines()[-1])["eval"]
    assert ev["rows"] == 2 and set(ev["metrics"]) == {"acc", "acc_circular"}


@pytest.mark.parametrize("flag,item", [(["--k_bits", "8"], None),
                                       (["--export_safetensors", "x"], "A9")])
def test_cli_unported_flags_raise(flag, item, tmp_path):
    """Both flags are ported: ``--k_bits`` runs and the pipeline records
    it; ``--export_safetensors DIR`` (ROADMAP A9) writes
    params.safetensors and state.safetensors into DIR (here under the
    test's directory) and the summary their bytes."""
    if item == "A9":
        flag = [flag[0], str(tmp_path / flag[1])]
    res = _cli(*flag, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    if item is None:
        return
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    files = [tmp_path / "x" / f for f in ("params.safetensors",
                                          "state.safetensors")]
    assert all(f.exists() for f in files)
    assert summary["export_bytes"] == sum(f.stat().st_size for f in files)
