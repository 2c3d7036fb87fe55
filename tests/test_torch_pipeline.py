"""The port's offline pipeline (``mquant_tpu_torch.pipeline.run_pipeline``)
against the JAX package's at the tiny Qwen2-VL, from the same initial
params, calibration batches and rotations (JAX's, passed to the port; the
packages draw from different RNGs), and the port's CLI.

Two configurations, one pipeline run per package each (module fixture):
* "rtn": RTN LLM weights, realized, a W4 lm_head, 2 decode steps folded
  into the calibration. The artifacts are equal leaf by leaf: integer
  codes bit-equal, float leaves within one bf16 ulp (measured: equal),
  static activation scales within rel 1e-5 (measured ≤ 4e-7: the float
  forwards sum in other orders). JAX's ``load_artifact`` reads the port's
  files, and a runner on each package's artifact gives the same greedy
  tokens.
* "gptq": the headline GPTQ with ``act_order``, realized, an int8
  lm_head. The first layer's sites: ≥ 99% of the codes equal (measured:
  100%, ``down`` 99.67%). The decoder inputs come from the float ViT and
  merger, whose f32 sums run in other orders (measured rel 3.2e-7 on the
  image rows, the text rows equal); the walk over ``down`` flips 0.33% of
  its codes on that, and each flip moves the second layer's inputs by a
  quantization step, which changes its Hessians and reorders its
  act_order walk (after the Hadamard, diag(H) is nearly flat): the second
  layer's sites agree on 73.7-98.9% of their codes (measured: q 97.8, k
  98.3, v 95.3, o 85.2, gate 80.3, up 83.4, down 73.7), held at ≥ 70%.
  Without act_order every code is equal. On the same decoder inputs the
  two drivers agree on every code (``test_torch_gptq.py``). The
  activation scales: the vision tower's, the merger's and the first
  layer's within rel 1e-3 (measured ≤ 5e-4); the second layer's, whose
  inputs follow the flipped codes, within rel 2e-2 (measured 1.2e-2 on
  ``llm.down``).
"""

import json
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from mquant_tpu import pipeline as JP
from mquant_tpu.models.registry import get_family as j_family
from mquant_tpu.serve.server import build_runner_from_artifact as j_build
from mquant_tpu.transform import hadamard as JH
from mquant_tpu.utils import checkpoint as JC
from mquant_tpu_torch import interop
from mquant_tpu_torch import pipeline as TP
from mquant_tpu_torch.evaluation.adapter import ByteTokenizer
from mquant_tpu_torch.serve.server import build_runner_from_artifact
from mquant_tpu_torch.utils import checkpoint as TC

CONFIGS = {
    "rtn": dict(llm_w_rtn=True, realize_int=True, lm_head_bits=4,
                calib_decode_steps=2),
    "gptq": dict(act_order=True, realize_int=True, lm_head_bits=8),
}
BASE = dict(calib_num=32, nsamples=8)
BF16_EPS = 2.0 ** -7
STATE_RTOL = {"rtn": 1e-5, "gptq": 1e-3}


class IdTokenizer(ByteTokenizer):
    """Decodes to the token ids: runner outputs compare token for token."""

    def decode(self, ids):
        return [int(i) for i in ids]


def _jax_inputs(q):
    """JAX's run_pipeline inputs, drawn as it draws them: params from the
    seed's key, synthetic batches from fold_in(key, 2), the rotations from
    split(fold_in(key, 1), 3)."""
    fam = j_family("qwen2vl")
    cfg = fam.tiny_fn()
    key = jax.random.key(q.seed)
    params = fam.init_fn(cfg, key)
    batches = JP.synthetic_calib_batches(
        fam, cfg, max(1, q.calib_num // 16), jax.random.fold_in(key, 2))
    k_v, _, k_l = jax.random.split(jax.random.fold_in(key, 1), 3)
    rot = {"vit": JH.get_orthogonal_matrix(cfg.vit.width, q.rotate_mode, k_v),
           "llm": JH.get_orthogonal_matrix(cfg.llm.hidden, q.rotate_mode,
                                           k_l)}
    return params, batches, rot


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for name, kw in CONFIGS.items():
        qj = JP.QuantizeConfig(**BASE, **kw)
        params, batches, rot = _jax_inputs(qj)
        art_j = str(tmp_path_factory.mktemp(f"{name}_jax"))
        art_t = str(tmp_path_factory.mktemp(f"{name}_port"))
        JP.run_pipeline("qwen2vl", qj, params=params, calib_batches=batches,
                        tiny=True, artifact_dir=art_j)
        res_t = TP.run_pipeline(
            "qwen2vl", TP.QuantizeConfig(**BASE, **kw),
            params=interop.to_torch(params, device="cpu"),
            calib_batches=[interop.to_torch(b, device="cpu")
                           for b in batches], tiny=True, artifact_dir=art_t,
            rotations={k: torch.from_numpy(np.asarray(v))
                       for k, v in rot.items()}, device="cpu")
        out[name] = dict(art_j=art_j, art_t=art_t, info=res_t[4])
    return out


def _leaves(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{pre}/{k}"))
        return out
    if isinstance(tree, tuple):  # QuantParams
        return {f"{pre}.scale": tree[0], f"{pre}.zero_point": tree[1]}
    return {pre: tree}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


@pytest.mark.parametrize("name", list(CONFIGS))
def test_artifact_matches_jax(runs, name):
    """The port's artifact, read by JAX's ``load_artifact``, against JAX's
    artifact leaf by leaf; the specs and config equal; no GPTQ fallback."""
    r = runs[name]
    pj, sj, spj, mj = JC.load_artifact(r["art_j"])
    pt, st, spt, mt = JC.load_artifact(r["art_t"])
    assert spt == spj
    # the port's configs lack JAX's unported fields: equal once decoded
    assert TC.config_from_dict(mt["config_dict"]) == TC.config_from_dict(
        mj["config_dict"])
    assert mt["quantize_config"] == mj["quantize_config"]
    lj, lt = _leaves(pj), _leaves(pt)
    assert set(lt) == set(lj)
    agreement = {}
    for k in sorted(lj):
        if lj[k] is None:
            assert lt[k] is None, k
            continue
        a, b = np.asarray(lj[k]), np.asarray(lt[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if a.dtype.kind in "iu":
            agreement[k] = float((a == b).mean())
            if name == "rtn":
                np.testing.assert_array_equal(b, a, err_msg=k)
            continue
        a, b = _np(a), _np(b)
        bound = BF16_EPS * np.maximum(np.abs(a), np.abs(b))
        assert (np.abs(a - b) <= bound).all(), k
    if name == "gptq":  # per layer: the first at 99%, the rest at 70%
        agreement = {}
        for k in lj:
            a, b = np.asarray(lj[k]), np.asarray(lt[k])
            if a.dtype.kind in "iu" and "/layers/" in k:
                for li in range(a.shape[0]):
                    agreement[f"{k}[{li}]"] = float((a[li] == b[li]).mean())
    low = {k: v for k, v in agreement.items()
           if v < (0.99 if k.endswith("[0]") or "/layers/" not in k else 0.7)}
    assert not low, f"code agreement too low: {low} (all: {agreement})"
    print(f"{name}: code agreement {agreement}")
    ls_j, ls_t = _leaves(sj), _leaves(st)
    assert set(ls_t) == set(ls_j)
    for k in ls_j:
        if ls_j[k] is None:
            assert ls_t[k] is None, k
            continue
        a, b = np.asarray(ls_j[k]), np.asarray(ls_t[k])
        if name == "gptq" and k.startswith("/llm.") and a.ndim:
            np.testing.assert_allclose(b[1:], a[1:], rtol=2e-2, atol=0,
                                       err_msg=k)
            a, b = a[:1], b[:1]
        np.testing.assert_allclose(b, a, rtol=STATE_RTOL[name], atol=0,
                                   err_msg=k)
    gptq = r["info"]["gptq"]
    assert gptq.get("fallbacks", []) == []
    assert gptq.get("sites", 0) == (14 if name == "gptq" else 0)


def _prompts():
    rng = np.random.default_rng(3)
    return [{"text": "what is this?",
             "image": rng.random((24, 24, 3)).astype(np.float32)},
            {"text": "a text-only prompt"}]


def test_rtn_artifacts_serve_equal_tokens(runs):
    """A runner on the port's artifact (the port's runner) and one on
    JAX's (JAX's runner): equal greedy tokens, text and image prompts."""
    r = runs["rtn"]
    rj = j_build(r["art_j"], tokenizer=IdTokenizer(), max_len=64)
    rt = build_runner_from_artifact(r["art_t"], tokenizer=IdTokenizer(),
                                    max_len=64, device="cpu")
    assert rt.mode == "real"
    for p in _prompts():
        assert rt.generate(p, max_new_tokens=8) == rj.generate(
            p, max_new_tokens=8)


UNPORTED = [dict(smooth_alpha=0.5), dict(auto_bits=4.5),
            dict(lm_head_bits="auto"), dict(online_had_mode="auto"),
            dict(visual_w_rtn=False)]


@pytest.mark.parametrize("kw", UNPORTED + ["model_dir", "calib_dataset",
                                           "family"])
def test_unported_options_raise(kw, tmp_path, monkeypatch):
    """What the port leaves unported raises naming its ROADMAP item: the
    other model families (A12), and visual GPTQ of their projectors. The
    pipeline options these parameters name are ported for Qwen2-VL
    (``check_ported`` passes them; ``tests/test_torch_gates.py`` and
    ``tests/test_torch_pipeline_options.py`` hold them against JAX) and
    InternVL2, GLM-4V and Qwen-VL (``tests/test_torch_internvl_pipeline.
    py``, ``tests/test_torch_glm4v_pipeline.py``,
    ``tests/test_torch_qwenvl_pipeline.py``), and each still raises A12 for
    MiniCPM-V, the resampler family left. ``model_dir`` is ported: a
    directory without a checkpoint raises FileNotFoundError naming it.
    ``calib_dataset`` is ported (A13): a dataset that is not there raises
    FileNotFoundError naming where it was looked for
    (tests/test_torch_pipeline_dataset.py holds the route)."""
    q = TP.QuantizeConfig(**kw) if isinstance(kw, dict) else TP.QuantizeConfig()
    if kw == "model_dir":
        with pytest.raises(FileNotFoundError, match="nonexistent"):
            TP.run_pipeline("qwen2vl", q, model_dir="/nonexistent",
                            tiny=True, device="cpu")
        return
    if kw == "calib_dataset":
        monkeypatch.setenv("LMUData", str(tmp_path))
        with pytest.raises(FileNotFoundError, match=str(tmp_path)):
            TP.run_pipeline("qwen2vl", q, calib_dataset="MME", tiny=True,
                            device="cpu")
        return
    if isinstance(kw, dict):
        TP.check_ported(q)  # ported for Qwen2-VL
        if not q.visual_w_rtn:
            TP.check_ported(q, "internvl")  # mlp1's GPTQ: ported
            TP.check_ported(q, "glm4v")  # the GLU projector's: ported
            TP.check_ported(q, "qwenvl")  # the resampler's: ported
            with pytest.raises(NotImplementedError, match="ROADMAP A12"):
                TP.check_ported(q, "minicpmv")
    assert TP.get_family("Qwen-VL-Chat").name == "qwenvl"
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        TP.run_pipeline("MiniCPM-V-2_6", q, tiny=True, device="cpu")


def test_cli_tiny_serves(tmp_path):
    """``python -m mquant_tpu_torch.quant_vlm --tiny --device cpu
    --artifact DIR`` with the headline flags exits 0, and its artifact
    serves through ``build_runner_from_artifact``."""
    art = str(tmp_path / "art")
    res = subprocess.run(
        [sys.executable, "-m", "mquant_tpu_torch.quant_vlm", "--tiny",
         "--device", "cpu", "--rotate", "--online_llm_hadamard",
         "--llm_split", "--act_order", "--calib_num", "32", "--nsamples",
         "8", "--realize_int", "--artifact", art],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    assert summary["gptq_sites"] == 14 and summary["gptq_fallbacks"] == []
    assert {"fuse_rotate", "weights", "calibrate", "realize", "save"} <= set(
        summary["stages"])
    runner = build_runner_from_artifact(art, tokenizer=IdTokenizer(),
                                        max_len=64, device="cpu")
    out = runner.generate(_prompts()[0], max_new_tokens=4)
    assert len(out) == 4
    _, _, specs, meta = TC.load_artifact(art, device="cpu")
    assert specs["llm.down"].online_had == "full" and specs["llm.down"].split
    assert meta["quantize_config"]["act_order"]
