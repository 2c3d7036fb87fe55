"""The port's bench (``mquant_tpu_torch.bench``) against the repository's
``bench.py``: the arithmetic helpers (site widths, decode bytes a step,
prefill int8 MACs, the two rooflines) equal bench.py's at Qwen2-VL-7B's
widths for both lm_head widths, once bench.py's peaks are set to the H100's
that the port uses; and ``--device cpu`` (the whole bench at the tiny
configuration) prints, as its last stdout line, a JSON object with every
key bench.py prints."""

import ast
import dataclasses
import importlib.util
import json
from pathlib import Path

import pytest

from mquant_tpu_torch import bench as TB

BENCH_PY = Path(__file__).resolve().parent.parent / "bench.py"


@pytest.fixture(scope="module")
def jb():
    spec = importlib.util.spec_from_file_location("repo_bench", BENCH_PY)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bench_keys(jb):
    """The keys of the JSON object bench.py's main prints: its literal keys
    and those of ``**roofline(...)``."""
    tree = ast.parse(BENCH_PY.read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    d = next(n for n in ast.walk(main) if isinstance(n, ast.Dict)
             and any(isinstance(k, ast.Constant) and k.value == "metric"
                     for k in n.keys))
    keys = {k.value for k in d.keys if k is not None}
    cfg = jb.make_cfg(2)
    return keys | set(jb.roofline(cfg, 0.05, 100.0, 1152, True))


@pytest.mark.parametrize("head", ["8", "4"])
def test_helpers_match_bench_py(jb, head, monkeypatch):
    monkeypatch.setenv("MQUANT_BENCH_HEAD", head)
    monkeypatch.setattr(jb, "HBM_PEAK_GBPS", TB.HBM_PEAK_GBPS)
    monkeypatch.setattr(jb, "INT8_PEAK_TOPS", TB.INT8_PEAK_TOPS)
    for n_layers, pad in ((28, 0), (28, 18944), (3, 0)):
        cj = jb.make_cfg(n_layers, pad)
        ct = TB.make_cfg(n_layers, pad)
        assert TB.site_dims(ct) == jb.site_dims(cj)
        for packed in (True, False):
            assert TB.decode_step_bytes(ct, packed, 1152) == \
                jb.decode_step_bytes(cj, packed, 1152)
        assert TB.prefill_int8_macs(ct, 1024) == jb.prefill_int8_macs(cj, 1024)
        for B in (1, 4):
            assert TB.pooled_roofline(ct, 150.0 * B, B, 1152) == \
                jb.pooled_roofline(cj, 150.0 * B, B, 1152)
        assert TB.roofline(ct, 0.061, 140.0, 1152, True) == \
            jb.roofline(cj, 0.061, 140.0, 1152, True)


def test_configs_and_specs_match_bench_py(jb, monkeypatch):
    monkeypatch.delenv("MQUANT_BENCH_HEAD", raising=False)
    monkeypatch.delenv("MQUANT_BENCH_HAD", raising=False)
    cj, ct = jb.make_cfg(28), TB.make_cfg(28)
    for f in dataclasses.fields(cj):
        if hasattr(ct, f.name) and f.name != "dtype":
            assert getattr(ct, f.name) == getattr(cj, f.name), f.name
    from mquant_tpu.transform.hadamard import auto_pad_size

    assert TB.w4a8_pad(cj.intermediate) == auto_pad_size(cj.intermediate)
    sj, st = jb.llm_specs(), TB.llm_specs()
    assert set(sj) == set(st)
    for name in sj:
        assert dataclasses.asdict(st[name]) == dataclasses.asdict(sj[name])
    assert TB.llm_specs(lm_head_bits=4)["llm.lm_head"].w_bits == 4
    assert (TB.CARD.prefill, TB.CARD.max_len, TB.CARD.gen_tokens,
            TB.CARD.decode_tokens) == (jb.PREFILL, jb.MAX_LEN, jb.GEN_TOKENS,
                                       jb.DECODE_TOKENS)


def test_cpu_run_prints_bench_py_keys(jb, capsys, monkeypatch):
    monkeypatch.setenv("MQUANT_BENCH_HEAD", "auto")
    result = TB.main(["--device", "cpu", "--iters", "1", "--chain", "2"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    printed = json.loads(last)
    assert printed == json.loads(json.dumps(result))
    assert _bench_keys(jb) <= set(printed)
    assert printed["lm_head_bits"] in (4, 8)
    assert printed["depth"] == 2 and printed["card"] == "cpu"
    for k in ("ttft_ms_w4a8", "ttft_ms_bf16", "decode_tps_w4a8",
              "decode_tps_bf16", "vlm_request_s_w4a8", "vlm_request_s_bf16"):
        assert printed[k] > 0, k
