"""The port's MLP variants probe (``mquant_tpu_torch.scripts.mlp_variants``)
and its fused epilogue kernel against ``scripts/mlp_variants.py`` (CPU;
numpy inputs from fixed seeds for both packages; JAX's Pallas epilogue runs
unchanged under ``pltpu.force_tpu_interpret_mode()``), at T = 64 tokens,
hidden 256, intermediate 3584 (= 28 · 128: hadK₂₈ ⊗ H₁₂₈).

* ``dequant_swiglu_had_quant_ref`` (the plain version of
  ``mq_dequant_swiglu_had_quant``) and the port's
  ``mlp_int8_fused_epilogue`` against JAX's kernel, read out through an
  identity ``down`` (the outputs are then the int8 codes): codes within ±1,
  under 1% of them differing (the tail's rule: f32 sums of the same
  products in other orders and another sigmoid may move a code on a
  rounding tie by one step). With a random ``down``, the outputs differ by
  no more than the differing codes move them: |Δd| ≤ 0.05 · 0.01 ·
  Σ |Δcode| · |w| (plus f32 rounding).
* ``mlp_int8`` without and with the Hadamard and ``mlp_fp8`` (the port's
  f32 product of the e4m3 values on the CPU): equal to JAX's (exact integer
  or e4m3 products; the same rounding points elsewhere).
* ``mlp_bf16`` and ``mlp_int8_bf16ew``: within 1e-2 of the largest
  magnitude (bf16 elementwise ops round at other points in the two
  frameworks: XLA fuses them in f32, PyTorch rounds after each op).
* The probe's CPU path through its Python API at a tiny size.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mquant_tpu.kernels.fwht import _factors
from mquant_tpu_torch.kernels import fwht as TF
from mquant_tpu_torch.scripts import mlp_variants as PM

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import mlp_variants as JM  # noqa: E402

T, HID, INTER = 64, 256, 3584


def _extras():
    A_np, B_np, K = _factors(INTER)
    return (jnp.asarray(A_np, jnp.bfloat16), jnp.asarray(B_np, jnp.bfloat16),
            INTER, K, INTER // K, 0.05)


def _inputs(seed, w_scale=0.01, down=None):
    """h (1, T, HID) bf16 and int8 weights; ``w_scale`` 2e-3 keeps the gate
    and up values near 1, so that the epilogue's codes spread over the
    range and only a few clip (at 0.01, the JAX script's, nearly all do)."""
    rng = np.random.default_rng(seed)
    h = np.asarray(jnp.asarray(rng.normal(size=(1, T, HID)), jnp.bfloat16))
    ws = {"g": rng.integers(-127, 128, (HID, INTER)).astype(np.int8),
          "u": rng.integers(-127, 128, (HID, INTER)).astype(np.int8),
          "gs": np.full(INTER, w_scale, np.float32),
          "us": np.full(INTER, w_scale, np.float32)}
    if down == "identity":  # d = codes · I, × 0.05 · 20 = 1.0 in f32
        ws["d"] = np.eye(INTER, dtype=np.int8)
        ws["ds"] = np.full(INTER, 20.0, np.float32)
    else:
        ws["d"] = rng.integers(-127, 128, (INTER, HID)).astype(np.int8)
        ws["ds"] = np.full(HID, 0.01, np.float32)
    return h, ws


def _jax(h, ws):
    return jnp.asarray(h), {k: jnp.asarray(v) for k, v in ws.items()}


def _port(h, ws):
    return (torch.from_numpy(h.astype(np.float32)).to(torch.bfloat16),
            {k: torch.from_numpy(v) for k, v in ws.items()})


def _jax_fused(h, ws):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(JM.mlp_int8_fused_epilogue(*_jax(h, ws), _extras()))


def _codes_close(got, ref):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(ref, np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())
    return d


def test_fused_epilogue_codes_match_jax_kernel():
    h, ws = _inputs(0, w_scale=2e-3, down="identity")
    ref = _jax_fused(h, ws)[0]
    assert np.abs(ref).max() == 127 and np.abs(ref).mean() < 60
    ht, wt = _port(h, ws)
    xq = PM._q8(ht)
    g, u = PM._s8(xq, wt["g"])[0], PM._s8(xq, wt["u"])[0]
    assert g.dtype == torch.int32
    got = TF.dequant_swiglu_had_quant_ref(g, u, 0.05 * wt["gs"],
                                          0.05 * wt["us"], 0.05, -127, 127)
    assert got.dtype == torch.int8 and got.shape == (T, INTER)
    _codes_close(got.numpy(), ref)
    # CPU tensors: the wrapper is the plain version, and launches nothing
    before = TF.LAUNCHES["dequant_swiglu_had_quant"]
    assert torch.equal(TF.dequant_swiglu_had_quant(
        g, u, 0.05 * wt["gs"], 0.05 * wt["us"], 0.05, -127, 127), got)
    assert TF.LAUNCHES["dequant_swiglu_had_quant"] == before
    # the probe's whole fused MLP, read out through the identity down
    out = PM.mlp_int8_fused_epilogue(ht, wt)[0]
    np.testing.assert_array_equal(out.numpy(), got.float().numpy())


def test_fused_epilogue_mlp_matches_jax():
    h, ws = _inputs(1, w_scale=2e-3)
    ref = _jax_fused(h, ws)
    got = PM.mlp_int8_fused_epilogue(*_port(h, ws)).numpy()
    assert got.shape == ref.shape == (1, T, HID)
    _, codes_j = _inputs(1, w_scale=2e-3, down="identity")
    dq = np.abs(_jax_fused(h, codes_j)[0].astype(np.int64)
                - PM.mlp_int8_fused_epilogue(*_port(h, codes_j))[0]
                .numpy().astype(np.int64))
    room = 0.05 * 0.01 * (dq @ np.abs(ws["d"].astype(np.int64)))
    assert (np.abs(got - ref)[0] <= room + 1e-6 * np.abs(ref).max()).all()


def test_dequant_epilogue_takes_fused_halves():
    """g and u as the two halves of one int32 gate|up output: the codes of
    contiguous copies."""
    rng = np.random.default_rng(4)
    gu = torch.from_numpy(rng.integers(-2**20, 2**20, (3, 2 * INTER))
                          .astype(np.int32))
    s = torch.full((INTER,), 1e-6)
    half = TF.dequant_swiglu_had_quant(gu[:, :INTER], gu[:, INTER:], s, s,
                                       0.05)
    whole = TF.dequant_swiglu_had_quant(gu[:, :INTER].contiguous(),
                                        gu[:, INTER:].contiguous(), s, s,
                                        0.05)
    assert torch.equal(half, whole)


@pytest.mark.parametrize("had", [False, True])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_mlp_quantized_matches_jax(kind, had):
    h, ws = _inputs(2)
    hj, wj = _jax(h, ws)
    ht, wt = _port(h, ws)
    if kind == "int8":
        ref, got = JM.mlp_int8(hj, wj, had=had), PM.mlp_int8(ht, wt, had=had)
    else:
        wj = {k: (v.astype(jnp.float8_e4m3fn) if v.dtype == jnp.int8 else v)
              for k, v in wj.items()}
        ref, got = JM.mlp_fp8(hj, wj, had=had), PM.mlp_fp8(ht, PM.mk_fp8(wt),
                                                         had=had)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", ["mlp_bf16", "mlp_int8_bf16ew"])
def test_mlp_bf16_ops_match_jax(name):
    h, ws = _inputs(3)
    if name == "mlp_bf16":
        rng = np.random.default_rng(5)
        ws = {k: np.asarray(jnp.asarray(rng.normal(size=ws[k].shape) * 0.02,
                                        jnp.bfloat16)) for k in "gud"}
        wt = {k: torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
              for k, v in ws.items()}
        ht = _port(h, {})[0]
    else:
        ht, wt = _port(h, ws)
    ref = np.asarray(getattr(JM, name)(*_jax(h, ws)), np.float32)
    got = getattr(PM, name)(ht, wt).float().numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max()


def test_mlp_variants_cpu_run():
    lines = []
    with torch.no_grad():
        out = PM.run(PM.Weights(hidden=128, device="cpu"), t=8, chain=2,
                     proto=True, timed=False, log=lines.append)
    assert list(out) == [s[0] for s in PM.LINES + PM.PROTO_LINES]
    assert all(ms is None for ms in out.values())
    assert sum("not timed" in s for s in lines) == len(out)
