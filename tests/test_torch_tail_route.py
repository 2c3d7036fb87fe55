"""The route of the MLP tail before ``down`` in full-Hadamard mode (the
port's ``models.llm._use_fused_tail``) against the JAX package's (CPU;
numpy weights from a fixed seed, handed to both packages).

JAX takes its fused swiglu → Hadamard → int8 kernel only on a TPU with
``MQUANT_FUSED_TAIL=1``; its default is the chain swiglu →
``online_hadamard`` (bf16 out) → static int8. The port reads the same flag
with the same default "0". At T = 256 (the fused route's least prefill) the
port's default route gives JAX's codes at the ``down`` input: equal in all
but at most 1e-4 of the entries and off by at most one step there (f32 sums
on two backends may put a value on the other side of a rounding tie), and
the logits within ``tests/test_torch_split.py``'s bound. The flag set to
"1" reaches the fused function (its plain version on CPU tensors).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_split as S
from mquant_tpu.kernels import qmm as JK
from mquant_tpu.models import llm as JLLM
from mquant_tpu_torch import interop
from mquant_tpu_torch.kernels import fwht as TF
from mquant_tpu_torch.kernels import qmm as TK
from mquant_tpu_torch.models import layers as TL
from mquant_tpu_torch.models import llm as TLLM

T = 256
CODES_MAX_FRAC = 1e-4


@pytest.fixture(scope="module")
def tiny():
    """The tiny decoder with bf16 activations (the served dtype, where the
    chain rounds the Hadamard output to bf16 before the codes)."""
    cfg_j, params_np, state_j = S._llm(False)
    return dict(cfg_j=dataclasses.replace(cfg_j, dtype=jnp.bfloat16),
                cfg_t=dataclasses.replace(TLLM.DecoderConfig(
                    **{f.name: getattr(cfg_j, f.name) for f in
                       dataclasses.fields(TLLM.DecoderConfig)
                       if f.name != "dtype"}), dtype=torch.bfloat16),
                params_j=jax.tree.map(jnp.asarray, params_np),
                params_t=interop.to_torch(params_np, device="cpu"),
                state_j=state_j,
                state_t=interop.to_torch(jax.tree.map(np.asarray, state_j),
                                         device="cpu"),
                specs_j=S._specs(JLLM.L.SiteSpec, False),
                specs_t=S._specs(TL.SiteSpec, False),
                toks=np.random.default_rng(7).integers(
                    0, cfg_j.vocab, size=(1, T)))


def _record(module, store, K, monkeypatch):
    """Appends the codes of every ``quantized_matmul_pre`` call at input
    width K (the ``down`` site) to ``store``."""
    pre = module.quantized_matmul_pre

    def recorded(xq, *a, **kw):
        if xq.shape[-1] == K:
            store.append(np.asarray(xq).astype(np.int32))
        return pre(xq, *a, **kw)

    monkeypatch.setattr(module, "quantized_matmul_pre", recorded)


def _jax(tiny, monkeypatch):
    codes = []
    _record(JK, codes, tiny["cfg_j"].inter_eff, monkeypatch)
    with jax.disable_jit():  # the layer scan runs eagerly: codes are values
        lj, _, _ = JLLM.decoder_forward(
            tiny["cfg_j"], tiny["params_j"], jnp.asarray(tiny["toks"]),
            specs=tiny["specs_j"], state=tiny["state_j"], mode="real")
    return np.asarray(lj.astype(jnp.float32)), codes


def _port(tiny, monkeypatch):
    codes = []
    _record(TK, codes, tiny["cfg_t"].inter_eff, monkeypatch)
    lt, _, _ = TLLM.decoder_forward(
        tiny["cfg_t"], tiny["params_t"], torch.from_numpy(tiny["toks"]),
        specs=tiny["specs_t"], state=tiny["state_t"], mode="real")
    return lt.float().numpy(), codes


def test_default_route_gives_jax_codes_and_logits(tiny, monkeypatch):
    monkeypatch.delenv("MQUANT_FUSED_TAIL", raising=False)
    lj, cj = _jax(tiny, monkeypatch)
    lt, ct = _port(tiny, monkeypatch)
    assert len(ct) == len(cj) == tiny["cfg_j"].n_layers
    d = np.abs(np.stack(ct) - np.stack(cj))
    assert d.max() <= 1 and (d > 0).mean() <= CODES_MAX_FRAC, (
        d.max(), (d > 0).mean())
    np.testing.assert_allclose(lt, lj, rtol=0,
                               atol=S.RTOL * np.abs(lj).max())


def test_flag_reaches_the_fused_function(tiny, monkeypatch):
    """``MQUANT_FUSED_TAIL=1``: one fused tail call per layer at T = 256
    (its plain version here), none with the flag unset or "0"."""
    kern = TF.KERNELS["fused_swiglu_had_quant"]
    for flag, want in ((None, 0), ("0", 0), ("1", tiny["cfg_t"].n_layers)):
        if flag is None:
            monkeypatch.delenv("MQUANT_FUSED_TAIL", raising=False)
        else:
            monkeypatch.setenv("MQUANT_FUSED_TAIL", flag)
        calls = []
        monkeypatch.setitem(TF.KERNELS, "fused_swiglu_had_quant",
                            lambda *a: calls.append(1) or kern(*a))
        _port(tiny, monkeypatch)
        assert len(calls) == want, (flag, len(calls))
