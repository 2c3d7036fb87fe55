"""The port's self-speculative decoding (``mquant_tpu_torch/serve/
speculative.py``) against ``mquant_tpu/serve/speculative.py``.

``ngram_propose`` is held equal to JAX's on histories with and without a
recurring n-gram (one row, and (B, S) rows against JAX's vmap);
``speculative_generate`` to JAX's (tokens and stats) and to the port's own
plain greedy decode, on shared numpy weights (tiny f32 decoder, and a
realized W4A8 one in real mode). The engine's batched rounds are held in
``tests/test_torch_engine.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mquant_tpu.core.quant import QuantParams as JQP
from mquant_tpu.models import llm as JLLM
from mquant_tpu.models.layers import SiteSpec as JSpec
from mquant_tpu.serve.generate import Generator as JGenerator
from mquant_tpu.serve import speculative as JS
from mquant_tpu_torch import interop
from mquant_tpu_torch.models.layers import SiteSpec as TSpec
from mquant_tpu_torch.serve import speculative as TS
from mquant_tpu_torch.serve.generate import Generator as TGenerator
from test_torch_engine import Model


def _hist(rng, S, n, vocab):
    h = np.zeros((S,), np.int32)
    h[:n] = rng.integers(1, vocab, size=n)
    return h


@pytest.mark.parametrize("k", [1, 4])
def test_ngram_propose_equal_to_jax(k):
    rng = np.random.default_rng(k)
    rows = [np.array([10, 11, 12, 13, 14, 20, 21, 10, 11, 12] + [0] * 54,
                     np.int32),
            np.array([7, 8, 1, 7, 8, 2, 7, 8] + [0] * 56, np.int32)]
    lens = [10, 8]
    for n in (3, 9, 30, 60):  # small vocab: n-grams recur
        rows.append(_hist(rng, 64, n, 6))
        lens.append(n)
    rows.append(_hist(rng, 64, 20, 1000))  # no recurring n-gram
    lens.append(20)
    H, L = np.stack(rows), np.asarray(lens, np.int32)
    want = jax.vmap(lambda h, n: JS.ngram_propose(h, n, k))(
        jnp.asarray(H), jnp.asarray(L))
    got = TS.ngram_propose(torch.from_numpy(H), torch.from_numpy(L), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for h, n, w in zip(H, L, np.asarray(want)):  # one row, 0-d length
        np.testing.assert_array_equal(
            TS.ngram_propose(torch.from_numpy(h), torch.tensor(n), k).numpy(),
            w)
    if k == 4:
        assert got[0].tolist() == [13, 14, 20, 21]


def _both(m, toks, n, k, eos_id=None, jkw=None, tkw=None):
    gj = JGenerator(m.jc, m.pj, max_len=256, **(jkw or {}))
    gt = TGenerator(m.tc, m.pt, max_len=256, **(tkw or {}))
    oj, sj = JS.speculative_generate(gj, jnp.asarray(toks), max_new_tokens=n,
                                     k=k, eos_id=eos_id, return_stats=True)
    ot, st = TS.speculative_generate(gt, torch.from_numpy(toks),
                                     max_new_tokens=n, k=k, eos_id=eos_id,
                                     return_stats=True)
    np.testing.assert_array_equal(ot, np.asarray(oj))
    assert st["iters"] == sj["iters"]
    np.testing.assert_allclose(st["accepted_per_iter"],
                               sj["accepted_per_iter"])
    plain = gt.generate_on_device(torch.from_numpy(toks), n,
                                  eos_id=eos_id)[0].tolist()
    if eos_id is not None and eos_id in plain:
        plain = plain[:plain.index(eos_id)]
    assert ot.tolist() == plain
    return ot, st


@pytest.fixture(scope="module")
def model():
    return Model(0)


@pytest.mark.parametrize("k", [1, 3, 7])
def test_matches_jax_and_plain_greedy(model, k):
    _both(model, np.array([[3, 1, 4, 1, 5, 9, 2, 6]]), 20, k)


def test_repetitive_prompt_accepts_more_than_one(model):
    _, st = _both(model, np.array([[5, 9, 2, 7, 5, 9, 2, 7, 5, 9]]), 24, 5)
    assert st["iters"] >= 1


def test_eos_trim_matches(model):
    toks = np.array([[5, 9, 2, 7, 5, 9, 2, 7]])
    gt = TGenerator(model.tc, model.pt, max_len=256)
    base = gt.generate_on_device(torch.from_numpy(toks), 24)[0].tolist()
    _both(model, toks, 24, 5, eos_id=base[len(base) // 2])


def test_real_int_path():
    """W4A8 realized weights (int8 codes of W4, per-channel scales, static
    int8 activations) in real mode: the verify forward's integer products
    and the rollback compose; equal to JAX's and to the plain decode."""
    m = Model(7, hidden=64, intermediate=96, vocab=128)
    rng = np.random.default_rng(7)
    lay = dict(m.np["layers"])
    for n in JLLM.LLM_SITES:
        w = lay[n]["w"]
        lay[n] = {"w_q": rng.integers(-7, 8, size=w.shape).astype(np.int8),
                  "w_scale": (rng.uniform(0.5, 1.5, size=w.shape[:1]
                                          + w.shape[-1:]) * 0.03
                              ).astype(np.float32),
                  "b": lay[n]["b"]}
    m.np = {**m.np, "layers": lay}
    m.pj = jax.tree.map(jnp.asarray, m.np)
    m.pt = interop.to_torch(m.np, device="cpu")
    spec = dict(w_bits=4, a_bits=8, a_static=True)
    sj = {f"llm.{n}": JSpec(**spec) for n in JLLM.LLM_SITES}
    st = {f"llm.{n}": TSpec(**spec) for n in JLLM.LLM_SITES}
    state = {f"llm.{n}": {"act": JQP(np.full((2,), 0.05, np.float32))}
             for n in JLLM.LLM_SITES}
    kw_j = dict(specs=sj, state=jax.tree.map(jnp.asarray, state),
                mode="real")
    kw_t = dict(specs=st, mode="real",
                state=interop.to_torch(state, device="cpu"))
    assert dataclasses.asdict(sj["llm.q"]) == dataclasses.asdict(st["llm.q"])
    _both(m, np.array([[5, 9, 2, 7, 5, 9, 2, 7, 5, 9]]), 16, 4, jkw=kw_j,
          tkw=kw_t)
