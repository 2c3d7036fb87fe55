"""Speculation returns the greedy tokens, bit for bit (ROADMAP C-w18).

At head_dim 128 the port's decode step takes the fused decode attention
(``attn_decode_ref`` on the CPU, the ``attn_decode`` kernel on the card), so
a verify window that ran the einsum over its T = k + 1 rows would round
otherwise. ``decoder_forward(..., verify=True)`` runs the window as the
decode steps run it: attention one query row at a time at its own position,
the norms and float products on each step's rows. Held here:

* every verify row's logits bit-equal to the decode step's at that
  position, with the caches' written rows equal (fp in f32, where the
  einsum over the whole window does differ, and the W4A8 real path with
  block Hadamard and the int8 head in bf16);
* ``ServingEngine(spec_k=1, 3)`` tokens and logprobs equal to
  ``spec_k=0``'s on a pool of the same shape;
* ``speculative_generate`` equal to ``generate_on_device`` at the same
  cache length.
"""

import numpy as np
import pytest
import torch

from mquant_tpu_torch import random_init as R
from mquant_tpu_torch.models.llm import (DecoderConfig, decoder_forward,
                                         init_cache, init_decoder_params)
from mquant_tpu_torch.serve.engine import ServingEngine
from mquant_tpu_torch.serve.generate import Generator, prepare_w4_resident
from mquant_tpu_torch.serve.speculative import speculative_generate


def _model(kind: str):
    """(cfg, params, specs, state, mode) of a 2-layer decoder at head_dim
    128: "fp" f32 weights, or "real" W4A8 (block Hadamard, int8 head)."""
    dtype = torch.float32 if kind == "fp" else torch.bfloat16
    cfg = DecoderConfig(vocab=384, hidden=256, n_layers=2, n_heads=2,
                        n_kv_heads=1, intermediate=512, dtype=dtype)
    g = torch.Generator().manual_seed(3)
    if kind == "fp":
        return cfg, init_decoder_params(cfg, g, device="cpu"), None, None, \
            "fp"
    params, state = R.init_w4a8(cfg, g, "cpu")
    specs = R.llm_specs()
    return (cfg, prepare_w4_resident(cfg, params, specs, "real"), specs,
            state, "real")


def _copy(cache):
    return {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in cache.items()}


@pytest.mark.parametrize("kind", ["fp", "real"])
@pytest.mark.parametrize("per_row", [True, False])
def test_verify_rows_equal_the_decode_steps(kind, per_row):
    cfg, params, specs, state, mode = _model(kind)
    rng = np.random.default_rng(1)
    B, k = (3, 3) if per_row else (1, 4)

    def fwd(x, cache, **kw):
        return decoder_forward(cfg, params, torch.from_numpy(x), specs=specs,
                               state=state, mode=mode, cache=cache, **kw)[:2]

    cache = init_cache(cfg, B, 64, device="cpu")
    prompt = rng.integers(0, cfg.vocab, size=(B, 16))
    _, cache = fwd(prompt, cache, prefill_fresh=True)
    # per-row positions (the engine's pool) or one position (a Generator)
    cache["pos"] = (torch.tensor([16, 11, 7], dtype=torch.int32) if per_row
                    else torch.tensor(16, dtype=torch.int32))
    window = rng.integers(0, cfg.vocab, size=(B, k + 1))
    steps, c1 = [], _copy(cache)
    for j in range(k + 1):
        lg, c1 = fwd(window[:, j:j + 1], c1)
        steps.append(lg)
    want = torch.cat(steps, dim=1)
    got, c2 = fwd(window, _copy(cache), verify=True)
    assert torch.equal(got, want)
    assert torch.equal(c1["k"], c2["k"]) and torch.equal(c1["v"], c2["v"])
    assert torch.equal(c1["pos"], c2["pos"])
    if kind == "fp":  # the whole-window einsum rounds otherwise in f32
        plain, _ = fwd(window, _copy(cache))
        assert not torch.equal(plain, want)


def _serve(eng, prompts, n):
    rids = [eng.submit(p, max_new_tokens=n) for p in prompts]
    outs = eng.run()
    return [outs[r] for r in rids], [eng.logprobs_of(r) for r in rids]


@pytest.mark.parametrize("kind", ["fp", "real"])
@pytest.mark.parametrize("spec_k", [1, 3])
def test_engine_speculation_equals_the_greedy_engine(kind, spec_k):
    cfg, params, specs, state, mode = _model(kind)
    rng = np.random.default_rng(2)
    base = rng.integers(0, cfg.vocab, size=6)
    prompts = [np.tile(base, 4)[:n] for n in (17, 9)]  # drafts recur
    prompts += [rng.integers(0, cfg.vocab, size=n) for n in (25, 5)]
    res = {}
    for k in (0, spec_k):
        # max_len 128: the pool is one 128-row bucket for both engines
        eng = ServingEngine(cfg, params, specs=specs, state=state, mode=mode,
                            slots=3, max_len=128, steps_per_block=3,
                            spec_k=k)
        res[k] = _serve(eng, prompts, 14)
        if k:
            assert eng.stats()["spec_accept_per_round"] > 0
    assert res[spec_k][0] == res[0][0]
    assert res[spec_k][1] == res[0][1]  # logprobs bit-equal


@pytest.mark.parametrize("kind", ["fp", "real"])
def test_speculative_generate_equals_generate_on_device(kind):
    cfg, params, specs, state, mode = _model(kind)
    gen = Generator(cfg, params, specs=specs, state=state, mode=mode,
                    max_len=64)
    rng = np.random.default_rng(4)
    for toks in (np.tile(rng.integers(0, cfg.vocab, size=5), 3),
                 rng.integers(0, cfg.vocab, size=11)):
        x = torch.from_numpy(toks[None].astype(np.int64))
        spec = speculative_generate(gen, x, max_new_tokens=18, k=3)
        # the same cache length: speculation grew max_len for its overhang
        plain = gen.generate_on_device(x, 18)[0].numpy()
        np.testing.assert_array_equal(spec, plain)
