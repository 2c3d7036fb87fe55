"""The port's decode loop (``serve.generate.DecodeLoop``: JAX's on-device
loop, a CUDA graph on the card, the same step run eagerly on CPU tensors)
and the cache position on the device, against the JAX package and the
port's eager reference (CPU; shared numpy weights of
``tests/test_torch_slice.py``).

* A device ``pos`` (a 0-d int32 tensor, as ``init_cache`` makes it) gives
  the decode logits of a host int ``pos``, bit for bit, on the einsum route
  (head_dim 16) and the fused decode route (head_dim 128, its plain
  version); the card's formulation (a scatter at pos and the mask
  col ≤ pos over the whole cache, taken here with the card simulated) is
  within 1e-6 of the largest logit (the same terms, softmax and P·V sums of
  another length) and gives the same tokens.
* ``generate_on_device`` and ``generate_batch`` through the loop give JAX's
  tokens with and without eos (rows of a batch finishing at different
  steps), and the loop's tokens and last logits equal the eager reference
  ``_decode_loop``'s.
* The loop with eos stops within 2 · EOS_CHECK_EVERY steps of the last
  row's eos, is kept per (batch, cache length, eos, ragged) and is remade
  when the cache length grows; the ``measure_*`` helpers run.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mquant_tpu.serve.generate import Generator as JGenerator
from mquant_tpu_torch.models import layers as TL
from mquant_tpu_torch.models import llm as TLLM
from mquant_tpu_torch.serve import generate as TG
from test_torch_slice import shared  # noqa: F401  (the shared weights)


def _gens(shared, max_len=64):
    kw = dict(specs=shared["specs_j"], state=shared["state_j"], mode="real",
              max_len=max_len)
    gj = JGenerator(shared["cfg_j"].llm, shared["params_j"]["llm"], **kw)
    gt = TG.Generator(shared["cfg_t"].llm, shared["params_t"]["llm"],
                      specs=shared["specs_t"], state=shared["state_t"],
                      mode="real", max_len=max_len)
    return gj, gt


def _decode(cfg, params, toks, host: bool, steps=12, start=None):
    """Prefill, then ``steps`` greedy decode steps with the cache position
    as a host int or as the 0-d tensor ``init_cache`` makes; the stacked
    decode logits."""
    B, T = toks.shape
    cache = TLLM.init_cache(cfg, B, 48, device="cpu")
    logits, cache, _ = TLLM.decoder_forward(cfg, params, toks, cache=cache,
                                         prefill_fresh=True)
    if host:
        cache["pos"] = int(cache["pos"])
    tok = logits[:, -1:].argmax(-1)
    out = []
    for _ in range(steps):
        logits, cache, _ = TLLM.decoder_forward(cfg, params, tok, cache=cache,
                                             attn_start=start)
        assert isinstance(cache["pos"], int) == host
        out.append(logits)
        tok = logits[:, -1:].argmax(-1)
    return torch.stack(out)


def _decoder(head_dim, dtype):
    cfg = TLLM.DecoderConfig(vocab=96, hidden=128, n_layers=2, n_heads=4,
                             n_kv_heads=2, intermediate=256,
                             head_dim=head_dim, dtype=dtype)
    return cfg, TLLM.init_decoder_params(cfg, torch.Generator().manual_seed(1),
                                         device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("head_dim", [16, 128], ids=["einsum", "fused"])
def test_device_pos_decode_logits_bit_equal(head_dim, dtype):
    cfg, params = _decoder(head_dim, dtype)
    toks = torch.randint(0, cfg.vocab, (2, 11),
                         generator=torch.Generator().manual_seed(2))
    start = torch.tensor([0, 4], dtype=torch.int32)
    for st in (None, start):
        host = _decode(cfg, params, toks, True, start=st)
        dev = _decode(cfg, params, toks, False, start=st)
        assert torch.equal(host, dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_card_mask_formulation(dtype, monkeypatch):
    """The einsum decode route with the position on the card: the whole
    cache masked at col ≤ pos (rows past pos poisoned with large values
    first), against the prefix route."""
    cfg, params = _decoder(16, dtype)
    toks = torch.randint(0, cfg.vocab, (2, 11),
                         generator=torch.Generator().manual_seed(2))
    ref = _decode(cfg, params, toks, True)
    monkeypatch.setattr(TL, "_on_card", lambda t: True)
    init = TLLM.init_cache

    def poisoned(*a, **kw):
        c = init(*a, **kw)
        c["k"].fill_(1e4)
        c["v"].fill_(-1e4)
        return c

    monkeypatch.setattr(TLLM, "init_cache", poisoned)
    got = _decode(cfg, params, toks, False)
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())
    assert torch.equal(got.argmax(-1), ref.argmax(-1))


def _eos_pick(rows):
    """An eos id at which the rows finish at different steps (a row that
    never meets it runs to the end), from their free-running tokens; and
    its first step per row."""
    for t in rows[0][1:]:
        firsts = [r.index(t) if t in r else len(r) for r in rows]
        if len(set(firsts)) > 1 and min(firsts) < len(rows[0]) - 1:
            return t, firsts
    raise AssertionError(f"no eos separates the rows {rows}")


@pytest.mark.parametrize("with_eos", [False, True])
def test_generate_on_device_matches_jax(shared, with_eos):
    gj, gt = _gens(shared)
    toks = np.random.default_rng(8).integers(0, 256, size=(2, 13))
    n = 10
    free = np.asarray(gj.generate_on_device(jnp.asarray(toks), n)).tolist()
    eos = _eos_pick(free)[0] if with_eos else None
    oj = np.asarray(gj.generate_on_device(jnp.asarray(toks), n, eos_id=eos))
    ot = gt.generate_on_device(torch.from_numpy(toks), n, eos_id=eos)
    np.testing.assert_array_equal(ot.numpy(), oj)
    if with_eos:  # a row froze at eos before the last step
        assert (ot[:, :-1] == eos).any()


@pytest.mark.parametrize("with_eos", [False, True])
def test_generate_batch_matches_jax(shared, with_eos):
    gj, gt = _gens(shared)
    rng = np.random.default_rng(9)
    seqs = [rng.integers(0, 256, size=(n,)) for n in (20, 13, 9)]
    free = gj.generate_batch(seqs, max_new_tokens=10)
    eos = _eos_pick(free)[0] if with_eos else None
    oj = gj.generate_batch(seqs, max_new_tokens=10, eos_id=eos)
    ot = gt.generate_batch(seqs, max_new_tokens=10, eos_id=eos)
    assert ot == oj
    if with_eos:
        assert len({len(o) for o in ot}) > 1  # rows stop at other steps


@pytest.mark.parametrize("with_eos", [False, True])
def test_loop_equals_eager_reference(shared, with_eos):
    """Tokens and the last step's logits of the loop against
    ``_decode_loop`` from the same prefill (a ragged batch)."""
    _, gt = _gens(shared)
    rng = np.random.default_rng(10)
    seqs = [rng.integers(0, 256, size=(n,)) for n in (17, 6)]
    n = 12
    free = gt.generate_batch(seqs, max_new_tokens=n)
    eos = _eos_pick([[int(t) for t in r] for r in free])[0] \
        if with_eos else None
    logits, cache, starts = gt.prefill_batch(seqs)
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    ref, ref_logits = gt._decode_loop(tok, cache, n, eos, attn_start=starts,
                                      with_logits=True)
    loop = gt._loop(len(seqs), eos, True)
    _, cache2, _ = gt.prefill_batch(seqs, kv=(loop.k, loop.v))
    out = loop.run(tok, cache2, n, start=starts)
    assert torch.equal(out, ref)
    if not with_eos:
        assert torch.equal(loop.logits, ref_logits)


def test_eos_stops_the_loop_early(shared, monkeypatch):
    _, gt = _gens(shared)
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (1, 9)))
    n = 40
    free = gt.generate_on_device(toks, n)[0].tolist()
    eos = free[2]
    calls = []
    fwd = gt._forward
    monkeypatch.setattr(gt, "_forward",
                        lambda *a, **k: calls.append(1) or fwd(*a, **k))
    out = gt.generate_on_device(toks, n, eos_id=eos)[0].tolist()
    first = free.index(eos)
    assert out[:first + 1] == free[:first + 1]
    assert out[first:] == [eos] * (n - first)
    steps = len(calls) - 1  # the prefill is one forward
    assert first <= steps <= first + 2 * TG.EOS_CHECK_EVERY < n - 1


def test_loops_are_kept_and_remade_at_a_new_length(shared):
    _, gt = _gens(shared, max_len=64)
    a = gt._loop(1, None, False)
    assert gt._loop(1, None, False) is a
    b = gt._loop(1, 7, False)
    assert b is not a and b.k is a.k  # one set of buffers per shape
    gt.ensure_capacity(100)
    c = gt._loop(1, None, False)
    assert c is not a and c.k.shape[2] == gt.max_len == 128
    assert set(gt._loops) == {(1, 128, None, False)}
    gt.reset_capacity(40)
    assert gt.max_len == 64 and gt._loop(1, None, False).k.shape[2] == 64


def test_measure_helpers_run(shared):
    _, gt = _gens(shared, max_len=64)
    toks = torch.from_numpy(np.random.default_rng(11).integers(0, 256,
                                                               (1, 16)))
    for t in (TG.measure_ttft(gt, toks, iters=2),
              TG.measure_ttft_chained(gt, toks, chain=3, iters=2),
              TG.measure_request(gt, toks, gen_tokens=4, iters=2),
              TG.measure_decode_tps(gt, toks, n_tokens=4),
              TG.measure_decode_tps(gt, toks, n_tokens=4, on_device=False)):
        assert np.isfinite(t) and t > 0
    assert TG._force({"a": (torch.tensor([2.5, 1.0]),)}) == 2.5
