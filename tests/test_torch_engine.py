"""The port's continuous-batching engine (``mquant_tpu_torch/serve/engine.py``)
and per-row cache positions (``models/llm.py``) against the JAX package.

Each case mirrors one of ``tests/test_engine.py``: the same requests go
through JAX's ``ServingEngine`` and the port's, on the same weights (drawn
with numpy from a seed, handed to JAX as arrays and to the port through
``interop``), tiny f32 decoders on the CPU. Greedy and sampled tokens must
be equal; logprobs within LP_ATOL. Each case also holds the port's engine
against the port's own ``Generator`` serving the prompt alone (tokens
equal). Where the JAX test holds int8 / int4 KV caches the port raises
(ROADMAP A5), as it does for NTK scaling.

The port's pool is poisoned with NaN before each run (the stale tail,
ROADMAP C-w1): no column at or beyond a row's position may reach an output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mquant_tpu.models import llm as JLLM
from mquant_tpu.serve.engine import ServingEngine as JEngine
from mquant_tpu_torch import interop
from mquant_tpu_torch.models import llm as TLLM
from mquant_tpu_torch.serve.engine import ServingEngine as TEngine
from mquant_tpu_torch.serve.generate import Generator as TGenerator

LP_ATOL = 1e-5  # logprobs: f32 sums in other orders
LOGIT_RTOL = 1e-5  # per-row decoder logits, of their largest magnitude


def _cfgs(**kw):
    base = dict(vocab=96, hidden=48, n_layers=2, n_heads=4, n_kv_heads=2,
                intermediate=64)
    base.update(kw)
    return (JLLM.DecoderConfig(dtype=jnp.float32, **base),
            TLLM.DecoderConfig(dtype=torch.float32, **base))


def _params(cfg, seed):
    """numpy decoder params in the JAX layout: N(0, 1/fan_in) weights,
    small random biases and norms."""
    rng = np.random.default_rng(seed)
    L, H, hd, I = cfg.n_layers, cfg.hidden, cfg.head_dim, cfg.intermediate
    f = np.float32

    def w(*shape):
        return (rng.normal(size=shape) / np.sqrt(shape[-2])).astype(f)

    def b(*shape):
        return (0.1 * rng.normal(size=shape)).astype(f)

    lay = {"ln1": {"w": 1 + b(L, H)}, "ln2": {"w": 1 + b(L, H)}}
    for n, d in (("q", cfg.n_heads * hd), ("k", cfg.n_kv_heads * hd),
                 ("v", cfg.n_kv_heads * hd)):
        lay[n] = {"w": w(L, H, d), "b": b(L, d)}
    lay["o"] = {"w": w(L, cfg.n_heads * hd, H), "b": None}
    for n, (i, o) in (("gate", (H, I)), ("up", (H, I)), ("down", (I, H))):
        lay[n] = {"w": w(L, i, o), "b": None}
    return {"embed": {"w": rng.normal(size=(cfg.vocab, H)).astype(f)},
            "layers": lay, "ln_f": {"w": 1 + b(H)},
            "lm_head": {"w": w(H, cfg.vocab)}}


class Model:
    """One decoder in both packages on the same weights."""

    def __init__(self, seed, **kw):
        self.jc, self.tc = _cfgs(**kw)
        self.np = _params(self.jc, seed)
        self.pj = jax.tree.map(jnp.asarray, self.np)
        self.pt = interop.to_torch(self.np, device="cpu")

    def engines(self, **kw):
        return (JEngine(self.jc, self.pj, **kw),
                poisoned(TEngine(self.tc, self.pt, **kw)))

    def solo(self, prompt, n, eos_id=None, positions=None):
        """The port's Generator serving the prompt alone (host loop)."""
        gen = TGenerator(self.tc, self.pt, max_len=128)
        x = (torch.from_numpy(np.asarray(prompt, np.float32))[None]
             if np.ndim(prompt) == 2
             else torch.tensor(np.asarray(prompt, np.int64))[None])
        pos = None if positions is None else torch.from_numpy(
            np.broadcast_to(np.asarray(positions),
                            (3, x.shape[1]))[:, None].copy())
        toks = gen.generate(x, max_new_tokens=n, eos_id=eos_id,
                            positions=pos)[0].tolist()
        return toks[:toks.index(eos_id)] if eos_id in toks else toks


def poisoned(eng):
    """NaN in every KV row of the pool, and in every row a growth adds."""
    grow = eng._grow

    def poison_grow(need):
        grow(need)
        for nm in ("k", "v"):
            eng.cache[nm][:, :, eng._filled:] = float("nan")
        eng._filled = eng._cache_S()

    eng._filled = 0
    eng._grow = poison_grow
    for nm in ("k", "v"):
        eng.cache[nm].fill_(float("nan"))
    eng._filled = eng._cache_S()
    return eng


def serve(eng, reqs, prefixes=()):
    for p in prefixes:
        eng.register_prefix(p)
    rids = [eng.submit(**r) for r in reqs]
    outs = eng.run()
    return [outs[r] for r in rids], [eng.logprobs_of(r) for r in rids]


def assert_same(je, te, reqs, prefixes=()):
    """Both engines serve ``reqs``: tokens equal, logprobs within LP_ATOL.
    Returns the port's outputs."""
    tj, lj = serve(je, reqs, prefixes)
    tt, lt = serve(te, reqs, prefixes)
    assert tt == tj
    for a, b in zip(lt, lj):
        np.testing.assert_allclose(a, b, rtol=0, atol=LP_ATOL)
    assert je.prefix_hits == te.prefix_hits
    return tt


def _ids(*prompts, n=7):
    return [dict(tokens_or_embeds=list(p), max_new_tokens=n) for p in prompts]


# ---------------------------------------------------------------------------
# per-row positions through decoder_forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [1, 3])
def test_per_row_decoder_forward_matches_jax_and_rows_alone(T):
    """(B,) cache ``pos`` and ``rope_delta``: logits within LOGIT_RTOL of
    JAX's per-row path and of each row run alone, at a (1,) pos and at a
    scalar pos, with the same argmax (alone, the CPU's f32 products run at
    M = 1, and a CPU cache's scalar pos sums over the written prefix only:
    sums of other orders); the written rows in place, ``pos`` advanced per
    row; columns ≥ pos poisoned with NaN in the port's cache."""
    m = Model(40)
    rng = np.random.default_rng(1)
    B, S = 3, 32
    pos = np.array([5, 0, 17], np.int32)
    delta = np.array([0, 4, -2], np.int32)
    kc = rng.normal(size=(2, B, S, 2, 12)).astype(np.float32)
    vc = rng.normal(size=(2, B, S, 2, 12)).astype(np.float32)
    toks = rng.integers(0, 96, size=(B, T))
    lj, cj, _ = JLLM.decoder_forward(
        m.jc, m.pj, jnp.asarray(toks),
        cache={"k": jnp.asarray(kc), "v": jnp.asarray(vc),
               "pos": jnp.asarray(pos), "rope_delta": jnp.asarray(delta)})
    cols = np.arange(S)[None, :, None, None]
    stale = cols >= pos[:, None, None, None]
    kt, vt = (np.where(stale[None], np.nan, a).astype(np.float32)
              for a in (kc, vc))
    ct = {"k": torch.from_numpy(kt), "v": torch.from_numpy(vt),
          "pos": torch.from_numpy(pos), "rope_delta": torch.from_numpy(delta)}
    lt, ct, _ = TLLM.decoder_forward(m.tc, m.pt, torch.from_numpy(toks),
                                     cache=ct)
    assert ct["pos"].tolist() == (pos + T).tolist()
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=LOGIT_RTOL * np.abs(np.asarray(lj)).max())
    for b in range(B):  # the written rows equal JAX's
        sl = slice(pos[b], pos[b] + T)
        np.testing.assert_allclose(ct["k"][:, b, sl].numpy(),
                                   np.asarray(cj["k"])[:, b, sl], atol=1e-6)
    for b in range(B):  # each row alone: a (1,) pos, then a scalar pos
        for p in (torch.from_numpy(pos[b:b + 1]),
                  torch.tensor(int(pos[b]), dtype=torch.int32)):
            one = {"k": torch.from_numpy(kt[:, b:b + 1].copy()),
                   "v": torch.from_numpy(vt[:, b:b + 1].copy()), "pos": p,
                   "rope_delta": torch.from_numpy(delta[b:b + 1])}
            la, _, _ = TLLM.decoder_forward(m.tc, m.pt,
                                            torch.from_numpy(toks[b:b + 1]),
                                            cache=one)
            np.testing.assert_allclose(
                la[0].numpy(), lt[b].numpy(), rtol=0,
                atol=LOGIT_RTOL * np.abs(lt[b].numpy()).max())
            assert torch.equal(la[0].argmax(-1), lt[b].argmax(-1))


def test_init_cache_quantized_raises():
    with pytest.raises(NotImplementedError, match="A5"):
        TLLM.init_cache(_cfgs()[1], 1, 16, device="cpu", quantized=8)


# ---------------------------------------------------------------------------
# the engine (tests/test_engine.py's cases)
# ---------------------------------------------------------------------------


def test_pool_matches_jax_and_solo():
    """Three prompts, two slots: continuous admission."""
    m = Model(0)
    prompts = [range(1, 6), range(20, 29), range(40, 43)]
    je, te = m.engines(slots=2, max_len=128, steps_per_block=3)
    out = assert_same(je, te, _ids(*prompts))
    for o, p in zip(out, prompts):
        assert o == m.solo(list(p), 7)


def test_admission_mid_flight():
    m = Model(1)
    outs = []
    for eng in m.engines(slots=2, max_len=128, steps_per_block=2):
        ra = eng.submit(list(range(1, 9)), max_new_tokens=9)
        fin = dict(eng.step_block())
        rb = eng.submit(list(range(30, 34)), max_new_tokens=5)
        while eng._queue or any(eng._active):
            fin.update(eng.step_block())
        outs.append((fin[ra], fin[rb]))
    assert outs[0] == outs[1]
    assert outs[1] == (m.solo(range(1, 9), 9), m.solo(range(30, 34), 5))


def test_eos_frees_slot_for_queue():
    m = Model(2)
    p1, p2 = list(range(1, 7)), list(range(50, 60))
    eos = m.solo(p1, 12)[3]
    je, te = m.engines(slots=1, max_len=128, steps_per_block=4, eos_id=eos)
    out = assert_same(je, te, [dict(tokens_or_embeds=p1, max_new_tokens=12),
                               dict(tokens_or_embeds=p2, max_new_tokens=6)])
    assert out[0] == m.solo(p1, 12, eos_id=eos)
    assert out[1] == m.solo(p2, 6, eos_id=eos)


@pytest.mark.parametrize("kw", [dict(kv_quant=True), dict(kv_quant=4),
                                dict(ntk_alpha=2.0)])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError, match="A5"):
        TEngine(_cfgs()[1], Model(3).pt, slots=2, max_len=128, **kw)


def _mrope(T, lo, hi, fill):
    pos = np.broadcast_to(np.arange(T)[None], (3, T)).copy()
    pos[1:, lo:hi] = fill
    return pos


def test_mrope_positions():
    m = Model(4, mrope_sections=(2, 2, 2), head_dim=12)
    pos = _mrope(8, 2, 6, 2)
    prompt = list(range(5, 13))
    je, te = m.engines(slots=2, max_len=128, steps_per_block=3)
    out = assert_same(je, te, [dict(tokens_or_embeds=prompt,
                                     max_new_tokens=6, positions=pos)])
    assert out[0] == m.solo(prompt, 6, positions=pos)


def test_embeds_request():
    m = Model(5)
    emb = np.random.default_rng(9).normal(size=(7, 48)).astype(np.float32)
    je, te = m.engines(slots=2, max_len=128, steps_per_block=4)
    out = assert_same(je, te, [dict(tokens_or_embeds=emb, max_new_tokens=5)])
    assert out[0] == m.solo(emb, 5)
    # an embeds tensor (the runner's, kept on its device) serves the same
    te2 = poisoned(TEngine(m.tc, m.pt, slots=2, max_len=128,
                           steps_per_block=4))
    assert serve(te2, [dict(tokens_or_embeds=torch.from_numpy(emb),
                            max_new_tokens=5)])[0] == out


@pytest.mark.parametrize("n", [8, 90])
def test_capacity_guard(n):
    m = Model(6)
    eng = TEngine(m.tc, m.pt, slots=1, max_len=32)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(list(range(30)) if n == 8 else list(range(1, 200)),
                   max_new_tokens=8)


def test_batched_admission_mixed_lengths():
    m = Model(21)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 90, size=n) for n in (20, 23, 22, 40)]
    je, te = m.engines(slots=4, max_len=128, steps_per_block=4)
    out = assert_same(je, te, _ids(*prompts))
    assert any(k[0] == "admitN" for k in te.admissions)
    for o, p in zip(out, prompts):
        assert o == m.solo(p, 7)


def test_batched_admission_token_cap():
    m = Model(23)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 90, size=20) for _ in range(5)]
    je, te = m.engines(slots=5, max_len=128, steps_per_block=4,
                       admit_batch_tokens=96)
    out = assert_same(je, te, _ids(*prompts, n=5))
    sizes = {k[2] for k in te.admissions if k[0] == "admitN"}
    assert sizes and max(sizes) <= 2, sizes
    assert out[4] == m.solo(prompts[4], 5)


def test_batched_admission_mrope():
    m = Model(22, mrope_sections=(2, 2, 2), head_dim=12)
    pa, pb = _mrope(8, 2, 6, 2), _mrope(8, 1, 5, 1)
    qa, qb = list(range(5, 13)), list(range(40, 48))
    je, te = m.engines(slots=2, max_len=128, steps_per_block=3)
    out = assert_same(je, te, [
        dict(tokens_or_embeds=qa, max_new_tokens=6, positions=pa),
        dict(tokens_or_embeds=qb, max_new_tokens=6, positions=pb)])
    assert any(k[0] == "admitN" for k in te.admissions)
    assert out == [m.solo(qa, 6, positions=pa), m.solo(qb, 6, positions=pb)]


# -- prefix caching ----------------------------------------------------------


def test_prefix_reuse_matches_solo():
    m = Model(10)
    sys_p = list(range(30, 42))
    prompts = [sys_p + [3, 1, 4], sys_p + list(range(60, 70)), [9, 8, 7, 6]]
    je, te = m.engines(slots=2, max_len=128, steps_per_block=3)
    out = assert_same(je, te, _ids(*prompts, n=6), prefixes=[sys_p])
    assert te.prefix_hits == 2
    assert out == [m.solo(p, 6) for p in prompts]


def test_longest_prefix_wins_and_row_survives_reuse():
    m = Model(11)
    short = list(range(20, 26))
    long = short + list(range(50, 58))
    prompts = [long + [2, 4], long + [7]]
    je, te = m.engines(slots=1, max_len=128)
    out = assert_same(je, te, _ids(*prompts, n=5), prefixes=[short, long])
    assert te.prefix_hits == 2
    assert out == [m.solo(p, 5) for p in prompts]


# -- chunked admission ------------------------------------------------------


def test_chunked_matches_solo():
    m = Model(13)
    p = list(range(1, 38))  # 37 tokens, chunk 8 → 5 pieces
    je, te = m.engines(slots=2, max_len=128, steps_per_block=3,
                       admit_chunk=8)
    assert assert_same(je, te, _ids(p, n=6))[0] == m.solo(p, 6)
    assert te.admissions == {("row_step", 16, False, False): 5}


def test_decode_proceeds_during_admission():
    m = Model(14)
    short, long = list(range(5, 10)), list(range(1, 33))
    res = []
    for eng in m.engines(slots=2, max_len=128, steps_per_block=2,
                         admit_chunk=8):
        rs = eng.submit(short, max_new_tokens=12)
        eng.step_block()
        n0 = len(eng._active[0].out)
        rl = eng.submit(long, max_new_tokens=4)
        eng.step_block()
        assert eng._admitting is not None
        assert len(eng._active[0].out) > n0
        outs = {}
        while len(outs) < 2:
            outs.update(eng.step_block())
        res.append((outs[rs], outs[rl]))
    assert res[0] == res[1] == (m.solo(short, 12), m.solo(long, 4))


def test_prefix_plus_chunked_and_chunked_embeds():
    m = Model(15)
    sys_p = list(range(40, 50))
    p = sys_p + list(range(1, 22))
    emb = np.random.default_rng(17).normal(size=(23, 48)).astype(np.float32)
    je, te = m.engines(slots=1, max_len=128, admit_chunk=8)
    out = assert_same(je, te, [dict(tokens_or_embeds=p, max_new_tokens=5),
                               dict(tokens_or_embeds=emb, max_new_tokens=5)],
                      prefixes=[sys_p])
    assert te.prefix_hits == 1
    assert out == [m.solo(p, 5), m.solo(emb, 5)]


# -- speculation ---------------------------------------------------------------


@pytest.mark.parametrize("prompts", [
    [list(range(1, 8)), [5, 9, 2, 7, 5, 9, 2, 7], list(range(40, 51))],
    [list(range(1, 6)), list(range(20, 29)), [30, 31, 32], [7, 7, 7, 7]]])
def test_spec_pool_matches_plain(prompts):
    """spec_k > 0: tokens equal to JAX's speculative engine, to the plain
    engine and to solo runs; logprobs equal to the plain engine's."""
    m = Model(20)
    n = 9 if len(prompts) == 3 else 6
    je, te = m.engines(slots=2, max_len=128, steps_per_block=2, spec_k=4)
    out = assert_same(je, te, _ids(*prompts, n=n))
    plain = poisoned(TEngine(m.tc, m.pt, slots=2, max_len=128,
                             steps_per_block=3))
    tp, lp = serve(plain, _ids(*prompts, n=n))
    assert out == tp == [m.solo(p, n) for p in prompts]
    np.testing.assert_allclose(
        np.concatenate([te.logprobs_of(r) for r in range(len(prompts))]),
        np.concatenate(lp), rtol=0, atol=LP_ATOL)
    assert (te.stats()["spec_accept_per_round"]
            == je.stats()["spec_accept_per_round"])


def test_spec_pool_eos_and_prefix():
    m = Model(21)
    p = [5, 9, 2, 7, 5, 9, 2, 7]
    base = m.solo(p, 12)
    eos = base[len(base) // 2]
    je, te = m.engines(slots=2, max_len=128, steps_per_block=2, eos_id=eos,
                       spec_k=4)
    assert assert_same(je, te, _ids(p, n=12)) == [m.solo(p, 12, eos_id=eos)]
    sys_p = list(range(10, 22))
    q = sys_p + [3, 1, 4]
    je, te = m.engines(slots=2, max_len=128, steps_per_block=2, spec_k=3)
    assert assert_same(je, te, _ids(q), prefixes=[sys_p]) == [m.solo(q, 7)]
    assert te.prefix_hits == 1


def test_embeds_with_draft_ids_seed_history():
    m = Model(30)
    ids = np.arange(3, 10)
    emb = m.np["embed"]["w"][ids]
    res = []
    for eng in m.engines(slots=1, max_len=128, spec_k=3, steps_per_block=2):
        rid = eng.submit(emb, max_new_tokens=6, draft_ids=ids)
        eng.step_block()
        assert int(np.asarray(eng.hist_len)[0]) >= len(ids) + 1
        assert list(np.asarray(eng.hist)[0, :len(ids)]) == list(ids)
        outs = eng.step_block()
        while rid not in outs:
            outs.update(eng.step_block())
        res.append(outs[rid])
    assert res[0] == res[1] == m.solo(emb, 6)


def test_mrope_mismatched_positions_skip_prefix():
    m = Model(6)
    eng = poisoned(TEngine(m.tc, m.pt, slots=1, max_len=128,
                           steps_per_block=2))
    eng.register_prefix(list(range(1, 9)))
    emb = np.random.default_rng(1).random((12, 48)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12), (3, 12)).copy()
    pos[:, :8] += 1
    eng.submit(emb, max_new_tokens=4, positions=pos,
               draft_ids=list(range(1, 13)))
    eng.run()
    assert eng.prefix_hits == 0


# -- sampling and penalties ------------------------------------------------------


def test_sampling_and_penalties_match_jax():
    """A pool of greedy, sampled and penalized rows (explicit and engine-
    derived seeds): tokens equal to JAX's, the greedy row equal to solo."""
    m = Model(70)
    reqs = [dict(tokens_or_embeds=list(range(3, 10)), max_new_tokens=10,
                 temperature=1.5, seed=42),
            dict(tokens_or_embeds=list(range(40, 52)), max_new_tokens=12,
                 temperature=0.9),
            dict(tokens_or_embeds=list(range(60, 64)), max_new_tokens=6),
            dict(tokens_or_embeds=list(range(3, 9)), max_new_tokens=24,
                 frequency_penalty=1.5),
            dict(tokens_or_embeds=list(range(3, 9)), max_new_tokens=6,
                 presence_penalty=100.0, temperature=0.8, top_p=0.9)]
    je, te = m.engines(slots=3, max_len=160, steps_per_block=3,
                       sample_top_k=8, seed=5)
    out = assert_same(je, te, reqs)
    assert out[2] == m.solo(range(60, 64), 6)
    assert out[4][0] not in range(3, 9)
    # a seeded request replays alone in another engine
    alone = poisoned(TEngine(m.tc, m.pt, slots=3, max_len=128,
                             steps_per_block=3, sample_top_k=8, seed=999))
    assert serve(alone, reqs[:1])[0][0] == out[0]


def test_sampling_requires_sampling_engine():
    m = Model(11)
    eng = TEngine(m.tc, m.pt, slots=1, max_len=64)
    with pytest.raises(ValueError, match="sample_top_k"):
        eng.submit([1, 2, 3], max_new_tokens=4, temperature=1.0)
    with pytest.raises(ValueError, match="exclusive"):
        TEngine(m.tc, m.pt, slots=1, max_len=64, sample_top_k=8, spec_k=2)


def test_cancel_states():
    m = Model(3)
    res = []
    for eng in m.engines(slots=1, max_len=128, steps_per_block=2):
        ra = eng.submit(list(range(1, 6)), max_new_tokens=8)
        rb = eng.submit(list(range(20, 26)), max_new_tokens=6)
        assert eng.cancel(rb)
        eng.step_block()
        assert eng.cancel(ra)
        while eng._queue or any(eng._active):
            eng.step_block()
        rc = eng.submit(list(range(40, 45)), max_new_tokens=6)
        res.append(eng.run()[rc])
        assert not eng.cancel(rc)
    assert res[0] == res[1] == m.solo(range(40, 45), 6)


# -- warmup and growth ------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, dict(sample_top_k=8), dict(spec_k=3)])
def test_warmup_leaves_state_untouched(kw):
    m = Model(30)
    p = list(range(1, 9))
    cold = TEngine(m.tc, m.pt, slots=2, max_len=128, steps_per_block=3, **kw)
    want = serve(cold, _ids(p, n=6))
    warm = TEngine(m.tc, m.pt, slots=2, max_len=128, steps_per_block=3, **kw)
    warm.warmup(prompt_lens=(8, 16))
    assert warm.stats()["graphs"] == 1
    assert not any(warm._active) and int(warm.cache["pos"].abs().sum()) == 0
    assert serve(warm, _ids(p, n=6)) == want


def test_bucketed_growth_outputs_exact():
    m = Model(0)
    je, te = m.engines(slots=2, max_len=1024, steps_per_block=4)
    assert te._cache_S() == 256
    p_short = np.arange(1, 20)
    p_long = np.arange(300) % 40 + 1
    ra = te.submit(p_short, max_new_tokens=6)
    assert te._cache_S() == 256
    rb = te.submit(p_long, max_new_tokens=6)
    assert te._cache_S() == 512
    outs = te.run()
    jr = [je.submit(p, max_new_tokens=6) for p in (p_short, p_long)]
    jo = je.run()
    assert [outs[ra], outs[rb]] == [jo[r] for r in jr]
    assert outs[ra] == m.solo(p_short, 6)


def test_growth_with_registered_prefix():
    m = Model(1)
    pref = np.arange(1, 33)
    long_req = np.concatenate([pref, np.arange(270) % 40 + 1])
    je, te = m.engines(slots=2, max_len=1024, steps_per_block=4)
    out = assert_same(je, te, [dict(tokens_or_embeds=long_req,
                                     max_new_tokens=5)], prefixes=[pref])
    assert te.prefix_hits == 1
    assert out[0] == m.solo(long_req, 5)
