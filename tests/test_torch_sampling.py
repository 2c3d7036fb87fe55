"""The port's token sampling (``mquant_tpu_torch/serve/sampling.py``) against
``mquant_tpu/serve/sampling.py`` and ``jax.random``.

The seed-keyed noise is JAX's threefry2x32 written as int64 tensor
arithmetic: every word and every uniform is held bit-equal to
``jax.random`` on a grid of seeds and counts. ``top_k`` breaks ties by the
lower index, as ``lax.top_k`` does; the tied logits are built on purpose.
Sampled tokens are held equal to JAX's ``sample_tokens`` with per-row seeds
(f32 logits, where the two packages' softmax / cumsum / log may differ in
the last bit: no near-tie is drawn at these seeds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mquant_tpu.serve import sampling as JS
from mquant_tpu_torch.serve import sampling as TS

SEEDS = np.array([0, 1, 2, 7, 42, 1000003, 123456789, 2**31 - 1], np.int32)
COUNTS = np.array([0, 1, 5, 63, 64, 1000, 65535, 2**20], np.int32)


def _bits(x):
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("n", [1, 8, 64])
def test_row_noise_bit_equal_to_jax(n):
    """fold_in(fold_in(key(0), seed), count) → uniform(k, (n,), f32,
    1e-20, 1): every seed × count of the grid, bit for bit."""
    s = np.repeat(SEEDS, len(COUNTS))
    c = np.tile(COUNTS, len(SEEDS))

    def one(seed, cnt):
        k = jax.random.fold_in(jax.random.fold_in(jax.random.key(0), seed),
                               cnt)
        return jax.random.uniform(k, (n,), jnp.float32, 1e-20, 1.0)

    want = jax.vmap(one)(jnp.asarray(s), jnp.asarray(c))
    got = TS.row_noise(torch.from_numpy(s), torch.from_numpy(c), n)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_fold_in_and_bits_equal_to_jax():
    """The key words after each fold_in and the raw 32-bit draws."""
    for seed in SEEDS:
        kj = jax.random.fold_in(jax.random.key(0), int(seed))
        z = torch.zeros((), dtype=torch.int64)
        kt = TS.fold_in((z, z), torch.tensor(int(seed)))
        np.testing.assert_array_equal(
            np.asarray(jax.random.key_data(kj)).astype(np.int64),
            [int(kt[0]), int(kt[1])])
        want = jax.random.bits(kj, (16,), jnp.uint32)
        got = TS.uniform_bits(kt, 16)
        np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                      np.asarray(want))


def test_threefry_known_answer():
    """Threefry-2x32 (20 rounds) on the Random123 known-answer vectors."""
    cases = [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
             ((0xFFFFFFFF,) * 2, (0xFFFFFFFF,) * 2,
              (0x1CB996FC, 0xBB002BE7)),
             ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
              (0xC4923A9C, 0x483DF7A0))]
    for key, x, want in cases:
        t = [torch.tensor(v, dtype=torch.int64) for v in key + x]
        got = TS.threefry2x32(*t)
        assert (int(got[0]), int(got[1])) == want


def test_top_k_ties_break_by_lower_index():
    rng = np.random.default_rng(0)
    x = rng.integers(-3, 4, size=(6, 50)).astype(np.float32)  # many ties
    x[0] = 1.0  # all equal
    x[1, ::2] = 5.0
    bf = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    for arr in (x, bf):
        vj, ij = jax.lax.top_k(jnp.asarray(arr), 20)
        vt, it = TS.top_k(torch.from_numpy(arr), 20)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("top_k", [1, 8, 64])
def test_sample_tokens_equal_to_jax(top_k):
    """Mixed pool: greedy rows (t = 0), sampled rows at several
    temperatures and top-p values, per-row seeds and counts."""
    rng = np.random.default_rng(top_k)
    B, V = 8, 300
    logits = rng.normal(size=(B, V)).astype(np.float32) * 3
    temp = np.array([0, 0.5, 0.8, 1.0, 1.5, 2.0, 0, 3.0], np.float32)
    top_p = np.array([1, 0.9, 0.5, 1.0, 0.95, 0.3, 1, 0.99], np.float32)
    for step in range(4):
        seeds = rng.integers(0, 2**31 - 1, size=B).astype(np.int32)
        counts = rng.integers(0, 500, size=B).astype(np.int32)
        want = JS.sample_tokens(jnp.asarray(logits), jax.random.key(0),
                                jnp.asarray(temp), jnp.asarray(top_p), top_k,
                                seeds=jnp.asarray(seeds),
                                counts=jnp.asarray(counts))
        got = TS.sample_tokens(torch.from_numpy(logits),
                               torch.from_numpy(temp),
                               torch.from_numpy(top_p), top_k,
                               torch.from_numpy(seeds),
                               torch.from_numpy(counts))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.int32
    # greedy rows take the argmax
    assert got[0] == int(np.argmax(logits[0]))


def test_host_sample_first_equal_to_jax():
    rng = np.random.default_rng(3)
    for t, p in ((0.0, 1.0), (0.7, 0.9), (1.3, 1.0), (2.0, 0.2)):
        vals = np.sort(rng.normal(size=16).astype(np.float32))[::-1]
        idx = np.arange(16)
        a = JS.host_sample_first(vals, idx, t, p, np.random.default_rng(5))
        b = TS.host_sample_first(vals, idx, t, p, np.random.default_rng(5))
        assert a == b
