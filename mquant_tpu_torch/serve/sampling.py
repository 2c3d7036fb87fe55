"""Token sampling for the serving path (counterpart of
``mquant_tpu/serve/sampling.py``): temperature, top-k, top-p.

A static ``top_k`` cap bounds the categorical to the top-k slice; per-row
``temperature`` and ``top_p`` are tensors, so one decode block serves a pool
that mixes greedy (t = 0) and sampled rows; the Gumbel-max trick picks the
token. Each row's noise is keyed by (its request seed, its emitted-token
index) only, so a sampled request replays the same tokens under any pool
schedule.

The noise is JAX's, bit for bit: ``fold_in(fold_in(key(0), seed), count)``
then ``uniform(k, (top_k,), f32, 1e-20, 1.0)`` under the threefry2x32 PRNG
(JAX's default, with ``jax_threefry_partitionable``), written here as
tensor arithmetic in int64 masked to 32 bits (torch has no unsigned 32-bit
shifts on CUDA). It runs on the CPU and on the card and can be captured in
a CUDA graph, so a request's sampled tokens are the same in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """Threefry-2x32 with 20 rounds (JAX's ``threefry2x32_p``) on int64
    tensors holding unsigned 32-bit words; broadcasts its operands."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def fold_in(key, data: torch.Tensor):
    """JAX's ``random.fold_in`` of one uint32 ``data`` per key: key is a
    pair of (…) int64 word tensors, ``data`` (…) integers."""
    d = data.to(torch.int64) & _M32
    return threefry2x32(key[0], key[1], torch.zeros_like(d), d)


def uniform_bits(key, n: int) -> torch.Tensor:
    """JAX's 32-bit ``random_bits(key, 32, (n,))`` with partitionable
    threefry: (…, n) words, the counter i hashed as (0, i) and the two
    output words xor-ed."""
    i = torch.arange(n, dtype=torch.int64, device=key[0].device)
    y0, y1 = threefry2x32(key[0][..., None], key[1][..., None],
                          torch.zeros_like(i), i)
    return y0 ^ y1


def uniform(key, n: int, minval: float = 1e-20, maxval: float = 1.0
            ) -> torch.Tensor:
    """JAX's ``random.uniform(key, (n,), float32, minval, maxval)``: the top
    23 bits as the mantissa of a float in [1, 2), minus 1, scaled in f32."""
    bits = uniform_bits(key, n)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # JAX casts the bounds to f32 first; their f32 difference is exact in
    # f32 here (no host-to-device copy, so a CUDA graph can capture this)
    lo, hi = np.float32(minval), np.float32(maxval)
    return (f * float(hi - lo) + float(lo)).clamp_min(float(lo))


def row_noise(seeds: torch.Tensor, counts: torch.Tensor, n: int
              ) -> torch.Tensor:
    """(B, n) f32 uniforms of ``fold_in(fold_in(key(0), seed), count)``,
    one key per row."""
    zero = torch.zeros_like(seeds, dtype=torch.int64)
    key = fold_in((zero, zero), seeds)
    return uniform(fold_in(key, counts), n)


def top_k(x: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, descending, ties
    by the lower index (a stable descending sort; ``torch.topk`` promises
    no order among equal values)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def sample_tokens(logits: torch.Tensor, temp: torch.Tensor,
                  top_p: torch.Tensor, top_k_: int, seeds: torch.Tensor,
                  counts: torch.Tensor) -> torch.Tensor:
    """One token per row. logits (B, V); temp / top_p (B,); ``top_k_``
    static; seeds / counts (B,) int. Rows with temp == 0 get the exact
    argmax; the others a Gumbel-max draw over the top-k slice of
    logits / temp with the nucleus mask (drop a candidate once the
    probability before it reaches top_p; the first always survives)."""
    greedy = logits.argmax(dim=-1).to(torch.int32)
    l32 = logits.float()
    t = temp.clamp_min(1e-6)[:, None]
    vals, idx = top_k(l32 / t, top_k_)
    probs = torch.softmax(vals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    vals = torch.where(cum - probs < top_p[:, None], vals,
                       torch.full_like(vals, -float("inf")))
    u = row_noise(seeds, counts, top_k_)
    g = -torch.log(-torch.log(u))
    choice = (vals + g).argmax(dim=-1, keepdim=True)
    sampled = idx.gather(-1, choice)[:, 0].to(torch.int32)
    return torch.where(temp > 0, sampled, greedy)


def host_sample_first(vals: np.ndarray, idx: np.ndarray, temperature: float,
                      top_p: float, rng: np.random.Generator) -> int:
    """Sample the ADMISSION token on the host from the prefill logits' raw
    top-k slice (vals descending); returns the position within the slice
    (callers map it to ``idx[pos]``). The JAX function's numpy, so the same
    ``rng`` gives the same position."""
    del idx  # position-based contract; kept for signature clarity
    if temperature <= 0:
        return 0
    v = np.asarray(vals, np.float64) / max(temperature, 1e-6)
    v -= v.max()
    p = np.exp(v)
    p /= p.sum()
    cum = np.cumsum(p)
    keep = (cum - p) < top_p
    p = np.where(keep, p, 0.0)
    p /= p.sum()
    return int(rng.choice(len(p), p=p))
