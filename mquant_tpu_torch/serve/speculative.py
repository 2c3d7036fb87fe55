"""Self-speculative decoding: n-gram drafting + exact multi-token verify
(counterpart of ``mquant_tpu/serve/speculative.py``).

The draft for the next k tokens is the continuation of the latest earlier
occurrence of the current n-gram suffix in the token history (prompt
lookup); one forward verifies ``[next_tok, d_1..d_k]`` at the cache
position P, the draft is accepted while it equals the greedy argmax, and
``pos`` rolls back to P + m so only the accepted tokens' KV rows count. The
verify forward (``decoder_forward(..., verify=True)``) gives window row j
the logits of the decode step at P + j, bit for bit (the decode step's
attention route one query row at a time, its row counts for every product
whose rounding depends on them), so the output is the plain greedy decode
over a cache of the same length, on the CPU and on the card, whatever the
drafts. The engine's batched rounds (``serve.engine``) use
:func:`ngram_propose` per slot.

Rollback correctness: after the verify, rows P..P+k hold the KV of
[next_tok, d_1..d_k]; the accepted context is [next_tok, g_0..g_{m-2}] and
d_i == g_{i-1} for every i < m, so rows P..P+m-1 are exactly the accepted
tokens' KV.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .generate import Generator, bucket_len


def ngram_propose(ctx: torch.Tensor, length: torch.Tensor, k: int,
                  max_n: int = 3) -> torch.Tensor:
    """Draft ``k`` tokens per row: the continuation of the latest earlier
    occurrence of the longest matching suffix n-gram (n = max_n..1) of
    ``ctx[b, :length[b]]``. ctx (B, S) or (S,) int history (entries ≥ length
    ignored), length (B,) or 0-d. Returns (B, k) or (k,). With no recurring
    n-gram the draft is arbitrary; the verify still emits one exact token.
    Fixed-shape vector compares, no host read (JAX's function, per row)."""
    single = ctx.ndim == 1
    ctx = ctx.reshape(-1, ctx.shape[-1]).to(torch.long)
    B, S = ctx.shape
    length = length.to(device=ctx.device, dtype=torch.long).reshape(-1
                                                                   ).expand(B)
    idx = torch.arange(S, device=ctx.device)
    start = torch.full((B,), -1, dtype=torch.long, device=ctx.device)
    for n in range(max_n, 0, -1):  # longest n-gram wins
        m = torch.ones((B, S), dtype=torch.bool, device=ctx.device)
        for t in range(n):
            at = length - n + t
            at = torch.where(at < 0, at + S, at)  # JAX's negative index
            m &= torch.roll(ctx, -t, dims=1) == ctx.gather(1, at[:, None])
        m &= idx[None] <= (length - n - 1)[:, None]
        j = torch.where(m, idx[None], torch.full_like(ctx, -1)).amax(dim=1)
        start = torch.where((start < 0) & (j >= 0), j + n, start)
    start = start.clamp(0, S - k)
    out = ctx.gather(1, start[:, None] + torch.arange(k, device=ctx.device))
    out = out.to(torch.int32)
    return out[0] if single else out


@torch.no_grad()
def speculative_generate(gen: Generator, tokens: torch.Tensor,
                         max_new_tokens: int = 32, k: int = 7,
                         eos_id: Optional[int] = None,
                         return_stats: bool = False):
    """Greedy generation by self-speculative decoding, B = 1: the plain
    greedy decode (``Generator.generate_on_device`` at the same cache
    length; module docstring); the drafts only change how many forwards it
    takes. The loop runs on the host with one
    read of the accepted count a round. Returns a (n,) int32 array of
    tokens cut before eos, plus ``{"iters", "accepted_per_iter"}`` with
    ``return_stats``. (JAX's ``force_accept``, a measuring instrument of
    its bench, has no caller here.)"""
    if tokens.ndim != 2 or tokens.shape[0] != 1:
        raise ValueError("speculative_generate: B = 1 only")
    T = tokens.shape[1]
    # verify windows overhang by up to k rows before the rollback
    gen.ensure_capacity(bucket_len(T) + max_new_tokens + k + 1)
    last_logits, cache = gen.prefill(tokens)
    first = int(last_logits[0].argmax())
    dev = last_logits.device
    hist_len = bucket_len(T + max_new_tokens + k + 1, minimum=64)
    ctx = torch.zeros((hist_len,), dtype=torch.int32, device=dev)
    ctx[:T] = tokens[0].to(torch.int32)
    ctx[T] = first
    length = T + 1
    if eos_id is not None and first == eos_id:
        toks = np.zeros((0,), np.int32)
        stats = {"iters": 0, "accepted_per_iter": float("nan")}
        return (toks, stats) if return_stats else toks
    budget = max_new_tokens - 1
    out = [first]
    nxt, iters, done = first, 0, False
    while len(out) - 1 < budget and not done and iters < budget:
        draft = ngram_propose(ctx, torch.tensor(length, device=dev), k)
        window = torch.cat([torch.tensor([nxt], dtype=torch.int32,
                                         device=dev), draft])[None]
        pos0 = cache["pos"]
        logits, cache = gen._forward(window, cache, verify=True)
        g = logits[0].argmax(dim=-1).to(torch.int32)  # (k+1,)
        agree = torch.cumprod((draft == g[:-1]).to(torch.int32), dim=0)
        m = 1 + int(agree.sum())
        g_host = g.tolist()
        if eos_id is not None and eos_id in g_host[:m]:
            m = g_host.index(eos_id) + 1
            done = True
        m = min(m, budget - (len(out) - 1))
        out += g_host[:m]
        ctx[length:length + k + 1] = g[:min(k + 1, hist_len - length)]
        length += m
        cache["pos"] = pos0 + m  # rollback: keep the m accepted rows
        nxt = g_host[m - 1]
        iters += 1
    toks = np.asarray(out, np.int32)
    if eos_id is not None and eos_id in out:
        toks = toks[:out.index(eos_id)]
    stats = {"iters": iters + 1,
             "accepted_per_iter": (len(out) - 1) / max(iters, 1)}
    return (toks, stats) if return_stats else toks
