"""Greedy generation with a KV cache — prefill / decode split (counterpart of
``mquant_tpu/serve/generate.py``).

Prompt lengths are bucketed to powers of two (``bucket_len``) as in the JAX
package. The decode loop is JAX's on-device loop (``_decode_n``: one
``fori_loop``, or a ``while_loop`` with eos, in one jit) in PyTorch's idiom:
:class:`DecodeLoop` captures one greedy step (forward, argmax, eos freeze,
the write of the token's column) on static buffers in a CUDA graph and
replays it once per token with no host sync between replays; with an eos id
the host reads an all-done flag every ``EOS_CHECK_EVERY`` steps through a
pinned copy, and rows past their eos are frozen to eos, so steps run after
the last row finished change no output. On CPU tensors the same step runs
eagerly. :meth:`Generator._decode_loop` is the eager reference. The
``measure_*`` helpers time prefill, decode and requests as the JAX ones do.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.llm import (DecoderConfig, decoder_forward, init_cache,
                          ntk_alpha_for)

EOS_CHECK_EVERY = 8  # decode steps between two reads of the all-done flag


def bucket_len(n: int, minimum: int = 32) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def prepare_w4_resident(cfg: DecoderConfig, params, specs, mode: str):
    """Serving residency of W4 weights: ONE copy, split-half packed bytes,
    with the shared-input groups (q|k|v, gate|up) fused into one matrix each
    (the JAX package's ``packed`` mode under the W4 GEMV). A tensor-parallel
    rank packs its own tree (``cfg`` its local config): its q|k|v and
    gate|up are whole groups of its heads and columns, so the fusion stays
    (JAX turns it off under a mesh, where a concat boundary falls
    mid-shard). Sites on the
    group-blocked epilogue (``kernels.qmm.grouped_route``) keep their int8
    codes: that route multiplies unpacked codes, so packed bytes would be
    unpacked at every call. Returns params unchanged unless real-mode W4
    serving applies."""
    if not (mode == "real" and specs and isinstance(params, dict)
            and "layers" in params):
        return params
    from ..kernels.qmm import grouped_route, pack_w4_sites

    lay = params["layers"]
    keep = {n: s for n, s in lay.items()
            if isinstance(s, dict) and "w_q" in s and specs.get("llm." + n)
            and grouped_route(s, specs["llm." + n])}
    packed = pack_w4_sites({n: s for n, s in lay.items() if n not in keep},
                           specs, cfg.in_dims, fuse_groups=True)
    return {**{k: v for k, v in params.items() if k != "layers"},
            "layers": {**packed, **keep}}


def _lengths(seqs) -> list:
    """Prompt lengths of token id sequences (T,) or embeddings (…, T, H)."""
    return [int(s.shape[-2]) if getattr(s, "ndim", 1) >= 2 else len(s)
            for s in seqs]


def _launch_counts() -> list:
    """(counter dict, its values now) of every kernel module."""
    from ..kernels import attn_decode, flash_attn, fwht, qmm

    return [(m.LAUNCHES, dict(m.LAUNCHES))
            for m in (qmm, attn_decode, flash_attn, fwht)]


def _kv_dict(kv) -> Dict:
    """A decode loop's KV buffers as a dict of cache tensors (without
    ``pos``): a (k, v) pair of float buffers, or such a dict already."""
    if isinstance(kv, dict):
        return {n: t for n, t in kv.items()
                if n not in ("pos", "rope_delta", "ntk_alpha")}
    return {"k": kv[0], "v": kv[1]}


class Graphed:
    """``fn()`` on static buffers, replayed. On the card ``fn`` runs once
    eagerly on a side stream (one-time allocations: attention's counters,
    library handles, cached factors) and is then captured in a CUDA graph;
    a call replays it ``times`` times. The kernel wrappers count their
    launches where they run, which in a capture is no launch: the capture's
    counts are taken back and each replay adds them. On the CPU, and under
    a tensor-parallel mesh (``parallel.sharding``: gloo's collectives cannot
    be captured; capturing the step with NCCL is ROADMAP A14d), a call runs
    ``fn`` eagerly ``times`` times."""

    def __init__(self, fn: Callable[[], object], device):
        from ..parallel.sharding import tp_mesh

        self.fn = fn
        self.graph = None
        if torch.device(device).type != "cuda" or tp_mesh() is not None:
            return
        side = torch.cuda.Stream(device=device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream(device).wait_stream(side)
        counts = _launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            fn()
        self.per_call = [(d, {k: d[k] - v for k, v in before.items()})
                         for d, before in counts]
        for d, before in counts:
            d.update(before)

    def __call__(self, times: int = 1):
        if self.graph is None:
            for _ in range(times):
                self.fn()
            return
        for _ in range(times):
            self.graph.replay()
        for d, inc in self.per_call:
            for k, n in inc.items():
                d[k] += n * times


class DecodeLoop:
    """Greedy decode of one batch shape on static buffers (JAX's
    ``_decode_n``). A prefill writes its KV into ``k`` / ``v`` (the
    Generator's buffers of this batch and cache length, shared by its loops),
    then :meth:`run` takes the first token and the prefill's ``pos`` and
    ``rope_delta`` (and a ragged batch's ``start``) into the static buffers
    and steps. Columns ≥ pos of the buffers may hold an earlier request's KV
    (or anything): no step reads them. ``logits`` holds the last step's
    (B, vocab) logits. An int8 / int4 cache's buffers (``kv`` a dict, the
    cache's tensors but ``pos``) are captured with the step: the new rows'
    quantization runs in the graph, with no host copy. Under a
    tensor-parallel mesh the step runs eagerly (:class:`Graphed`)."""

    def __init__(self, gen: "Generator", kv, eos_id: Optional[int],
                 ragged: bool):
        self.gen, self.eos_id = gen, eos_id
        self.kv = _kv_dict(kv)
        self.k, self.v = self.kv["k"], self.kv["v"]
        B, dev = self.k.shape[1], self.k.device
        i32 = dict(dtype=torch.int32, device=dev)
        self.pos = torch.zeros((), **i32)
        self.rope_delta = torch.zeros((B,), **i32)
        self.start = torch.zeros((B,), **i32) if ragged else None
        # a ragged batch's per-row dynamic-NTK alphas (else the Generator's
        # scalar alpha of the loop's key)
        self.alpha = (torch.ones((B,), dtype=torch.float32, device=dev)
                      if ragged and gen.cfg.use_dynamic_ntk else None)
        self.tok = torch.zeros((B, 1), **i32)
        self.out = torch.zeros((B, self.k.shape[2]), **i32)
        self.col = torch.ones((B, 1), dtype=torch.long, device=dev)
        self.done = torch.zeros((B,), dtype=torch.bool, device=dev)
        self.all_done = torch.zeros((), dtype=torch.bool, device=dev)
        self.flag = (torch.zeros((), dtype=torch.bool, pin_memory=True)
                     if dev.type == "cuda" else None)
        self.logits = None
        self.steps = None  # the Graphed step, made at the first run
        self.captured_alpha = None  # the Generator's NTK alpha it baked in

    def _step(self):
        cache = {**self.kv, "pos": self.pos, "rope_delta": self.rope_delta}
        logits, cache = self.gen._forward(self.tok, cache,
                                          attn_start=self.start,
                                          ntk_alpha=self.alpha)
        last = logits[:, -1]
        nxt = last.argmax(dim=-1).to(torch.int32)
        if self.eos_id is not None:
            nxt = torch.where(self.done, torch.full_like(nxt, self.eos_id),
                              nxt)
            self.done |= nxt == self.eos_id
            torch.all(self.done, out=self.all_done)
        self.out.scatter_(1, self.col, nxt[:, None])
        self.col += 1
        self.tok.copy_(nxt[:, None])
        self.pos.copy_(cache["pos"])
        if self.logits is None:
            self.logits = torch.empty_like(last)
        self.logits.copy_(last)

    @torch.no_grad()
    def run(self, first: torch.Tensor, cache: Dict, n: int,
            start: Optional[torch.Tensor] = None,
            on_step: Optional[Callable] = None,
            pos: Optional[int] = None) -> torch.Tensor:
        """(B, n) int32: ``first`` (B, 1) in column 0, then n − 1 greedy
        steps from ``cache`` (the prefill into ``k`` / ``v``). With an eos
        id, rows past their eos hold eos and the loop stops within
        2 · EOS_CHECK_EVERY steps of the step that finished the last row.
        ``on_step`` (no eos id): the graph replays one step at a time and
        ``on_step(logits)`` sees each step's (B, vocab) logits. ``pos``:
        the cache's position where the host knows it; steps that would
        write past the cache's last row are refused before the first."""
        if on_step is not None and self.eos_id is not None:
            raise ValueError("decode: on_step takes a loop without eos id")
        if n > self.out.shape[1]:
            raise ValueError(f"decode: {n} tokens exceed the cache of "
                             f"{self.out.shape[1]} rows")
        if pos is not None and pos + n - 1 > self.out.shape[1]:
            raise ValueError(f"decode: {n} tokens from position {pos} write "
                             f"past the cache of {self.out.shape[1]} rows")
        self.pos.copy_(cache["pos"])
        if self.steps is not None and self.alpha is None and \
                self.captured_alpha != self.gen._ntk_alpha:
            self.steps = None  # the scalar alpha is baked into the graph
        if self.steps is None and n > 1:
            self.captured_alpha = self.gen._ntk_alpha
            # the capture's eager step writes row pos, which the first
            # replay rewrites
            self.steps = Graphed(self._step, self.k.device)
        self.pos.copy_(cache["pos"])
        rope_delta = cache.get("rope_delta")
        if rope_delta is None:
            self.rope_delta.zero_()
        else:
            self.rope_delta.copy_(rope_delta)
        if self.start is not None:
            self.start.copy_(start)
        if self.alpha is not None:
            self.alpha.copy_(cache["ntk_alpha"])
        self.tok.copy_(first)
        self.out.fill_(0 if self.eos_id is None else self.eos_id)
        self.out[:, :1].copy_(first)
        self.col.fill_(1)
        if self.eos_id is not None:
            torch.eq(first[:, 0], self.eos_id, out=self.done)
        self._advance(n - 1, on_step)
        return self.out[:, :n].clone()

    def _advance(self, steps: int, on_step: Optional[Callable] = None):
        if on_step is not None:
            for _ in range(steps):
                self.steps(1)
                on_step(self.logits)
            return
        if self.eos_id is None:
            if steps > 0:
                self.steps(steps)
            return
        pending = None
        while steps > 0:
            k = min(EOS_CHECK_EVERY, steps)
            self.steps(k)
            steps -= k
            if steps <= 0:
                break
            if self.flag is None:  # CPU: the step has run
                if bool(self.all_done):
                    break
                continue
            # the flag only turns true, so the host reads the previous
            # chunk's copy (or a later one) while this chunk runs
            if pending is not None:
                pending.synchronize()
                if bool(self.flag):
                    break
            self.flag.copy_(self.all_done, non_blocking=True)
            pending = torch.cuda.Event()
            pending.record()


class Generator:
    """Prefill / decode for one (cfg, specs, state, mode). Under a
    tensor-parallel mesh (``parallel.sharding.set_mesh`` around its calls)
    ``cfg`` and ``params`` are the rank's local ones and every rank makes
    the same calls: the logits come back whole, so every rank picks the
    same tokens. The KV cache is
    bf16 (or the model's dtype), or with ``kv_quant`` True / 8 int8 and 4
    nibble-packed int4 (``models.llm.init_cache``). With the config's
    dynamic NTK a prefill takes alpha from its true length and the decode
    steps after it reuse that alpha (a ragged batch: one per row)."""

    def __init__(self, cfg: DecoderConfig, params, specs=None, state=None,
                 mode: str = "fp", max_len: int = 512, kv_quant=False):
        self.kv_quant = kv_quant
        self._ntk_alpha = 1.0  # set by a prefill; decode reuses it
        self.cfg = cfg
        self.specs = specs or {}
        self.state = state
        self.mode = mode
        self.max_len = max_len
        self.params = prepare_w4_resident(cfg, params, self.specs, mode)
        self._kv = {}  # (B, max_len) → the decode loops' KV buffers
        self._loops = {}  # (B, max_len, eos_id, ragged) → DecodeLoop

    def _forward(self, x, cache, positions=None, last_index=None,
                 prefill_fresh=False, attn_mask=None, attn_start=None,
                 verify=False, ntk_alpha=None):
        return decoder_forward(self.cfg, self.params, x, specs=self.specs,
                               state=self.state, mode=self.mode, cache=cache,
                               positions=positions, attn_mask=attn_mask,
                               last_index=last_index,
                               prefill_fresh=prefill_fresh,
                               attn_start=attn_start, verify=verify,
                               ntk_alpha=self._ntk_alpha if ntk_alpha is None
                               else ntk_alpha)[:2]

    def ensure_capacity(self, n: int):
        """Grow the KV cache length to hold at least ``n`` positions (sticky,
        as in the JAX Generator; the decode loops of the old length are
        dropped and recaptured at the new one)."""
        if n > self.max_len:
            self.max_len = bucket_len(n)

    def reset_capacity(self, n: int = 32):
        """Shrink ``max_len`` back down (undo sticky growth), so later short
        requests stop paying a long past request's cache length."""
        self.max_len = bucket_len(max(n, 32))

    def _loop(self, B: int, eos_id: Optional[int], ragged: bool
              ) -> DecodeLoop:
        """The decode loop of (B, max_len, eos_id, ragged), made at first
        use; loops and buffers of another max_len are dropped."""
        self._kv = {k: v for k, v in self._kv.items() if k[1] == self.max_len}
        self._loops = {k: v for k, v in self._loops.items()
                       if k[1] == self.max_len}
        key = (B, self.max_len, eos_id, ragged)
        if key not in self._loops:
            kv = self._kv.get((B, self.max_len))
            if kv is None:
                c = self._new_cache(B, self.params["embed"]["w"].device)
                kv = self._kv[(B, self.max_len)] = _kv_dict(c)
            self._loops[key] = DecodeLoop(self, kv, eos_id, ragged)
        return self._loops[key]

    def _new_cache(self, B: int, device) -> Dict:
        return init_cache(self.cfg, B, self.max_len, device=device,
                          quantized=self.kv_quant)

    def _fresh_cache(self, B: int, device, kv=None) -> Dict:
        """A cache at pos 0: new zeroed buffers, or the given buffers (a
        (k, v) pair of (L, B, max_len, KVH, hd), or a dict of a quantized
        cache's tensors), which a prefill overwrites only in its own
        rows."""
        if kv is None:
            return self._new_cache(B, device)
        kv = _kv_dict(kv)
        if kv["k"].shape[1:3] != (B, self.max_len):
            raise ValueError(f"prefill: buffers {tuple(kv['k'].shape)} for "
                             f"batch {B} and cache length {self.max_len}")
        return {**kv, "pos": torch.zeros((), dtype=torch.int32,
                                         device=device)}

    @torch.no_grad()
    def prefill(self, tokens_or_embeds: torch.Tensor, positions=None,
                kv=None) -> Tuple[torch.Tensor, Dict]:
        """Run the (bucket-padded) prefill; returns (last-token logits (B, V),
        cache). ``positions``: optional (B, T) or M-RoPE (3, B, T) ids.
        ``kv``: optional buffers to write into (a decode loop's ``kv``, or a
        (k, v) pair) instead of a new cache."""
        B, T = tokens_or_embeds.shape[:2]
        dev = tokens_or_embeds.device
        if positions is not None:
            positions = torch.as_tensor(positions, device=dev)
            dims = (0, -1) if positions.ndim == 3 else (-1,)
            pmax = positions.amax(dim=dims)
            rope_delta = (pmax.to(torch.int32) + 1 - T).reshape(-1).expand(B)
        else:
            rope_delta = torch.zeros((B,), dtype=torch.int32, device=dev)
        Tb = bucket_len(T)
        self.ensure_capacity(Tb)
        pad = Tb - T
        if pad:
            widths = (0, pad) if tokens_or_embeds.ndim == 2 else (0, 0, 0, pad)
            tokens_or_embeds = torch.nn.functional.pad(tokens_or_embeds, widths)
            if positions is not None:
                edge = positions[..., -1:].expand(*positions.shape[:-1], pad)
                positions = torch.cat([positions, edge], dim=-1)
        if positions is None:
            positions = torch.arange(Tb, device=dev)[None].expand(B, Tb)
        cache = self._fresh_cache(B, dev, kv)
        self._ntk_alpha = ntk_alpha_for(self.cfg, T)
        logits, cache = self._forward(tokens_or_embeds, cache,
                                      positions=positions, last_index=T - 1,
                                      prefill_fresh=True)
        # the true length, not the padded bucket
        cache["pos"] = torch.full((), T, dtype=torch.int32, device=dev)
        cache["rope_delta"] = rope_delta.contiguous()
        return logits[:, 0], cache

    @torch.no_grad()
    def prefill_chunked(self, tokens_or_embeds: torch.Tensor,
                        chunk: int = 2048, max_new_tokens: int = 128,
                        kv=None) -> Tuple[torch.Tensor, Dict]:
        """Prefill a long prompt in pieces of ``chunk`` rows (the last may be
        shorter) against the KV cache (JAX's ``prefill_chunked``): each
        piece writes its rows at the cache position and attends to the rows
        written so far plus itself through the causal-with-offset mask on
        the einsum route (the engine's chunk-against-cache forward; no
        flash, no fresh prefill). With the cache's position on the card
        the mask spans the whole cache, as JAX's does (V's unread columns
        zeroed); on the host a piece reads the written prefix. Attention
        holds O(chunk · S) f32 scores, not O(T²), yet on the card the
        one-piece :meth:`prefill` (flash) is the faster long-prompt route
        and needs less memory: this one is there for JAX's chunking. Each
        piece computes logits for its last row only (``last_index``: the
        head at one row, ``int8_gemv`` for an int8 head). Dynamic NTK takes
        alpha from the whole prompt's length, for every piece and the
        decode steps after it. Returns (last-token logits (B, V), cache) as
        :meth:`prefill`.

        The cache is grown to ``T + max_new_tokens`` rows first and made at
        that length (``kv``: a decode loop's buffers of that length, as in
        :meth:`prefill`; columns past a piece's end may hold anything, no
        row reads them). A decode longer than that reserve is refused, not
        clamped as JAX's writes are: :meth:`generate_chunked` and
        ``DecodeLoop.run(..., pos=T)`` raise before their first step, and a
        step's write at a host position past the cache raises."""
        B, T = tokens_or_embeds.shape[:2]
        dev = tokens_or_embeds.device
        self.ensure_capacity(T + max_new_tokens)
        self._ntk_alpha = ntk_alpha_for(self.cfg, T)
        cache = self._fresh_cache(B, dev, kv)
        logits = None
        for c0 in range(0, T, chunk):
            piece = tokens_or_embeds[:, c0:c0 + chunk]
            logits, cache = self._forward(piece, cache,
                                          last_index=piece.shape[1] - 1)
        return logits[:, -1], cache

    @torch.no_grad()
    def generate_chunked(self, tokens: torch.Tensor, chunk: int = 2048,
                         max_new_tokens: int = 32,
                         eos_id: Optional[int] = None) -> torch.Tensor:
        """Greedy generation after a chunked prefill
        (:meth:`prefill_chunked`): the decode loop of
        :meth:`generate_on_device` (a CUDA graph on the card) continues
        from the chunked cache, written into its own buffers. Returns (B,
        max_new_tokens) int32."""
        T = tokens.shape[1]
        # the loop's buffers at the final length: grown before they are made
        self.ensure_capacity(T + max_new_tokens)
        self._ntk_alpha = ntk_alpha_for(self.cfg, T)
        loop = self._loop(tokens.shape[0], eos_id, False)
        last, cache = self.prefill_chunked(tokens, chunk, max_new_tokens,
                                           kv=loop.kv)
        tok = last.argmax(dim=-1).to(torch.int32)[:, None]
        return loop.run(tok, cache, max_new_tokens, pos=T)

    @torch.no_grad()
    def generate_on_device(self, tokens: torch.Tensor,
                           max_new_tokens: int = 32, positions=None,
                           eos_id: Optional[int] = None,
                           on_first_token: Optional[Callable] = None,
                           on_step: Optional[Callable] = None
                           ) -> torch.Tensor:
        """Greedy generation with the decode loop on the device
        (:class:`DecodeLoop`): (B, max_new_tokens) int32. With ``eos_id``,
        rows past their eos are frozen to eos and the loop exits soon after
        every row is done (the remaining columns hold eos).
        ``on_first_token`` is called with the (B, 1) first tokens as soon as
        they are issued (to stream them, or to take the time to first
        token). ``on_step`` (no ``eos_id``) is called with each token's
        (B, vocab) logits, the prefill's last row first
        (:meth:`DecodeLoop.run`)."""
        # the loop's buffers hold the prefill's bucket too (``prefill``
        # would grow the cache past them)
        T = tokens.shape[1]
        self.ensure_capacity(max(bucket_len(T), T + max_new_tokens))
        self._ntk_alpha = ntk_alpha_for(self.cfg, T)
        loop = self._loop(tokens.shape[0], eos_id, False)
        last_logits, cache = self.prefill(tokens, positions=positions,
                                          kv=loop.kv)
        tok = last_logits.argmax(dim=-1).to(torch.int32)[:, None]
        if on_first_token is not None:
            on_first_token(tok)
        if on_step is not None:
            on_step(last_logits)
        return loop.run(tok, cache, max_new_tokens, on_step=on_step)

    def _decode_loop(self, tok, cache, max_new_tokens: int,
                     eos_id: Optional[int], attn_start=None,
                     with_logits: bool = False):
        """The eager reference of :class:`DecodeLoop`: greedy steps after
        the first token ``tok`` (B, 1), one forward a step, with a host read
        of the done rows each step. Returns (B, max_new_tokens) int32 with
        ``tok`` in column 0 (rows past their eos freeze to eos and the loop
        exits once every row is done), and with ``with_logits`` also the
        last step's (B, vocab) logits."""
        B = tok.shape[0]
        out = torch.full((B, max_new_tokens),
                         eos_id if eos_id is not None else 0,
                         dtype=torch.int32, device=tok.device)
        out[:, :1] = tok
        done = (tok[:, 0] == eos_id) if eos_id is not None else None
        logits = None
        for i in range(1, max_new_tokens):
            if done is not None and bool(done.all()):
                break
            logits, cache = self._forward(tok, cache, attn_start=attn_start,
                                          ntk_alpha=cache.get("ntk_alpha"))
            nxt = logits[:, -1].argmax(dim=-1).to(torch.int32)
            if done is not None:
                nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
                done = done | (nxt == eos_id)
            out[:, i] = nxt
            tok = nxt[:, None]
        if with_logits:
            return out, None if logits is None else logits[:, -1]
        return out

    @torch.no_grad()
    def prefill_batch(self, seqs, positions=None, kv=None):
        """Prefill of ragged prompts in one batch: each is LEFT-padded to the
        shared bucket Tb, and the prefill mask (col ≤ row) & (col ≥ start_i)
        keeps the pad columns out of attention. Returns (last-token logits
        (B, V), cache, starts (B,) int32 = Tb − len_i).

        ``seqs``: token id sequences (T_i,) or embeddings (T_i, hidden) /
        (1, T_i, hidden). ``positions``: optional per-row position ids, each
        (T_i,), M-RoPE (3, T_i) or (3, 1, T_i), or None for arange(T_i).
        Each row's ids are shifted by its start column, the left pad is
        edge-filled (masked anyway), and the cache's per-row ``rope_delta``
        makes decode continue at that row's max(position) + 1. ``kv``: as
        in :meth:`prefill`."""
        B = len(seqs)
        lens = _lengths(seqs)
        embeds_mode = getattr(seqs[0], "ndim", 1) >= 2
        Tb = bucket_len(max(lens))
        self.ensure_capacity(Tb)
        starts = np.asarray([Tb - n for n in lens], np.int32)
        dev = self.params["embed"]["w"].device
        if embeds_mode:
            Hd = seqs[0].shape[-1]
            x = torch.zeros((B, Tb, Hd), dtype=self.cfg.dtype, device=dev)
            for i, s in enumerate(seqs):
                x[i, starts[i]:] = torch.as_tensor(s).reshape(lens[i], Hd).to(
                    device=dev, dtype=self.cfg.dtype)
        else:
            x = torch.zeros((B, Tb), dtype=torch.long, device=dev)
            for i, s in enumerate(seqs):
                x[i, starts[i]:] = torch.as_tensor(s, device=dev).long()
        pos_b = rope_delta = None
        if positions is not None:
            pos_b = np.zeros((3, B, Tb), np.int64)
            rope_delta = np.zeros((B,), np.int32)
            for i, p in enumerate(positions):
                p = (np.arange(lens[i]) if p is None else
                     np.asarray(p.cpu() if torch.is_tensor(p) else p))
                if p.ndim == 1:
                    p = np.broadcast_to(p[None], (3, p.shape[-1]))
                elif p.ndim == 3:
                    p = p[:, 0]  # (3, 1, T) → (3, T)
                s = int(starts[i])
                pos_b[:, i, s:] = p + s
                pos_b[:, i, :s] = p[:, :1] + s  # edge fill (masked columns)
                rope_delta[i] = int(p.max()) + 1 + s - Tb
            pos_b = torch.from_numpy(pos_b).to(dev)
        r = torch.arange(Tb, device=dev)
        starts_t = torch.from_numpy(starts).to(dev)
        mask = ((r[None, :, None] >= r[None, None, :])
                & (r[None, None, :] >= starts_t[:, None, None]))[:, None]
        cache = self._fresh_cache(B, dev, kv)
        # dynamic NTK: each row's alpha from its own length, as (B,) data
        # (JAX's); the scalar of the longest row for the loop's key
        self._ntk_alpha = ntk_alpha_for(self.cfg, max(lens))
        alpha = 1.0
        if self.cfg.use_dynamic_ntk:
            alpha = torch.tensor([ntk_alpha_for(self.cfg, n) for n in lens],
                                 dtype=torch.float32, device=dev)
        logits, cache = self._forward(x, cache, positions=pos_b,
                                      last_index=Tb - 1, prefill_fresh=True,
                                      attn_mask=mask, ntk_alpha=alpha)
        if self.cfg.use_dynamic_ntk:
            cache["ntk_alpha"] = alpha
        if rope_delta is not None:
            cache["rope_delta"] = torch.from_numpy(rope_delta).to(dev)
        return logits[:, 0], cache, starts_t

    @torch.no_grad()
    def generate_batch(self, seqs, max_new_tokens: int = 32,
                       eos_id: Optional[int] = None, positions=None):
        """Ragged batched greedy generation: prompts of different lengths in
        one batch (see :meth:`prefill_batch`). Pad columns stay masked out of
        decode through ``attn_start``, and RoPE is relative, so each row
        decodes as it would alone. The decode loop is the one of
        :meth:`generate_on_device` (eos freeze, early exit). Returns one
        list of generated token ids per prompt, cut before its first eos.
        With the config's dynamic NTK each row decodes at the alpha of its
        own length (JAX's per-row alpha)."""
        self.ensure_capacity(bucket_len(max(_lengths(seqs))) + max_new_tokens)
        self._ntk_alpha = ntk_alpha_for(self.cfg, max(_lengths(seqs)))
        loop = self._loop(len(seqs), eos_id, True)
        logits, cache, starts = self.prefill_batch(seqs, positions=positions,
                                                   kv=loop.kv)
        tok = logits.argmax(dim=-1).to(torch.int32)[:, None]
        out = loop.run(tok, cache, max_new_tokens, start=starts).tolist()
        if eos_id is not None:
            out = [o[:o.index(eos_id)] if eos_id in o else o for o in out]
        return out

    @torch.no_grad()
    def generate(self, tokens: torch.Tensor, max_new_tokens: int = 32,
                 eos_id: Optional[int] = None, positions=None) -> torch.Tensor:
        """Greedy decode, host-driven: stops once every row emitted eos.
        Returns (B, ≤ max_new_tokens) int32."""
        self.ensure_capacity(tokens.shape[1] + max_new_tokens)
        last_logits, cache = self.prefill(tokens, positions=positions)
        tok = last_logits.argmax(dim=-1).to(torch.int32)[:, None]
        out = [tok]
        for _ in range(max_new_tokens - 1):
            logits, cache = self._forward(tok, cache)
            tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
            out.append(tok)
            if eos_id is not None and bool((tok == eos_id).all()):
                break
        return torch.cat(out, dim=1)


# ---------------------------------------------------------------------------
# measurement (the JAX module's helpers: best-of-N wall spans, inputs that
# differ between iterations)
# ---------------------------------------------------------------------------


def _force(x) -> float:
    """Waits for ``x``'s work by reading one scalar of its first tensor (a
    read of a CUDA tensor waits for the stream that wrote it)."""
    while not isinstance(x, torch.Tensor):
        x = next(iter(x.values() if isinstance(x, dict) else x))
    return float(x.reshape(-1)[0])


def measure_ttft(gen: Generator, tokens: torch.Tensor, iters: int = 5
                 ) -> float:
    """Best wall-clock prefill latency in seconds (after a warm-up call),
    each iteration on other tokens."""
    logits, _ = gen.prefill(tokens)
    _force(logits)
    times = []
    for i in range(iters):
        toks_i = (tokens + i + 1) % 100 + 1
        t0 = time.perf_counter()
        logits, _ = gen.prefill(toks_i)
        _force(logits)
        times.append(time.perf_counter() - t0)
    return min(times)


@torch.no_grad()
def measure_ttft_chained(gen: Generator, tokens: torch.Tensor, chain: int = 8,
                         iters: int = 3, stats: Optional[dict] = None
                         ) -> float:
    """Model-latency prefill time: ``chain`` full prefills (KV-cache write
    included) in one dispatch, divided by chain. Each prefill feeds the
    next its first token (``nxt % 1000 + 1`` of row 0's greedy token), so
    none can be skipped. On the card one prefill + argmax + feed is a CUDA
    graph (:class:`Graphed`) replayed ``chain`` times; best of ``iters``
    chains, each from other tokens. ``stats`` (optional) receives
    "setup_s": the wall seconds of the first chain with its eager run and
    capture (and a kernel build, in a fresh process)."""
    B, T = tokens.shape
    toks = tokens.to(torch.long).clone()
    acc = torch.zeros((B,), dtype=torch.int32, device=toks.device)
    cache = gen._new_cache(B, toks.device)

    def body():
        logits, _ = gen._forward(toks, cache, prefill_fresh=True,
                                 last_index=T - 1)
        nxt = logits[:, -1].argmax(dim=-1).to(torch.int32)
        toks[:, 0] = nxt[0] % 1000 + 1
        acc.add_(nxt)

    t0 = time.perf_counter()
    run = Graphed(body, toks.device)
    run(chain)
    _force(acc)
    if stats is not None:
        stats["setup_s"] = time.perf_counter() - t0
    best = float("inf")
    for i in range(iters):
        toks.copy_((tokens + i + 1) % 1000 + 1)
        t0 = time.perf_counter()
        run(chain)
        _force(acc)
        best = min(best, time.perf_counter() - t0)
    return best / chain


def measure_request(gen: Generator, tokens: torch.Tensor,
                    gen_tokens: int = 128, iters: int = 3) -> float:
    """Measured end-to-end request latency: one wall-clock span over
    prefill + ``gen_tokens`` greedy tokens (the decode loop on the device),
    best of ``iters`` after a warm-up request, each on other tokens."""
    _force(gen.generate_on_device(tokens, max_new_tokens=gen_tokens))
    best = float("inf")
    for i in range(iters):
        toks_i = (tokens + i + 1) % 100 + 1
        t0 = time.perf_counter()
        _force(gen.generate_on_device(toks_i, max_new_tokens=gen_tokens))
        best = min(best, time.perf_counter() - t0)
    return best


@torch.no_grad()
def measure_decode_tps(gen: Generator, tokens: torch.Tensor,
                       n_tokens: int = 64, on_device: bool = True) -> float:
    """Decode throughput (tokens/s) after one prefill. ``on_device``: the
    decode loop (:class:`DecodeLoop`, n_tokens steps in one run; best of 3
    after a warm-up run, each from another first token); else the
    host-driven loop, one eager forward a token. ``tokens``: (B, T) ids or
    (B, T, hidden) embeddings."""
    B, T = tokens.shape[:2]
    gen.ensure_capacity(max(bucket_len(T), T + n_tokens))
    if on_device:
        loop = gen._loop(B, None, False)
        last_logits, cache = gen.prefill(tokens, kv=loop.kv)
        tok = last_logits.argmax(dim=-1).to(torch.int32)[:, None]
        _force(loop.run(tok, cache, n_tokens + 1))
        best = float("inf")
        for i in range(3):
            t0 = time.perf_counter()
            _force(loop.run((tok + 1 + i) % 100, cache, n_tokens + 1))
            best = min(best, time.perf_counter() - t0)
        return n_tokens * B / best
    last_logits, cache = gen.prefill(tokens)
    tok = last_logits.argmax(dim=-1).to(torch.int32)[:, None]
    _force(gen._forward(tok, cache)[0])  # warm-up
    t0 = time.perf_counter()
    c = cache
    for _ in range(n_tokens):
        logits, c = gen._forward(tok, c)
        tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
    _force(tok)
    return n_tokens * B / (time.perf_counter() - t0)
