"""Continuous-batching serving engine: a slot pool over one KV cache, with
requests admitted on the fly (counterpart of ``mquant_tpu/serve/engine.py``).

The design is the JAX engine's, in PyTorch's idiom:

  * The KV cache is one (L, B, S, KVH, hd) tensor pair whose ``pos`` is a
    (B,) tensor: every row is an independent request at its own write
    offset (``models.llm``'s per-row scatter and mask; on the card the
    decode step's ``attn_decode`` takes the (B,) ``pos`` as is).
    Admission writes a request's rows into the pool's own storage in place;
    retirement frees the slot id.
  * Admission: same-bucket prompts prefill as one (k, Tb) batch, k in
    1/2/4/8, capped by ``admit_batch_tokens``, each row with its own true
    length (per-row ``last_index``). A prompt that matches a registered
    prefix, or one longer than ``admit_chunk``, is admitted in pieces
    against a scratch row, one piece a tick.
  * Decode: ``steps_per_block`` greedy or sampled steps over the whole pool
    between two host visits. Where JAX compiles one program a key, the port
    captures one decode step of the pool on static buffers in a CUDA graph
    (``serve.generate.Graphed``) a (steps, cache bucket) key and replays it
    once a step; the host writes the block's inputs with two copies and
    reads its (B, n) tokens and logprobs with one. On the CPU the step runs
    eagerly.
  * Finished rows freeze: they emit 0 and their ``pos`` does not advance.
  * The KV buffer grows in 256-row buckets up to ``max_len`` (the decode
    reads the whole buffer); a new buffer drops the graphs captured on the
    old one, which are captured again at the new bucket.
  * ``sample_top_k > 0`` adds the sampling epilogue (``serve.sampling``):
    per-row temperature / top-p, presence and frequency penalties over the
    pool's (B, V) token counts on the device, noise keyed by each request's
    seed and emitted index. ``spec_k > 0`` runs batched self-speculative
    rounds instead (``serve.speculative``): the verify forward gives each
    window row the decode step's logits (``decoder_forward``'s
    ``verify``), so the tokens and logprobs are those of ``spec_k = 0`` on
    a pool of the same shape; only the number of forwards changes.

  * ``kv_quant`` True / 8 or 4 keeps the pool (and the admission and
    prefix rows) as int8 or int4 KV (``models.llm.init_cache``): every row
    copy moves the scales and zero points with the codes, and a poisoned
    tail, scales included, reaches no row (V's unread columns are zeroed
    after the dequantization). ``ntk_alpha`` scales RoPE for every row;
    with the config's dynamic NTK each admission takes the alpha of its own
    prompt length, held per slot as (slots,) data of the decode blocks.

JAX's in-block W4 re-storage
(``_s4``, ``_w4pack``, ``layers_packed``) is TPU storage: the engine serves
the W4 weights as the ``Generator`` holds them (``prepare_w4_resident``,
which leaves packed weights as they are, so a runner's copy is shared).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models.llm import (DecoderConfig, decoder_forward, init_cache,
                          ntk_alpha_for)
from .generate import Graphed, bucket_len, prepare_w4_resident
from .sampling import host_sample_first, sample_tokens, top_k
from .speculative import ngram_propose


@dataclasses.dataclass
class _Request:
    rid: int
    tokens_or_embeds: Any  # (T,) ids (numpy) or (T, H) embeds (numpy/tensor)
    max_new_tokens: int
    positions: Any = None  # optional M-RoPE (3, T) position ids
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    slot: int = -1
    next_tok: int = 0  # next token to feed (the last emitted one)
    draft_ids: Any = None  # embeds prompts: known token ids for drafting
    temperature: float = 0.0  # 0 = greedy; > 0 samples (needs sample_top_k)
    top_p: float = 1.0
    seed: int = 0  # per-request sampling seed (schedule-independent replay)
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    lps: List[float] = dataclasses.field(default_factory=list)  # logprobs


@dataclasses.dataclass
class _Admitting:
    """A prompt mid-admission: its scratch cache row and prefill cursor."""
    req: _Request
    slot: int
    row: Dict  # B = 1 cache at the pool's length, pos = tokens so far
    cursor: int  # next prompt index to feed


def _kv_names(cache: Dict) -> List[str]:
    """The cache's per-layer tensors: "k" / "v" and, for an int8 / int4
    cache, their scales and zero points (not ``pos`` / ``rope_delta``)."""
    return [nm for nm in cache if nm not in ("pos", "rope_delta")]


def _logprob(last: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """The logprob of ``tok`` (B,) under the raw model distribution of the
    (B, V) logits ``last``, in f32."""
    l32 = last.float()
    return l32.gather(-1, tok[:, None].long())[:, 0] - torch.logsumexp(
        l32, dim=-1)


class _Block:
    """The static buffers of one decode (or speculative) block over the
    pool, and its step captured as a CUDA graph on the card. Host inputs go
    in through ``ints`` (B, 4) int64 (token, active, seed, count or budget)
    and ``floats`` (B, 4) f32 (temperature, top-p, presence, frequency);
    outputs come back through ``buf`` (2, B, n) int32: tokens, and logprobs
    as f32 bit patterns; ``logits`` holds the last step's (B, V) logits.
    Built with every row inactive, so the eager step the capture needs
    writes only cache columns ≥ pos and the outputs. Under a
    tensor-parallel mesh the step runs eagerly (``generate.Graphed``)."""

    def __init__(self, eng: "ServingEngine", width: int, spec: bool):
        B, dev = eng.slots, eng.device
        self.eng, self.spec = eng, spec
        self.ints = torch.zeros((B, 4), dtype=torch.int64, device=dev)
        self.floats = torch.zeros((B, 4), dtype=torch.float32, device=dev)
        self.buf = torch.zeros((2, B, width), dtype=torch.int32, device=dev)
        self.col = torch.zeros((B, 1), dtype=torch.long, device=dev)
        self.step_i = torch.zeros((), dtype=torch.int32, device=dev)
        self.cnt = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.done = torch.zeros((B,), dtype=torch.bool, device=dev)
        self.logits = None
        self.graph = Graphed(self._round if spec else self._step, dev)

    @property
    def tok(self):
        return self.ints[:, 0:1]

    def load(self, ints: np.ndarray, floats: np.ndarray):
        self.ints.copy_(torch.from_numpy(ints))
        self.floats.copy_(torch.from_numpy(floats))
        self.col.zero_()
        self.step_i.zero_()
        self.cnt.zero_()
        torch.eq(self.ints[:, 1], 0, out=self.done)

    def read(self):
        """(tokens (B, n), logprobs (B, n), per-row emitted count (B,) or
        None) on the host, in one copy."""
        if not self.spec:
            a = self.buf.cpu().numpy()
            return a[0], a[1].view(np.float32), None
        a = torch.cat([self.buf.reshape(-1), self.cnt]).cpu().numpy()
        cnt = a[self.buf.numel():]
        a = a[:self.buf.numel()].reshape(self.buf.shape)
        return a[0], a[1].view(np.float32), cnt

    def _step(self):
        eng, cache = self.eng, self.eng.cache
        active = self.ints[:, 1] != 0
        logits, new = eng._forward(self.tok, cache)
        last = logits[:, -1]
        if eng.sample_top_k:
            tc = eng.tok_counts
            temp, top_p, pres, freq = self.floats.unbind(1)
            # penalties over prompt + emitted counts shape the choice
            step_logits = last - pres[:, None] * (tc > 0) - freq[:, None] * tc
            nxt = sample_tokens(step_logits, temp, top_p, eng.sample_top_k,
                                self.ints[:, 2],
                                self.ints[:, 3].to(torch.int32) + self.step_i)
            tc.scatter_add_(1, nxt[:, None].long(),
                            active[:, None].to(torch.int32))
        else:
            nxt = last.argmax(dim=-1).to(torch.int32)
        nxt = torch.where(active, nxt, torch.zeros_like(nxt))
        lp = _logprob(last, nxt)
        cache["pos"].copy_(torch.where(active, new["pos"], cache["pos"]))
        if self.logits is None:
            self.logits = torch.empty_like(last)
        self.logits.copy_(last)
        self.buf[0].scatter_(1, self.col, nxt[:, None])
        self.buf[1].view(torch.float32).scatter_(1, self.col, lp[:, None])
        self.col += 1
        self.step_i += 1
        self.tok.copy_(nxt[:, None])

    def _round(self):
        """One batched speculative round: per-row n-gram draft, one (B, k+1)
        verify forward (``verify``: window row j gets the decode step's
        logits at pos + j), per-row acceptance m ∈ [0, k+1] (0 for done
        rows) and ``pos`` rolled back to pos + m: a round emits the greedy
        step's tokens and logprobs."""
        eng, cache, k = self.eng, self.eng.cache, self.eng.spec_k
        budget = self.ints[:, 3].to(torch.int32)
        draft = ngram_propose(eng.hist, eng.hist_len, k)  # (B, k)
        window = torch.cat([self.tok, draft.long()], dim=1)  # (B, k+1)
        pos0 = cache["pos"].clone()
        logits, _ = eng._forward(window, cache, verify=True)
        g = logits.argmax(dim=-1).to(torch.int32)  # (B, k+1)
        agree = torch.cumprod((draft == g[:, :-1]).to(torch.int32), dim=1)
        m = 1 + agree.sum(dim=1, dtype=torch.int32)
        ar = torch.arange(k + 1, device=g.device)[None]
        if eng.eos_id is not None:
            is_eos = (g == eng.eos_id) & (ar < m[:, None])
            first = torch.where(is_eos, ar, k + 1).amin(dim=1)
            m = torch.minimum(m, (first + 1).to(torch.int32))
            done_new = is_eos.any(dim=1)
        else:
            done_new = torch.zeros_like(self.done)
        m = torch.minimum(m, budget - self.cnt)
        m = torch.where(self.done, torch.zeros_like(m), m)
        self.done |= done_new | (self.cnt + m >= budget)
        # each row's logsumexp over its own (B, V) logits, as the step's:
        # a reduction over (B, k+1) rows may split the vocabulary otherwise
        glp = torch.stack([_logprob(logits[:, j], g[:, j])
                           for j in range(k + 1)], dim=1)

        def put(buf, vals, at):  # JAX's clamped per-row dynamic_update_slice
            at = at.to(torch.long).clamp(0, buf.shape[1] - (k + 1))
            buf.scatter_(1, at[:, None] + ar, vals)

        put(self.buf[0], g, self.cnt)
        put(self.buf[1].view(torch.float32), glp, self.cnt)
        put(eng.hist, g, eng.hist_len)
        eng.hist_len += m
        self.cnt += m
        cache["pos"].copy_(pos0 + m)
        nxt = g.gather(1, (m - 1).clamp(0, k)[:, None].long())
        self.tok.copy_(torch.where(m[:, None] > 0, nxt, self.tok))


class ServingEngine:
    """Slot-based continuous-batching server over one decoder.

    >>> eng = ServingEngine(cfg, params, slots=4, max_len=256)
    >>> ra = eng.submit(prompt_a, max_new_tokens=32)
    >>> rb = eng.submit(prompt_b, max_new_tokens=8)
    >>> outs = eng.run()          # {rid: [tok, ...]}, continuous batching

    Tensor parallel (SPMD): every rank of the mesh builds the engine on its
    local config and params (``parallel.sharding``) and, under
    ``set_mesh``, makes the same calls in the same order (submissions,
    prefixes, ticks). The logits come back whole on every rank and the
    sampling noise is keyed by each request's seed, so every rank admits,
    samples and retires alike (``serve.server`` keeps its ranks in step).
    """

    def __init__(self, cfg: DecoderConfig, params, specs=None, state=None,
                 mode: str = "fp", slots: int = 4, max_len: int = 512,
                 kv_quant: bool = False, eos_id: Optional[int] = None,
                 steps_per_block: int = 8, ntk_alpha: float = 1.0,
                 admit_chunk: int = 0, spec_k: int = 0,
                 sample_top_k: int = 0, seed: int = 0,
                 admit_batch_tokens: int = 4096):
        if sample_top_k and spec_k:
            raise ValueError("sampling and speculative decoding are mutually "
                             "exclusive")
        self.cfg = cfg
        self.specs = specs or {}
        self.state = state
        self.mode = mode
        self.kv_quant = kv_quant
        self.ntk_alpha = float(ntk_alpha)
        self._dyn = bool(cfg.use_dynamic_ntk)
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.steps_per_block = steps_per_block
        self.admit_batch_tokens = admit_batch_tokens
        self.admit_chunk = admit_chunk
        self.spec_k = spec_k
        self.sample_top_k = sample_top_k
        self.seed = seed
        # packed W4 weights pass through: a runner's copy is shared
        self.params = prepare_w4_resident(cfg, params, self.specs, mode)
        self.device = self.params["embed"]["w"].device
        self._queue: deque[_Request] = deque()
        self._active: List[Optional[_Request]] = [None] * slots
        self._admitting: Optional[_Admitting] = None
        # registered shared prefixes: (ids tuple, cache row with pos = len),
        # longest first
        self._prefixes: List[Any] = []
        self.prefix_hits = 0
        self._next_rid = 0
        self._requests: Dict[int, _Request] = {}
        # admissions dispatched, by (kind, bucket, ...) key
        self.admissions: Dict[Any, int] = {}
        self._blocks: Dict[Any, _Block] = {}  # (kind, n, S) → its graph
        dev = self.device
        self.cache = self._rows(slots, self._cache_bucket(256))
        # per-slot dynamic-NTK alpha, (slots,) data of the decode blocks
        self.alphas = torch.full((slots,), self.ntk_alpha,
                                 dtype=torch.float32, device=dev)
        self.cache["pos"] = torch.zeros((slots,), dtype=torch.int32,
                                        device=dev)
        self.cache["rope_delta"] = torch.zeros((slots,), dtype=torch.int32,
                                               device=dev)
        if spec_k:
            self.hist = torch.zeros((slots, max_len + spec_k + 1),
                                    dtype=torch.int32, device=dev)
            self.hist_len = torch.zeros((slots,), dtype=torch.int32,
                                        device=dev)
        if sample_top_k:
            # per-slot occurrence counts (prompt + emitted) for penalties
            self.tok_counts = torch.zeros((slots, cfg.vocab),
                                          dtype=torch.int32, device=dev)
        self.spec_emitted = 0
        self.spec_row_rounds = 0

    def _forward(self, x, cache, positions=None, last_index=None,
                 prefill_fresh=False, verify=False, ntk_alpha=None):
        """The decoder over ``cache``; ``ntk_alpha`` None: the pool's
        (per-slot alphas with dynamic NTK, else the engine's alpha)."""
        if ntk_alpha is None:
            ntk_alpha = self.alphas if self._dyn else self.ntk_alpha
        return decoder_forward(self.cfg, self.params, x, specs=self.specs,
                               state=self.state, mode=self.mode, cache=cache,
                               positions=positions, last_index=last_index,
                               prefill_fresh=prefill_fresh, verify=verify,
                               ntk_alpha=ntk_alpha)[:2]

    def _rows(self, k: int, S: int) -> Dict:
        """A fresh cache of k rows of length S in the pool's storage."""
        return init_cache(self.cfg, k, S, device=self.device,
                          quantized=self.kv_quant)

    def _alpha_for(self, seq_len: int) -> float:
        """The NTK alpha of a prompt: its own with dynamic NTK (the
        Qwen-VL rule), else the engine's."""
        if not self._dyn:
            return self.ntk_alpha
        return ntk_alpha_for(self.cfg, seq_len)

    # -- public API ---------------------------------------------------------

    def submit(self, tokens_or_embeds, max_new_tokens: int = 32,
               positions=None, draft_ids=None, temperature: float = 0.0,
               top_p: float = 1.0, seed: Optional[int] = None,
               presence_penalty: float = 0.0,
               frequency_penalty: float = 0.0) -> int:
        """Queue a request. ``tokens_or_embeds``: (T,) int ids or (T, H)
        spliced embeds (numpy, or a tensor, which may stay on the card).
        ``positions``: optional (T,), M-RoPE (3, T) or (3, 1, T) ids;
        decode continues at max(position) + 1. ``draft_ids``: the token ids
        of an embeds prompt (speculation's history, prefix matching,
        penalties). Returns a request id."""
        arr = (tokens_or_embeds if isinstance(tokens_or_embeds, torch.Tensor)
               else np.asarray(tokens_or_embeds))
        if arr.ndim not in (1, 2):
            raise ValueError(f"prompt of shape {tuple(arr.shape)}")
        T = arr.shape[0]
        # chunked admission writes bounded pieces; whole-prompt admission
        # the padded bucket; speculation overhangs by spec_k rows
        need = (T + max_new_tokens if self.admit_chunk
                else max(T + max_new_tokens, bucket_len(T, 16)))
        need += self.spec_k
        if need > self.max_len:
            raise ValueError(f"prompt {T} + decode {max_new_tokens} exceeds "
                             f"engine max_len {self.max_len}")
        self._grow(need)
        if positions is not None:
            positions = np.asarray(positions)
            if positions.ndim == 1:
                positions = np.broadcast_to(positions[None], (3, T))
            elif positions.ndim == 3:
                positions = positions[:, 0]
            if positions.shape != (3, T):
                raise ValueError(f"positions of shape {positions.shape}")
        if ((temperature > 0 or presence_penalty or frequency_penalty)
                and not self.sample_top_k):
            raise ValueError("sampling/penalties need "
                             "ServingEngine(sample_top_k=...)")
        # noise is keyed by (request seed, emitted index) only; the default
        # seed derives from (engine seed, rid)
        rseed = (int(seed) if seed is not None
                 else (self.seed * 1000003 + self._next_rid * 7919)
                 & 0x7FFFFFFF)
        r = _Request(self._next_rid, arr, max_new_tokens, positions=positions,
                     draft_ids=None if draft_ids is None
                     else np.asarray(draft_ids, np.int32).reshape(-1),
                     temperature=float(temperature), top_p=float(top_p),
                     seed=rseed, presence_penalty=float(presence_penalty),
                     frequency_penalty=float(frequency_penalty))
        self._next_rid += 1
        self._queue.append(r)
        self._requests[r.rid] = r
        return r.rid

    @torch.no_grad()
    def warmup(self, prompt_lens=(16, 64, 256), embeds: bool = False,
               with_positions: bool = False) -> None:
        """Run each admission size once on scratch rows (the kernels' build,
        library handles) and capture the decode block at the bucket these
        prompts grow the pool to; the pool's rows below each ``pos``, the
        positions and the requests are untouched."""
        H = self.cfg.hidden
        for T in prompt_lens:
            Tb = bucket_len(int(T), minimum=16)
            if Tb + self.spec_k > self.max_len:
                continue
            self._grow(Tb + self.spec_k)
            max_k = max(1, self.admit_batch_tokens // Tb)
            cap = min(8, 1 << (max_k.bit_length() - 1))
            k = 1
            # batched sizes this pool can dispatch: k/2 < slots
            while k <= cap and (k == 1 or k // 2 < self.slots):
                x = (torch.zeros((k, Tb, H), device=self.device) if embeds
                     else torch.zeros((k, Tb), dtype=torch.long,
                                      device=self.device))
                pos = (torch.zeros((3, k, Tb), dtype=torch.long,
                                   device=self.device)
                       if with_positions else None)
                rows = self._rows(k, Tb)
                self._forward(x, rows, positions=pos, prefill_fresh=True,
                              last_index=Tb - 1,
                              ntk_alpha=self._alpha_for(Tb))
                k *= 2
        self._block(self.spec_k > 0)

    def cancel(self, rid: int) -> bool:
        """Abort a request wherever it is: queued (dropped), mid-admission
        (scratch row abandoned) or active (its slot frees at the next
        retirement sweep). False for unknown or finished ids."""
        r = self._requests.get(rid)
        if r is None or r.done:
            return False
        if r in self._queue:
            self._queue.remove(r)
        elif self._admitting is not None and self._admitting.req is r:
            self._admitting = None
        r.done = True
        return True

    def release(self, rid: int) -> None:
        """Drop a finished request's bookkeeping (prompt, tokens,
        logprobs); long-lived engines call this after reading results."""
        self._requests.pop(rid, None)

    def logprobs_of(self, rid: int) -> List[float]:
        """Per-emitted-token logprobs under the model distribution, parallel
        to the request's output tokens."""
        return list(self._requests[rid].lps)

    def partial_output(self, rid: int) -> List[int]:
        """Tokens emitted so far (eos never appears, so snapshots are
        prefixes of the final output)."""
        return list(self._requests[rid].out)

    def _cache_bucket(self, n: int, step: int = 256) -> int:
        return max(16, min(self.max_len, -(-int(n) // step) * step))

    def _cache_S(self) -> int:
        return int(self.cache["k"].shape[2])

    def _grow(self, need: int) -> None:
        """Grow the pool's KV buffer (sequence axis) to the bucket holding
        ``need`` rows: a new buffer with the old rows copied in, and the
        registered prefix rows padded along. The graphs captured on the old
        buffer are dropped."""
        S = self._cache_S()
        newS = self._cache_bucket(need)
        if newS <= S:
            return
        if self._admitting is not None:
            raise RuntimeError("grow() must not interleave with a chunked "
                               "admission in flight")

        def pad_seq(tree, to):
            out = dict(tree)
            for nm in _kv_names(tree):
                a = tree[nm]
                out[nm] = a.new_zeros(a.shape[:2] + (to,) + a.shape[3:])
                out[nm][:, :, :a.shape[2]] = a
            return out

        self.cache = pad_seq(self.cache, newS)
        self._prefixes = [(ids, pad_seq(row, newS), al)
                          for ids, row, al in self._prefixes]
        self._blocks.clear()

    @torch.no_grad()
    def register_prefix(self, tokens, expect_len: Optional[int] = None
                        ) -> None:
        """Prefill a shared prompt prefix (a system prompt) once and keep
        its KV row; later requests that start with it prefill only their
        suffix against a copy (the same causal-with-offset mask: exact).
        The longest registered match wins.

        With a lossy (int8 / int4) KV cache a whole-prompt prefill and a
        prefix continuation differ: a fresh prefill attends its own float
        K/V, a continuation reads the stored rows dequantized (bit-exact
        rows; the suffix's attention carries the cache's quantization
        noise), as chunked admission over such a cache does (JAX's
        semantics). With dynamic NTK the stored K rows carry their alpha, so
        a request matches only a prefix embedded at its own (full-prompt)
        alpha: ``expect_len`` is the full-prompt length of the traffic the
        prefix serves (default the prefix's own length)."""
        arr = np.asarray(tokens, np.int64).reshape(-1)
        Lp = int(arr.shape[0])
        Tb = bucket_len(Lp, minimum=16)
        if Tb > self.max_len:
            raise ValueError(f"prefix of {Lp} tokens exceeds max_len "
                             f"{self.max_len}")
        self._grow(Tb)  # the row holds the bucket and inserts into the pool
        padded = np.zeros((1, Tb), np.int64)
        padded[0, :Lp] = arr
        alpha = self._alpha_for(expect_len if expect_len is not None
                                else Lp)
        row = self._rows(1, self._cache_S())
        self._forward(torch.from_numpy(padded).to(self.device), row,
                      prefill_fresh=True, last_index=Lp - 1, ntk_alpha=alpha)
        row["pos"] = torch.full((), Lp, dtype=torch.int32,
                                device=self.device)
        self._prefixes.append((tuple(int(t) for t in arr), row, alpha))
        self._prefixes.sort(key=lambda p: -len(p[0]))

    @torch.no_grad()
    def run(self) -> Dict[int, List[int]]:
        """Serve until queue and pool are empty. Returns {rid: tokens}
        (eos-trimmed)."""
        finished: Dict[int, List[int]] = {}
        while self._queue or any(self._active) or self._admitting:
            finished.update(self.step_block())
        return finished

    def stats(self) -> Dict[str, Any]:
        """Queue depth, slot occupancy, prefix-cache hits, captured graphs,
        speculation acceptance (tokens emitted per active row-round)."""
        occ = sum(r is not None for r in self._active)
        s = {"queued": len(self._queue), "active": occ,
             "slots": self.slots, "occupancy": occ / self.slots,
             "admitting": self._admitting is not None,
             "prefix_hits": self.prefix_hits,
             "prefixes_registered": len(self._prefixes),
             "graphs": len(self._blocks)}
        if self.spec_k:
            s["spec_accept_per_round"] = (
                self.spec_emitted / self.spec_row_rounds
                if self.spec_row_rounds else float("nan"))
        return s

    @torch.no_grad()
    def step_block(self) -> Dict[int, List[int]]:
        """One scheduler tick: admit what fits, run one decode block, retire
        finished rows. Returns the requests that finished this tick."""
        self._admit()
        if any(self._active):
            self._decode_block()
        finished = {}
        for i, r in enumerate(self._active):
            if r is not None and r.done:
                finished[r.rid] = r.out
                self._active[i] = None
        return finished

    # -- admission ----------------------------------------------------------

    def _count(self, key) -> None:
        self.admissions[key] = self.admissions.get(key, 0) + 1

    def _prompt_tensor(self, arr, Tb: int) -> torch.Tensor:
        """(Tb,) ids or (Tb, H) embeds on the device, zero-padded."""
        T = arr.shape[0]
        if arr.ndim == 1:
            x = torch.zeros((Tb,), dtype=torch.long, device=self.device)
            x[:T] = torch.from_numpy(np.asarray(arr, np.int64))
            return x
        # the decoder's own cast of embeds, made here so numpy and tensor
        # prompts batch together
        src = (arr if isinstance(arr, torch.Tensor)
               else torch.from_numpy(np.asarray(arr, np.float32)))
        x = torch.zeros((Tb, arr.shape[1]), dtype=self.cfg.dtype,
                        device=self.device)
        x[:T] = src
        return x

    def _admit_rows(self, prompts, lengths, slots, pos, rope_deltas):
        """One (k, Tb) fresh prefill on scratch rows of the prompt bucket,
        written into the pool at ``slots`` (the first Tb columns; a row's
        tail beyond its pos is never read). Pad rows repeat a real row's
        slot with identical data. Returns the device tensors of the first
        tokens: (tok, vals, idx, lse) for a sampling engine, else
        (tok, logprob)."""
        k, Tb = prompts.shape[:2]
        dev = self.device
        rows = self._rows(k, Tb)
        last = (lengths[0] - 1 if k == 1 else
                torch.tensor(lengths, device=dev) - 1)
        alphas = [self._alpha_for(n) for n in lengths]
        alpha = (torch.tensor(alphas, dtype=torch.float32, device=dev)
                 if self._dyn else self.ntk_alpha)
        logits, rows = self._forward(
            prompts, rows, last_index=last, prefill_fresh=True,
            positions=None if pos is None else torch.from_numpy(pos).to(dev),
            ntk_alpha=alpha)
        idx = torch.tensor(slots, device=dev)
        for nm in _kv_names(rows):
            self.cache[nm][:, idx, :Tb] = rows[nm]
        self.alphas[idx] = torch.tensor(alphas, dtype=torch.float32,
                                        device=dev)
        self.cache["pos"][idx] = torch.tensor(lengths, dtype=torch.int32,
                                              device=dev)
        self.cache["rope_delta"][idx] = torch.tensor(
            rope_deltas, dtype=torch.int32, device=dev)
        return self._first(logits[:, 0])

    def _first(self, logits: torch.Tensor):
        tok = logits.argmax(dim=-1).to(torch.int32)
        l32 = logits.float()
        lse = torch.logsumexp(l32, dim=-1)
        if self.sample_top_k:
            return (tok, *top_k(l32, self.sample_top_k), lse)
        return tok, l32.amax(dim=-1) - lse

    def _match_prefix(self, r: _Request):
        """The longest registered prefix this request starts with (and is
        strictly longer than), or None. Embeds requests match through their
        ``draft_ids``, and only where their M-RoPE positions over the prefix
        are an arange (text before any image)."""
        if r.tokens_or_embeds.ndim == 1 and r.positions is None:
            ids = tuple(int(t) for t in r.tokens_or_embeds)
        elif (r.tokens_or_embeds.ndim == 2 and r.draft_ids is not None
              and r.draft_ids.shape[0] == r.tokens_or_embeds.shape[0]):
            ids = tuple(int(t) for t in r.draft_ids)
        else:
            return None
        alpha = self._alpha_for(len(ids))
        for ptoks, row, palpha in self._prefixes:  # sorted longest-first
            if palpha != alpha:
                continue
            if len(ptoks) < len(ids) and ids[:len(ptoks)] == ptoks:
                if r.positions is not None:
                    n = len(ptoks)
                    if not np.array_equal(
                            r.positions[:, :n],
                            np.broadcast_to(np.arange(n), (3, n))):
                        continue
                return ptoks, row
        return None

    def _begin_admission(self, r: _Request, slot: int, prefix):
        """Staged admission: a scratch row (a copy of the prefix row, or a
        fresh one) with the cursor past the matched prefix."""
        if prefix is not None:
            ptoks, prow = prefix
            row = {nm: t.clone() for nm, t in prow.items()}
            cursor = len(ptoks)
            self.prefix_hits += 1
        else:
            row = self._rows(1, self._cache_S())
            cursor = 0
        self._admitting = _Admitting(r, slot, row, cursor)

    def _advance_admission(self):
        """Feed ONE piece of the admitting prompt against its row; insert
        the row into the pool when the prompt is exhausted."""
        a = self._admitting
        arr = a.req.tokens_or_embeds
        T = arr.shape[0]
        chunk = self.admit_chunk or T
        end = min(a.cursor + chunk, T)
        plen = end - a.cursor
        Tp = min(bucket_len(plen, minimum=16), max(chunk, 16))
        Tp = min(Tp, int(a.row["k"].shape[2]) - a.cursor)  # row's end
        piece = self._prompt_tensor(arr[a.cursor:end], Tp)[None]
        pos = None
        if a.req.positions is not None:
            p = a.req.positions[:, a.cursor:end]
            p = np.pad(p, ((0, 0), (0, Tp - plen)), mode="edge")
            pos = torch.from_numpy(np.ascontiguousarray(p[:, None])).to(
                self.device)
        self._count(("row_step", Tp, arr.ndim == 2, pos is not None))
        pos0 = a.row["pos"]
        logits, a.row = self._forward(piece, a.row, positions=pos,
                                      last_index=plen - 1,
                                      ntk_alpha=self._alpha_for(T))
        a.row["pos"] = pos0 + plen
        a.cursor = end
        if a.cursor < T:
            return
        # prompt exhausted: insert into the pool, then the first token
        r = a.req
        rope_delta = (0 if r.positions is None
                      else int(r.positions.max()) + 1 - T)
        for nm in _kv_names(a.row):
            self.cache[nm][:, a.slot] = a.row[nm][:, 0]
        self.alphas[a.slot] = self._alpha_for(T)
        self.cache["pos"][a.slot] = T
        self.cache["rope_delta"][a.slot] = rope_delta
        first = [t.cpu().numpy() for t in self._first(logits[:, 0])]
        self._admitting = None
        self._finish_first(r, a.slot, first, 0)

    def _prompt_counts(self, r: _Request) -> np.ndarray:
        ids = (r.tokens_or_embeds if r.tokens_or_embeds.ndim == 1
               else r.draft_ids)
        row = np.zeros((self.cfg.vocab,), np.int32)
        if ids is not None:
            np.add.at(row, np.clip(np.asarray(ids, np.int64), 0,
                                   self.cfg.vocab - 1), 1)
        return row

    def _finish_first(self, r: _Request, slot: int, first, i: int):
        """Row ``i`` of an admission's host outputs (:meth:`_first`)."""
        if self.sample_top_k:
            tok, vals, idx, lse = first
            self._finish_admit(r, slot, int(tok[i]),
                               topk=(vals[i], idx[i], float(lse[i])))
        else:
            tok, lp = first
            self._finish_admit(r, slot, int(tok[i]), lp=float(lp[i]))

    def _finish_admit(self, r: _Request, slot: int, tok: int, topk=None,
                      lp: float = 0.0):
        if topk is not None:
            vals, idx, lse = topk
            cnts = self._prompt_counts(r)
            pen = vals
            if r.presence_penalty or r.frequency_penalty:
                # penalize the raw logits, then temperature-scale (the
                # block's order of operations)
                c = cnts[np.asarray(idx, np.int64)]
                pen = (np.asarray(vals, np.float64)
                       - r.presence_penalty * (c > 0)
                       - r.frequency_penalty * c)
            if r.temperature > 0:
                pos = host_sample_first(pen, idx, r.temperature, r.top_p,
                                        np.random.default_rng(r.seed))
            else:
                pos = int(np.argmax(pen))
            tok = int(idx[pos])
            lp = float(vals[pos]) - lse  # raw model-distribution logprob
            if not (self.eos_id is not None and tok == self.eos_id):
                cnts[tok] += 1
            self.tok_counts[slot].copy_(torch.from_numpy(cnts))
        r.slot = slot
        if self.eos_id is not None and tok == self.eos_id:
            r.done = True  # eos-trimmed: empty output
        else:
            r.next_tok = tok
            r.out.append(tok)
            r.lps.append(lp)
            r.done = len(r.out) >= r.max_new_tokens
        if self.spec_k:
            # the slot's draft history: prompt ids (or draft_ids) + token
            row = np.zeros((self.hist.shape[1],), np.int32)
            ids = (r.tokens_or_embeds if r.tokens_or_embeds.ndim == 1
                   else r.draft_ids)
            n = 0
            if ids is not None:
                n = min(int(ids.shape[0]), self.hist.shape[1] - 1)
                row[:n] = np.asarray(ids)[:n]
            row[n] = tok
            self.hist[slot].copy_(torch.from_numpy(row))
            self.hist_len[slot] = n + 1
        # done-at-admission rows hold the slot until this tick's sweep
        self._active[slot] = r

    def _admit(self):
        # a staged admission advances one piece a tick; nothing else admits
        # until it lands (FIFO)
        if self._admitting is not None:
            self._advance_admission()
            if self._admitting is not None:
                return
        plain = []  # (r, slot, prompt, T, pos, rope_delta, Tb)
        dispatched = []  # (members [(r, slot)], device outputs)

        def flush():
            self._dispatch_plain(plain, dispatched)
            for members, first in dispatched:
                first = [t.cpu().numpy() for t in first]
                for i, (r, slot) in enumerate(members):
                    self._finish_first(r, slot, first, i)
            dispatched.clear()

        free = [i for i, r in enumerate(self._active) if r is None]
        while free and self._queue:
            slot = free.pop(0)
            r = self._queue.popleft()
            arr = r.tokens_or_embeds
            T = arr.shape[0]
            prefix = self._match_prefix(r)
            suffix_len = T - (len(prefix[0]) if prefix else 0)
            chunked = self.admit_chunk and suffix_len > self.admit_chunk
            if prefix is not None or chunked:
                self._begin_admission(r, slot, prefix)
                if chunked:
                    self._advance_admission()  # one piece this tick
                    if self._admitting is not None:
                        flush()
                        return
                else:
                    while self._admitting is not None:
                        self._advance_admission()
                continue
            Tb = bucket_len(T, minimum=16)
            pos = rope_delta = None
            if r.positions is not None:
                # edge-padded M-RoPE ids; decode resumes at max + 1
                pos = np.pad(r.positions, ((0, 0), (0, Tb - T)), mode="edge")
                rope_delta = int(r.positions.max()) + 1 - T
            plain.append((r, slot, self._prompt_tensor(arr, Tb), T, pos,
                          rope_delta, Tb))
        flush()

    def _dispatch_plain(self, plain, dispatched):
        """Group the collected admissions by (bucket, kind) and dispatch each
        group as batched prefills of k = 1/2/4/8 rows (padded by repeating
        the last member), cut at the power-of-two floor of
        ``admit_batch_tokens`` / Tb."""
        groups: Dict[Any, list] = {}
        for item in plain:
            r, slot, prompt, T, pos, rope_delta, Tb = item
            groups.setdefault((Tb, prompt.ndim == 2, pos is not None),
                              []).append(item)
        plain.clear()
        for (Tb, embeds, has_pos), items in groups.items():
            max_k = max(1, self.admit_batch_tokens // Tb)
            cap = min(8, 1 << (max_k.bit_length() - 1))
            while items:
                chunk, items = items[:cap], items[cap:]
                k = 1 << (len(chunk) - 1).bit_length()  # 1/2/4/8
                padded = chunk + [chunk[-1]] * (k - len(chunk))
                self._count(("admit", Tb, embeds, has_pos) if k == 1
                            else ("admitN", Tb, k, embeds, has_pos))
                pos = (np.stack([c[4] for c in padded], axis=1)
                       if has_pos else None)
                first = self._admit_rows(
                    torch.stack([c[2] for c in padded]),
                    [c[3] for c in padded], [c[1] for c in padded], pos,
                    [c[5] or 0 for c in padded])
                dispatched.append(([(c[0], c[1]) for c in chunk], first))

    # -- decode -------------------------------------------------------------

    def _block(self, spec: bool) -> _Block:
        """The block of this kind at the pool's current buffer, captured at
        first use."""
        n = self.steps_per_block
        width = n * (self.spec_k + 1) if spec else n
        key = ("spec_block" if spec else "block", n, self._cache_S())
        if key not in self._blocks:
            self._blocks[key] = _Block(self, width, spec)
        return self._blocks[key]

    def _block_inputs(self):
        """The live rows [(slot, request)] and the block's host inputs
        (:class:`_Block`'s ``ints`` and ``floats``)."""
        ints = np.zeros((self.slots, 4), np.int64)
        floats = np.zeros((self.slots, 4), np.float32)
        floats[:, 1] = 1.0
        live = [(i, r) for i, r in enumerate(self._active)
                if r is not None and not r.done]
        for i, r in live:
            ints[i, :3] = (r.next_tok, 1, r.seed)
            # the emitted index of the next token, or the row's budget
            ints[i, 3] = (r.max_new_tokens - len(r.out) if self.spec_k
                          else len(r.out))
            floats[i] = (r.temperature, r.top_p, r.presence_penalty,
                         r.frequency_penalty)
        return live, ints, floats

    def _decode_block(self):
        spec = self.spec_k > 0
        live, ints, floats = self._block_inputs()
        if not live:
            return
        blk = self._block(spec)
        blk.load(ints, floats)
        blk.graph(self.steps_per_block)
        out, lps, counts = blk.read()
        if spec:
            self.spec_emitted += int(counts.sum())
            self.spec_row_rounds += len(live) * self.steps_per_block
        for i, r in live:
            for j in range(out.shape[1] if counts is None else counts[i]):
                t = int(out[i, j])
                if self.eos_id is not None and t == self.eos_id:
                    r.done = True
                    break
                r.out.append(t)
                r.lps.append(float(lps[i, j]))
                r.next_tok = t
                if len(r.out) >= r.max_new_tokens:
                    r.done = True
                    break
