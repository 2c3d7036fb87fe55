"""Greedy generation with a KV cache — prefill / decode split (counterpart of
``mquant_tpu/serve/generate.py``).

Prompt lengths are bucketed to powers of two (``bucket_len``) as in the JAX
package. The decode loop is a Python loop over steps on the device: finished
rows freeze to eos and the loop stops once every row is done. (CUDA graphs
for the loop are later work.)
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.llm import DecoderConfig, decoder_forward, init_cache


def bucket_len(n: int, minimum: int = 32) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def prepare_w4_resident(cfg: DecoderConfig, params, specs, mode: str):
    """Serving residency of W4 weights: ONE copy, split-half packed bytes,
    with the shared-input groups (q|k|v, gate|up) fused into one matrix each
    (the JAX package's ``packed`` mode under the W4 GEMV). Returns params
    unchanged unless real-mode W4 serving applies."""
    if not (mode == "real" and specs and isinstance(params, dict)
            and "layers" in params):
        return params
    from ..kernels.qmm import pack_w4_sites

    packed = pack_w4_sites(params["layers"], specs, cfg.in_dims,
                           fuse_groups=True)
    return {**{k: v for k, v in params.items() if k != "layers"},
            "layers": packed}


def _lengths(seqs) -> list:
    """Prompt lengths of token id sequences (T,) or embeddings (…, T, H)."""
    return [int(s.shape[-2]) if getattr(s, "ndim", 1) >= 2 else len(s)
            for s in seqs]


class Generator:
    """Prefill / decode for one (cfg, specs, state, mode)."""

    def __init__(self, cfg: DecoderConfig, params, specs=None, state=None,
                 mode: str = "fp", max_len: int = 512):
        self.cfg = cfg
        self.specs = specs or {}
        self.state = state
        self.mode = mode
        self.max_len = max_len
        self.params = prepare_w4_resident(cfg, params, self.specs, mode)

    def _forward(self, x, cache, positions=None, last_index=None,
                 prefill_fresh=False, attn_mask=None, attn_start=None):
        return decoder_forward(self.cfg, self.params, x, specs=self.specs,
                               state=self.state, mode=self.mode, cache=cache,
                               positions=positions, attn_mask=attn_mask,
                               last_index=last_index,
                               prefill_fresh=prefill_fresh,
                               attn_start=attn_start)

    def ensure_capacity(self, n: int):
        """Grow the KV cache length to hold at least ``n`` positions (sticky,
        as in the JAX Generator)."""
        if n > self.max_len:
            self.max_len = bucket_len(n)

    @torch.no_grad()
    def prefill(self, tokens_or_embeds: torch.Tensor, positions=None
                ) -> Tuple[torch.Tensor, Dict]:
        """Run the (bucket-padded) prefill; returns (last-token logits (B, V),
        cache). ``positions``: optional (B, T) or M-RoPE (3, B, T) ids."""
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
        cache = init_cache(self.cfg, B, self.max_len, device=dev)
        logits, cache = self._forward(tokens_or_embeds, cache,
                                      positions=positions, last_index=T - 1,
                                      prefill_fresh=True)
        cache["pos"] = T  # the true length, not the padded bucket
        cache["rope_delta"] = rope_delta.contiguous()
        return logits[:, 0], cache

    @torch.no_grad()
    def generate_on_device(self, tokens: torch.Tensor,
                           max_new_tokens: int = 32, positions=None,
                           eos_id: Optional[int] = None,
                           on_first_token: Optional[Callable] = None
                           ) -> torch.Tensor:
        """Greedy generation: (B, max_new_tokens) int32. With ``eos_id``,
        rows past their eos are frozen to eos and the loop exits once every
        row is done (the remaining columns hold eos). ``on_first_token`` is
        called with the (B, 1) first tokens as soon as they are issued (to
        stream them, or to take the time to first token)."""
        self.ensure_capacity(tokens.shape[1] + max_new_tokens)
        last_logits, cache = self.prefill(tokens, positions=positions)
        tok = last_logits.argmax(dim=-1).to(torch.int32)[:, None]
        if on_first_token is not None:
            on_first_token(tok)
        return self._decode_loop(tok, cache, max_new_tokens, eos_id)

    def _decode_loop(self, tok, cache, max_new_tokens: int,
                     eos_id: Optional[int], attn_start=None) -> torch.Tensor:
        """Greedy steps after the first token ``tok`` (B, 1): (B,
        max_new_tokens) int32 with ``tok`` in column 0; rows past their eos
        freeze to eos and the loop exits once every row is done."""
        B = tok.shape[0]
        out = torch.full((B, max_new_tokens),
                         eos_id if eos_id is not None else 0,
                         dtype=torch.int32, device=tok.device)
        out[:, :1] = tok
        done = (tok[:, 0] == eos_id) if eos_id is not None else None
        for i in range(1, max_new_tokens):
            if done is not None and bool(done.all()):
                break
            logits, cache = self._forward(tok, cache, attn_start=attn_start)
            nxt = logits[:, -1].argmax(dim=-1).to(torch.int32)
            if done is not None:
                nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
                done = done | (nxt == eos_id)
            out[:, i] = nxt
            tok = nxt[:, None]
        return out

    @torch.no_grad()
    def prefill_batch(self, seqs, positions=None):
        """Prefill of ragged prompts in one batch: each is LEFT-padded to the
        shared bucket Tb, and the prefill mask (col ≤ row) & (col ≥ start_i)
        keeps the pad columns out of attention. Returns (last-token logits
        (B, V), cache, starts (B,) int32 = Tb − len_i).

        ``seqs``: token id sequences (T_i,) or embeddings (T_i, hidden) /
        (1, T_i, hidden). ``positions``: optional per-row position ids, each
        (T_i,), M-RoPE (3, T_i) or (3, 1, T_i), or None for arange(T_i).
        Each row's ids are shifted by its start column, the left pad is
        edge-filled (masked anyway), and the cache's per-row ``rope_delta``
        makes decode continue at that row's max(position) + 1."""
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
        cache = init_cache(self.cfg, B, self.max_len, device=dev)
        logits, cache = self._forward(x, cache, positions=pos_b,
                                      last_index=Tb - 1, prefill_fresh=True,
                                      attn_mask=mask)
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
        Qwen2-VL has no dynamic NTK and neither has the port, so there is no
        per-row NTK alpha as in the JAX function."""
        self.ensure_capacity(bucket_len(max(_lengths(seqs))) + max_new_tokens)
        logits, cache, starts = self.prefill_batch(seqs, positions=positions)
        tok = logits.argmax(dim=-1).to(torch.int32)[:, None]
        out = self._decode_loop(tok, cache, max_new_tokens, eos_id,
                                attn_start=starts).tolist()
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
