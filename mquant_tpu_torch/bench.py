#!/usr/bin/env python
"""W4A8 against bf16 on one NVIDIA GPU: the port of the repository's
``bench.py`` (Qwen2-VL-7B widths, depth 28, seeded random weights).

Both variants serve the same requests through ``serve.generate.Generator``:
the model-latency TTFT (chained 1024-token prefills, one CUDA graph replayed
``chain`` times, divided by chain), the decode rate of the on-device loop
(128 tokens, ``DecodeLoop``'s CUDA graph), a measured LLM request (1024-token
prefill + 128 greedy tokens in one wall-clock span) and the measured
full-VLM request (448² image → ViT → merger → splice (one CUDA graph) →
1024-token prefill → 128 tokens). W4A8: W4 per-channel LLM sites with static
int8 activations, the block I⊗H₁₂₈ Hadamard before ``down``, an lm_head of
the width the gate picks (``resolve_bench_head``), W8A8 ViT and merger; bf16:
the same model in ``fp`` mode (bf16 products on cuBLAS, the f32 einsum
prefill attention, the fused decode attention kernel). Every span ends in a
read of a result on the card; best of ``--iters``.

Prints progress on stderr and ONE JSON object as the last line of stdout:
bench.py's keys (the roofline keys against the H100's peaks, 3350 GB/s HBM
and 1979 dense int8 TOP/s), plus the card (``card_line()``), the cuBLAS
reduced-precision bf16 reduction flag it ran with, the depth and the raw
times of both variants.

Usage: ``python -m mquant_tpu_torch.bench [--iters 3] [--chain 32]``;
``--device cpu`` runs the whole bench at ``Qwen2VLConfig.tiny`` (bf16) with
a 64-token prompt and a few tokens, untimed in any useful sense (a check
that it runs). ``MQUANT_BENCH_HEAD=4|8`` forces the lm_head width,
``MQUANT_BENCH_HAD=full`` the full Hadamard.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time

import torch

HAD_MODE = "block"  # online Hadamard before down ("full": MQUANT_BENCH_HAD)
HBM_PEAK_GBPS = 3350.0  # H100 SXM HBM3
INT8_PEAK_TOPS = 1979.0  # H100 SXM dense int8


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The request: prompt tokens, greedy tokens a request, decode-rate
    tokens, image side (pixels) and the cache length."""

    prefill: int
    gen_tokens: int
    decode_tokens: int
    side: int

    @property
    def max_len(self) -> int:
        return self.prefill + self.gen_tokens


CARD = Sizes(prefill=1024, gen_tokens=128, decode_tokens=128, side=448)
TINY = Sizes(prefill=64, gen_tokens=4, decode_tokens=4, side=32)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def base_config(device):
    """Qwen2-VL-7B on the card; the tiny configuration in bf16 on the CPU."""
    from .models.qwen2vl import Qwen2VLConfig

    if torch.device(device).type != "cpu":
        return Qwen2VLConfig.qwen2vl_7b()
    t = Qwen2VLConfig.tiny()
    bf = torch.bfloat16
    return dataclasses.replace(
        t, llm=dataclasses.replace(t.llm, dtype=bf),
        vit=dataclasses.replace(t.vit, dtype=bf),
        merger=dataclasses.replace(t.merger, dtype=bf))


def sizes_for(device) -> Sizes:
    return TINY if torch.device(device).type == "cpu" else CARD


def make_cfg(n_layers, intermediate_pad=0, device="cuda"):
    return dataclasses.replace(base_config(device).llm, n_layers=n_layers,
                               intermediate_pad=intermediate_pad)


def w4a8_pad(intermediate: int) -> int:
    """``auto_pad_size`` (bench.py's pad), rounded up to the block
    Hadamard's 128 (18944 = 148·128 stays; the tiny 96 becomes 128)."""
    from .transform.hadamard import auto_pad_size

    return -(-auto_pad_size(intermediate) // 128) * 128


def llm_specs(lm_head_bits=None, had_mode=None):
    """bench.py's serving specs (``random_init.llm_specs``), the head width
    from ``MQUANT_BENCH_HEAD`` (default 8) and the Hadamard from
    ``MQUANT_BENCH_HAD`` (default block)."""
    from . import random_init as R

    if lm_head_bits is None:
        lm_head_bits = int(os.environ.get("MQUANT_BENCH_HEAD", "8"))
    if had_mode is None:
        had_mode = os.environ.get("MQUANT_BENCH_HAD", HAD_MODE)
    return R.llm_specs(had_mode, lm_head_bits=lm_head_bits)


def init_bf16(cfg, seed: int, device):
    """bf16 decoder params (``init_decoder_params``), drawn on a CPU
    generator and moved to ``device``."""
    from .models.llm import init_decoder_params

    return init_decoder_params(dataclasses.replace(cfg, dtype=torch.bfloat16),
                               torch.Generator().manual_seed(seed),
                               dtype=torch.bfloat16, device=device)


def resolve_bench_head(device="cuda") -> int:
    """lm_head width of this run. ``MQUANT_BENCH_HEAD=8|4`` forces it; the
    default ("auto") runs the head gate at the run's widths on a depth-2
    bf16 decoder: only the head fake-quantized at 4 and at 8 bits, the
    head-only perplexity ratios of the logits of 2 × 128 random tokens; W4
    wins iff its ratio stays under ``HEAD_GATE_DEFAULT``. The pick is
    written back to ``MQUANT_BENCH_HEAD`` for every later reader."""
    v = os.environ.get("MQUANT_BENCH_HEAD", "auto")
    if v in ("4", "8"):
        return int(v)
    from .models.llm import decoder_forward
    from .utils.autobits import (HEAD_GATE_DEFAULT, head_quantized_decoder,
                                 ppl_ratio_from_logits)

    cfg = dataclasses.replace(make_cfg(2, device=device),
                              dtype=torch.bfloat16)
    params = init_bf16(cfg, 9, device)
    toks = torch.randint(0, cfg.vocab, (2, 128),
                         generator=torch.Generator().manual_seed(10)
                         ).to(device)
    with torch.no_grad():
        lf = decoder_forward(cfg, params, toks)[0]
        r4 = ppl_ratio_from_logits(lf, decoder_forward(
            cfg, head_quantized_decoder(params, 4), toks)[0])
        r8 = ppl_ratio_from_logits(lf, decoder_forward(
            cfg, head_quantized_decoder(params, 8), toks)[0])
    pick = 4 if r4 <= HEAD_GATE_DEFAULT else 8
    log(f"lm_head gate at {cfg.hidden}/{cfg.vocab}: W4 ppl ratio {r4:.5f}, "
        f"int8 {r8:.5f} (gate {HEAD_GATE_DEFAULT}) -> {pick}-bit head")
    os.environ["MQUANT_BENCH_HEAD"] = str(pick)
    del params, lf
    gc.collect()
    return pick


def init_w4a8(cfg, device):
    """Seeded W4A8 decoder (``random_init.init_w4a8``; the head width of
    ``MQUANT_BENCH_HEAD``), built on ``device``. Returns (params, state)."""
    from . import random_init as R

    gen = torch.Generator(device=device).manual_seed(0)
    return R.init_w4a8(cfg, gen, device, lm_head_bits=int(
        os.environ.get("MQUANT_BENCH_HEAD", "8")))


def init_vision(quantized: bool, device):
    """ViT + merger (bf16, or realized W8A8) with the quantized variant's
    static state and specs: (vcfg, vit, merger, state, specs)."""
    from . import random_init as R
    from .models.vision import init_merger_params, init_vit_params

    vcfg = base_config(device)
    gen = torch.Generator().manual_seed(3)
    vp = init_vit_params(vcfg.vit, gen, dtype=torch.bfloat16, device=device)
    mp = init_merger_params(vcfg.merger, gen, dtype=torch.bfloat16,
                            device=device)
    if not quantized:
        return vcfg, vp, mp, None, None
    vq, mq = R.realize_vision(vp, mp)
    return (vcfg, vq, mq, R.vision_state(vcfg.vit.n_layers, device),
            R.vision_specs())


def make_vlm_inputs(vcfg, sizes: Sizes, device):
    """(patches, grid, tokens): one ``sizes.side``² image and a prompt of
    ``sizes.prefill`` tokens with its merged image tokens at 2.."""
    from . import random_init as R

    gen = torch.Generator(device=device).manual_seed(7)
    return R.vlm_inputs(vcfg.image_token_id, vcfg.vit.patch_dim,
                        sizes.prefill, gen, device, side=sizes.side,
                        patch=vcfg.patch)


@torch.no_grad()
def measure_vlm_request(gen, vcfg, vp, mp, vstate, vspecs, mode, sizes,
                        iters: int = 3) -> float:
    """Measured full-VLM request: one wall-clock span over image patches →
    ViT → merger → splice into the text embeddings (one CUDA graph, as
    bench.py's one jitted function) → prefill → ``sizes.gen_tokens`` greedy
    tokens (the decode loop). Best of ``iters`` after a warm-up request,
    each on patches moved by 1e-6 · (i + 1)."""
    from .models.qwen2vl import splice_image_embeds
    from .models.vision import merger_forward, vit_forward
    from .serve.generate import Graphed, _force

    device = gen.params["embed"]["w"].device
    patches, grid, toks = make_vlm_inputs(vcfg, sizes, device)
    p_in = patches.clone()
    embed_w = gen.params["embed"]["w"]
    out = {}

    def embeds():
        feats, _ = vit_forward(vcfg.vit, vp, p_in, vspecs, vstate, mode,
                               grid_hw=grid)
        merged, _ = merger_forward(vcfg.merger, mp, feats, vspecs, vstate,
                                   mode)
        out["emb"] = splice_image_embeds(embed_w[toks].to(torch.bfloat16),
                                         toks, merged, vcfg.image_token_id)

    run = Graphed(embeds, device)
    run()
    _force(gen.generate_on_device(out["emb"], sizes.gen_tokens))
    best = float("inf")
    for i in range(iters):
        p_in.copy_(patches + 1e-6 * (i + 1))
        t0 = time.perf_counter()
        run()
        _force(gen.generate_on_device(out["emb"], sizes.gen_tokens))
        best = min(best, time.perf_counter() - t0)
    return best


def site_dims(cfg):
    """(din, dout) per quantized LLM site at these dims."""
    Hd, I = cfg.hidden, cfg.inter_eff
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"q": (Hd, H * hd), "k": (Hd, KV * hd), "v": (Hd, KV * hd),
            "o": (H * hd, Hd), "gate": (Hd, I), "up": (Hd, I),
            "down": (I, Hd)}


def _head_bytes() -> float:
    return 0.5 if int(os.environ.get("MQUANT_BENCH_HEAD", "8")) == 4 else 1.0


def decode_step_bytes(cfg, w4_packed: bool, s_attn: int) -> float:
    """Modeled HBM bytes one decode step streams: the quantized weights
    (packed W4 0.5 B a weight, int8 1), the int8 or packed-W4 lm_head, and
    the bf16 KV cache over ``s_attn`` columns (bench.py's model, which
    counts the cache buffer's length)."""
    per_layer = sum(a * b for a, b in site_dims(cfg).values())
    w_bytes = cfg.n_layers * per_layer * (0.5 if w4_packed else 1.0)
    w_bytes += cfg.hidden * cfg.vocab * _head_bytes()
    kv_bytes = 2 * 2 * cfg.n_layers * s_attn * cfg.n_kv_heads * cfg.head_dim
    return w_bytes + kv_bytes


def prefill_int8_macs(cfg, T: int) -> float:
    """int8 GEMM MACs of one prefill over the quantized sites; the lm_head
    counts once (the serving prefill computes the last token's logits)."""
    per_layer = sum(a * b for a, b in site_dims(cfg).values())
    return T * cfg.n_layers * per_layer + cfg.hidden * cfg.vocab


def pooled_roofline(cfg, tps_total: float, B: int, s_attn: int,
                    w4_packed: bool = True) -> dict:
    """Roofline of multi-stream decode (B rows a step): the weights stream
    once a step, the KV read grows with B; bytes a step, achieved GB/s, the
    int8 rate, and which resource binds (against the H100's peaks)."""
    per_layer = sum(a * b for a, b in site_dims(cfg).values())
    w_bytes = cfg.n_layers * per_layer * (0.5 if w4_packed else 1.0)
    w_bytes += cfg.hidden * cfg.vocab * _head_bytes()
    kv_bytes = (B * 2 * 2 * cfg.n_layers * s_attn
                * cfg.n_kv_heads * cfg.head_dim)
    bts = w_bytes + kv_bytes
    t_step = B / tps_total
    gbps = bts / t_step / 1e9
    macs = B * (cfg.n_layers * per_layer + cfg.hidden * cfg.vocab)
    tops = 2 * macs / t_step / 1e12
    bw_frac = gbps / HBM_PEAK_GBPS
    mfu = tops / INT8_PEAK_TOPS
    return {"batch": B, "s_attn": s_attn,
            "tok_per_s": round(tps_total, 1),
            "bytes_per_step_mb": round(bts / 1e6, 1),
            "weight_bytes_frac": round(w_bytes / bts, 3),
            "kv_bytes_frac": round(kv_bytes / bts, 3),
            "achieved_gbps": round(gbps, 1),
            "bw_frac": round(bw_frac, 3),
            "int8_tops": round(tops, 2),
            "mfu_int8": round(mfu, 4),
            "bound": "HBM" if bw_frac >= mfu else "MXU"}


def roofline(cfg, ttft: float, tps: float, s_attn: int, w4_packed: bool,
             prefill: int = CARD.prefill) -> dict:
    """Achieved decode bandwidth and prefill int8 rate against the H100's
    peaks."""
    bts = decode_step_bytes(cfg, w4_packed, s_attn)
    gbps = bts * tps / 1e9
    tops = 2 * prefill_int8_macs(cfg, prefill) / ttft / 1e12
    return {"decode_bytes_per_step": round(bts / 1e6, 1),
            "decode_achieved_gbps": round(gbps, 1),
            "decode_bw_frac": round(gbps / HBM_PEAK_GBPS, 3),
            "prefill_int8_tops": round(tops, 1),
            "prefill_mfu_int8": round(tops / INT8_PEAK_TOPS, 3)}


def measure(cfg, params, specs, state, mode, label, sizes: Sizes,
            iters: int = 3, chain: int = 32):
    """(ttft s, decode tok/s, request s, full-VLM request s, setup s) of one
    variant; setup = the first chained prefill's build, eager run, capture
    and chain."""
    from .serve.generate import (Generator, measure_decode_tps,
                                 measure_request, measure_ttft_chained)

    device = params["embed"]["w"].device
    gen = Generator(cfg, params, specs=specs, state=state, mode=mode,
                    max_len=sizes.max_len)
    toks = torch.ones((1, sizes.prefill), dtype=torch.long, device=device)
    stats = {}
    ttft = measure_ttft_chained(gen, toks, chain=chain, iters=iters,
                                stats=stats)
    setup_s = stats["setup_s"]
    log(f"[{label}] TTFT {ttft * 1e3:.2f} ms model-latency (chain {chain}; "
        f"setup + capture {setup_s:.1f} s)")
    tps = measure_decode_tps(gen, toks, n_tokens=sizes.decode_tokens,
                             on_device=True)
    log(f"[{label}] decode {tps:.1f} tok/s (the decode loop)")
    req = measure_request(gen, toks, gen_tokens=sizes.gen_tokens,
                          iters=iters)
    log(f"[{label}] measured request (prefill {sizes.prefill} + "
        f"{sizes.gen_tokens} tokens): {req:.4f} s")
    quantized = mode == "real"
    vcfg, vp, mp, vstate, vspecs = init_vision(quantized, device)
    req_vlm = measure_vlm_request(gen, vcfg, vp, mp, vstate, vspecs, mode,
                                  sizes, iters=iters)
    log(f"[{label}] measured full-VLM request ({sizes.side}² image + prefill "
        f"{sizes.prefill} + {sizes.gen_tokens} tokens): {req_vlm:.4f} s")
    del vp, mp, gen
    gc.collect()
    return ttft, tps, req, req_vlm, setup_s


def try_measure(n_layers: int, variant: str, device, sizes: Sizes,
                iters: int = 3, chain: int = 32):
    """One variant ('bf16' | 'w4a8') at ``n_layers``: its :func:`measure`.
    An out-of-memory or any other error propagates (no shallower retry)."""
    if variant == "bf16":
        cfg = make_cfg(n_layers, device=device)
        params = init_bf16(cfg, 0, device)
        specs, state, mode = None, None, "fp"
    else:
        cfg = make_cfg(n_layers, w4a8_pad(make_cfg(1, device=device)
                                          .intermediate), device=device)
        params, state = init_w4a8(cfg, device)
        specs, mode = llm_specs(), "real"
    try:
        return measure(cfg, params, specs, state, mode,
                       f"{variant} L={n_layers}", sizes, iters, chain)
    finally:
        del params
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=3,
                    help="best of this many timed runs")
    ap.add_argument("--chain", type=int, default=32,
                    help="chained prefills a TTFT run")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device (pass --device cpu for the "
                         "tiny CPU run)")
    if on_card:
        from .scripts.timing import card_line

        card = card_line()
    else:
        card = "cpu"
    sizes = sizes_for(device)
    depth = base_config(device).llm.n_layers
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    log(f"bench: {card}; torch {torch.__version__}; depth {depth}; cuBLAS "
        f"bf16 reduced-precision reduction {flag}")
    head_bits = resolve_bench_head(device)
    log(f"lm_head width for this run: {head_bits}-bit")
    kw = dict(device=device, sizes=sizes, iters=args.iters, chain=args.chain)
    ttft_q, tps_q, req_q, reqv_q, setup_q = try_measure(depth, "w4a8", **kw)
    ttft_b, tps_b, req_b, reqv_b, setup_b = try_measure(depth, "bf16", **kw)

    ttft_red = (1.0 - ttft_q / ttft_b) * 100.0
    e2e_red = (1.0 - req_q / req_b) * 100.0
    vlm_red = (1.0 - reqv_q / reqv_b) * 100.0
    log(f"TTFT: bf16 {ttft_b * 1e3:.2f} ms vs w4a8 {ttft_q * 1e3:.2f} ms "
        f"({ttft_red:.1f}% reduction); decode {tps_b:.1f} -> {tps_q:.1f} "
        f"tok/s ({tps_q / tps_b:.2f}x); LLM request {req_b:.4f} s -> "
        f"{req_q:.4f} s ({e2e_red:.1f}%); full-VLM request {reqv_b:.4f} s "
        f"-> {reqv_q:.4f} s ({vlm_red:.1f}%); depth {depth}; {card}")
    rl = roofline(make_cfg(depth, device=device), ttft_q, tps_q,
                  s_attn=sizes.max_len, w4_packed=True,
                  prefill=sizes.prefill)
    log(f"roofline: decode {rl['decode_achieved_gbps']} GB/s "
        f"({rl['decode_bw_frac'] * 100:.1f}% of {HBM_PEAK_GBPS} GB/s, "
        f"{rl['decode_bytes_per_step']} MB a step), prefill "
        f"{rl['prefill_int8_tops']} int8 TOP/s "
        f"({rl['prefill_mfu_int8'] * 100:.1f}% of {INT8_PEAK_TOPS})")
    result = {
        "metric": "qwen2vl7b_w4a8_full_vlm_request_latency_reduction_vs_bf16",
        "value": round(vlm_red, 2),
        "unit": "%",
        "vs_baseline": round(vlm_red / 30.0, 3),
        "ttft_reduction_pct": round(ttft_red, 2),
        "decode_tps_w4a8": round(tps_q, 1),
        "decode_speedup": round(tps_q / tps_b, 2),
        "ttft_ms_w4a8": round(ttft_q * 1e3, 2),
        "gemv": "mq_w4a8_gemv" if on_card else "w4a8_gemv_ref",
        "lm_head_bits": head_bits,
        "setup_compile_s_w4a8": round(setup_q, 1),
        "setup_compile_s_bf16": round(setup_b, 1),
        **rl,
        "ttft_ms_bf16": round(ttft_b * 1e3, 2),
        "decode_tps_bf16": round(tps_b, 1),
        "request_s_w4a8": round(req_q, 4),
        "request_s_bf16": round(req_b, 4),
        "vlm_request_s_w4a8": round(reqv_q, 4),
        "vlm_request_s_bf16": round(reqv_b, 4),
        "hbm_peak_gbps": HBM_PEAK_GBPS,
        "int8_peak_tops": INT8_PEAK_TOPS,
        "depth": depth,
        "card": card,
        "cublas_bf16_reduced_precision_reduction": flag,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
