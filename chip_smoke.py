#!/usr/bin/env python
"""Drives the PyTorch port (``mquant_tpu_torch``) on one NVIDIA GPU.

Phases, in order (any failed check raises and the script exits non-zero):

1. device: needs CUDA; prints the card's name and power limit.
2. build: compiles the CUDA kernels from ``mquant_tpu_torch/kernels/csrc``
   and counts the tensor-core products and shared-memory copies in the SASS
   of the tensor-core kernels: wgmma (``IGMMA`` / ``HGMMA``) and TMA
   (``UTMALDG``) in the GEMM (the ragged instantiations' too: x's tiles)
   and flash kernels, ``IMMA`` and ``UTMALDG`` in
   the W4 GEMV (each of w4_unpack_gemv's P0-P3 instantiations too, their
   counts printed beside the served unpack's), ``HMMA`` and ``UTMALDG`` or
   cp.async ``LDGSTS`` in w8_bf16_gemv's (with its consumer loop's
   instructions per weight byte), ``HMMA`` and cp.async
   (``LDGSTS``) in decode attention, ``HGMMA`` and the bulk copy
   (``UBLKCP``) in the Hadamard tail kernel and in fwht's (fails without
   them).
3. kernels: each kernel against its plain PyTorch version at the shapes of
   the main path: int32 accumulators and bf16 outputs bit-equal (the int8
   GEMM through its route: the TMA kernel inside its contract, K = 18943 of
   the RMS split included (x in rows padded to 16 bytes, as the split's
   quantizer writes them), the ragged kernel (W's tile written by threads)
   outside: ragged N, W4 with (K/2) % 16 != 0 and the full-logit lm_heads
   of InternVL2-8B (N = 92553) and MiniCPM-V-2.6 (N = 151666), its
   main-path shapes; the ragged kernel also timed at each TMA shape beside
   the TMA kernel; InternVL2-8B's products (the W4 GEMV at 1 and 8 rows,
   the split ``down`` at K = 14335 on the int8 GEMV and GEMM, the T = 1024
   prefill, the ViT's and mlp1's W8 products) and its decode attention at
   G = 4, summed apart; GLM-4V-9B's decode attention at G = 16 (one
   request's first and last steps and the engine's 8 rows over a 1280-row
   cache whose columns ≥ pos are NaN), summed apart; Qwen-VL-Chat's
   products (the W4 GEMV at 1 and 8 rows, the split ``down`` at K = 11007
   on the int8 GEMV and GEMM, the int8 head at N = 151936, the T = 1024
   prefill) and its decode attention at G = 1 (32 KV heads), summed
   apart; MiniCPM-V-2.6's int8 head at N = 151666 beside
   ``torch._int_mm`` (its other products are the 7B rows'); the document
   path's
   4096-row products; the prefill probe's W8 products; the W4 GEMV at 1, 4, 8
   and 32 token rows; the int8 GEMV at the engine's 8 rows of path S's `down`
   (main path), at 32 rows, the int8 lm_head at 8 rows, the decode
   lm_heads of InternVL2-8B and MiniCPM-V-2.6 at 1 and 8 rows and K tails
   at N % 16 = 8, N odd and N % 16 = 0 with x rows off 4-byte alignment,
   its f32 output bit-equal too); the attention
   kernels' written cache rows bit-equal and outputs within 1e-2 of the
   plain version's largest magnitude, with cache columns outside [start,
   pos) poisoned; the fused swiglu → Hadamard → int8 tail's codes within ±1
   with at most 1% of them differing (the fraction printed; bf16 and f32
   rows, g and u as the halves of one gate|up row, a token count that is no
   multiple of the persistent grid, GLM-4V-9B's padded n = 13824 with
   K = 108, where ``had_quant`` and ``fwht_two_matmul`` are held too);
   device time per
   call of kernel, plain version and, where one exists, the one PyTorch call
   that computes the same function (``torch._int_mm``; SDPA, over only the
   cache columns the kernel reads where start and pos are one value, masked
   over the whole cache where they are per row), by CUDA-graph
   replay with L2-cold weights / caches (median of replays), beside the
   least time the card could take (bytes over 3.35 TB/s or operations over
   the dense peak); the unfused torch chain of the tail is timed beside it.
   The port's bf16 products outside the kernels (the einsum attention's
   P·V at T = 1024, the fp-mode patch embed) with cuBLAS's reduced-precision
   bf16 reduction on and off: bit-equal or not (ROADMAP C-w11).
   The prefill probe's kernels likewise (rms_norm_quant: codes within ±1,
   at most 1e-3 differing; had_quant: the tail's rule; fwht_two_matmul:
   f32 within 1e-5 of the plain version's largest magnitude, bf16 within
   one ulp plus that), each beside its unfused torch chain. The decode
   probes' kernels likewise (w8_bf16_gemv: bf16 within one ulp plus 1e-5
   of max |plain|, and deterministic, N % 16 = 8 included; w4_unpack_gemv
   P0-P3: int32
   bit-equal, P1-P3 also to w4a8_gemv's, each timed beside w4a8_gemv at
   the same shape; dequant_swiglu_had_quant: the tail's rule, codes in
   [−127, 127]). The group-blocked epilogue (``group_epilogue``) at path
   A's nine shapes: f32 accumulator and bf16 output bit-equal, timed with
   its inputs cycled through copies beyond the L2; then on the strided
   views ``qmm._blockdiag_partials`` gives it at 1 and 8 rows (the int32
   partials and Σw equal to the exact dots, the outputs bit-equal).
4. probes: the T = 1024 prefill probe at 7B widths
   (``mquant_tpu_torch.scripts.prefill_probe``: every segment, device ms per
   step of a chain of 16 in one CUDA graph; each fused segment against its
   unfused twin) and the int8 rate probe (``scripts.mxu_rate``: int32
   output bit-equal to ``torch._int_mm``'s), counted as one path that must
   launch rms_norm_quant, had_quant, fwht_two_matmul, the fused tail,
   int8_gemm and flash attention. Then the three decode-rate probes
   (``scripts.gemv_bench``, ``scripts.w4_unpack_tune``,
   ``scripts.mlp_variants`` at T = 1024 with the epilogue prototypes),
   counted as one path that must launch w8_bf16_gemv, w4_unpack_gemv,
   dequant_swiglu_had_quant, int8_gemm, int8_gemv and w4a8_gemv; each
   probe's kernel line held against its torch twin.
   golden: the JAX package's greedy decode at Qwen2-VL-7B widths
   (``mquant_tpu_torch/golden/qwen2vl7b.json``, written on the CPU by
   ``tests/test_torch_golden.py --write``): its weights drawn on the host
   with numpy and moved to the card, each path (block, F, S) at each depth
   of the file, and the storage paths K8 (block over int8 KV) and A
   (config A's storage) at depth 1, serving the full-VLM request (2 of 32
   ViT blocks); then the files of InternVL2-8B, GLM-4V-9B, Qwen-VL-Chat
   and MiniCPM-V-2.6 (``golden/{internvl2_8b,glm4v_9b,qwenvl_chat,
   minicpmv_2_6}.json``, ``--write --family NAME``: published widths, the
   LLM at depth 1, the float tower cut to 2 blocks, the block path's W4A8
   decoder with the int8 head, a 448² image request; their weights drawn
   two families at a time on host threads from the phase's start),
   each entry through ``generate_on_device`` with each step's logits kept,
   held by ``golden.hold`` (digests equal, top-16 logits within 1e-2 of
   each step's largest, tokens equal up to a near tie the runs break
   apart), counted as one path.
   slice: Qwen2-VL-7B at full width and depth 28 with seeded random W4A8
   weights (W8A8 vision tower) serves one full-VLM request (448² image →
   ViT → merger → splice → 1024-token prompt → 128 greedy tokens) and two
   text requests through ``serve.generate.Generator``; then (a) a document
   request (896² image → 4096 ViT rows → 1024 image tokens in a 4096-token
   prompt with M-RoPE positions → 128 greedy tokens: the flash prefill and
   decode attention over a 4096-row cache) and (b) a ragged batch
   (``Generator.generate_batch``: 4 text prompts of 300, 77, 1000 and 513
   tokens, left-padded to 1024, 64 tokens each), each row held against
   itself served alone through the first CMP_LAYERS layers (prefill
   logits within the bound, the first 8 tokens equal). Each of the three
   paths runs with the launch counts set to 0 just before it and must
   launch every kernel it reaches. Decode runs in ``serve.generate``'s
   decode loop: one greedy step captured in a CUDA graph and replayed
   once a token; the launch counts grow by the captured step's launches a
   replay (``serve.generate.Graphed``), so they count what ran.
   Then, on the same weights cut to their first FS_DEPTH = 4 layers (28
   until the tp phase came, which holds both routes sharded), the full
   online Hadamard before ``down``
   (hadK ⊗ H₁₂₈ over 18944): path F serves the full-VLM request and a
   77-token text request of two tokens on the default route (the unfused
   chain, JAX's default: no tail launch), then the request's 1024-token
   prefill with ``MQUANT_FUSED_TAIL=1`` (the fused tail kernel, one launch
   a layer, each call held against its plain version);
   path S adds the RMS first-column split (``down`` as 18943 int8 rows +
   an f32 ``w_col0``: ``int8_gemm`` / ``int8_gemv`` at K = 18943) and
   serves the full-VLM request; its prefill's ``down`` calls (one a layer)
   must launch the TMA kernel (``int8_gemm``) and ``int8_gemm_ragged``
   none, an eager decode step's one ``int8_gemv`` a layer, and the request
   one more a step for the head and one for the prefill's head; then the
   same prefill with ``down``
   forced onto ``int8_gemm_ragged`` (28 launches) is held against plain as
   below.
   Then the artifact (``run_artifact``): path S's weights in the JAX
   pipeline's artifact layout (W4 codes one per int8 byte, the split
   ``down``, an fp bf16 lm_head, a float bf16 ViT and merger with static
   activation scales, ``default_w4a8_specs`` and the config dict) written
   with ``utils.checkpoint.save_artifact`` to a temporary directory (its
   bytes, seconds and the free disk space printed), loaded by
   ``serve.server.build_runner_from_artifact(dir, device="cuda")`` and
   served through the ``VLMRunner``: one request (a 448² image in a
   1024-token prompt, 128 tokens; its seconds, TTFT and decode tok/s beside
   path S's) and a ``generate_batch`` of three prompts (two with images),
   counted (it must launch w4a8_gemv, int8_gemv, int8_gemm and
   attn_decode); the request's tokens and last-step logits equal (max |d|
   0) to the same runner built on the in-memory trees, the packed W4 bytes
   equal to path S's, each batch row held against itself alone as the
   ragged batch's rows are.
   Then, before the artifact's directory goes, the engine (``run_engine_
   phase``): ``serve.server.build_server_from_artifact(dir, device="cuda",
   slots=8, max_len=2048, steps_per_block=8, sample_top_k=64, seed=0)``
   (the CLI's values) on localhost, the pool grown to 1280 rows and
   poisoned with NaN, a 256-id prefix registered, the admissions and the
   decode block warmed (``attn_decode`` captured with the (8,) per-row
   positions), then a burst of 16 concurrent HTTP requests from 16 client
   threads, counted: 4 image chats (a 448² PNG in an ``image_url`` part,
   built with ``utils.png`` without PIL) and 12 id completions of 77, 300,
   513 and 1000 tokens (two 300-token ones behind the prefix), 64 or 128
   tokens each, 4 sampled (one with a frequency penalty), one streamed and
   one whose client hangs up after its first chunk. Every request equal to
   itself sent alone afterwards (greedy tokens; sampled ones by seed; the
   stream's deltas), the hung-up request cancelled and no slot active,
   2 prefix hits, it must launch w4a8_gemv, int8_gemv, int8_gemm and
   attn_decode; one decode block (8 steps, 8 live rows) against the same
   block with the integer products plain (last-step logits max |d| 0,
   tokens equal; its ``int8_gemv`` items: ms and calls); each product and
   reduction of a decoder layer, the head and the logprob at a speculative
   verify window of 4 × 8 rows against 4 calls at 8 rows (bits equal or
   not; the integer products must be equal: ``verify_sites``, ROADMAP
   C-w18); then the burst's greedy id completions again, at once, on a
   ``--spec_k 3`` server over the same runner (a pool of the same shape,
   the prefix registered): every token equal to the burst's, the pass's
   seconds, tok/s and acceptance; one JSON line: the burst's seconds and
   generated tok/s, TTFT and latency p50 / p90 (the server's ``_Pending``
   stamps), the block's wall, stream time and device busy
   (torch.profiler) with the idle share, slot occupancy, graphs, peak GiB,
   the speculative pass's numbers, the card.
   Then the storage phase (``run_storage_phase``, after the batch path;
   the block path cut to STORAGE_DEPTH = 4 of its 28 layers (8 from the
   MiniCPM-V phase's coming to the long context phase's): path A (float bf16 decoder weights
   fake-quantized on asym W4 grids per 128-row group of each layer's rows
   in a seeded permutation, static asym
   per-tensor int8 activations calibrated on the request, realized by
   ``realize_decoder_weights``: every decoder site on the group-blocked
   epilogue, ``group_epilogue`` launched; held at all its layers against
   the same forward with only the int32 group accumulators (``int8_gemv``
   / ``int8_gemm``) plain, logits equal), path B (per-channel asym activations folded into the
   weights, ``a_fold`` / ``a_corr``) and the block path over int8 (K8) and
   int4 (K4) KV (no ``attn_decode`` launch; the first layer's cache write
   bit-equal to the plain write), each serving the full-VLM request,
   counted, against plain qmm and through the graph loop against the
   eager loop; K8 and K4 also through an 8-slot engine pool of that KV
   (1280 rows, every tensor poisoned, a 256-id prefix registered): a
   burst of 4 id prompts and 2 behind the prefix, each equal to itself
   sent alone, 2 prefix hits, then the same burst at ``spec_k 3`` with
   equal tokens, counted. One line per path (request s, TTFT, decode
   tok/s, graph step ms, path block's beside them) and the pool bytes of
   bf16, int8 and int4 KV; one ``{"storage_phase": ...}`` JSON line.
   Each path's prefill and first 7 decode steps are held against the same
   forward with the integer products through their plain versions (logits
   within the bound, greedy tokens equal), and every attention and tail
   kernel call against its plain version on the call's own inputs.
   Then the long context (``run_longctx``, phase 4 (d), on the same
   block-path model at depth 28, scripts/longctx_bench.py's cell in the
   port): a prompt of 16000 seeded ids prefilled by
   ``Generator.prefill_chunked`` in 2048-row chunks (seven and a 1664-row
   tail) against the cache, written into the graph loop's NaN-poisoned
   buffers, then 32 greedy tokens through the graph loop, counted (it must
   launch w4a8_gemv, int8_gemv, int8_gemm and attn_decode): the chunked
   prefill's wall (best of 2), each chunk's device ms and its attention's
   share, its peak allocated memory beside the one-piece prefill's (flash,
   padded to the 16384 bucket: phase 3 holds the flash kernel at T =
   16384 against its plain version, a head at a time), decode tok/s at
   position ~16000; held against the same run with the integer products
   plain (last logits max |d| 0, tokens equal), the graph loop against the
   eager loop (tokens equal, last-step logits max |d| 0), and, with the
   LLM cut to 2 layers, by ``golden.hold``'s top-16 rule on the einsum
   route: 2048-row pieces against 8192-row pieces of the whole prompt and
   against one piece at its first 4096 ids (against the flash one piece,
   and flash's one piece against the einsum's, compared and printed:
   ROADMAP C-w6).
   Graph decode, on the block, F and S paths (every KV buffer of the
   loops poisoned with NaN before each request, ROADMAP C-w1): the
   full-VLM request through the decode loop's graph against the eager
   loop ``Generator._decode_loop`` (128 tokens equal, last-step logits
   max |d| 0), and a 2-row ``generate_batch`` with an eos id at which the
   rows stop at different steps (tokens equal); the graph step's wall and
   stream ms (CUDA events) and its device busy ms under torch.profiler.
   Then, with the model above freed, the pipeline (``run_pipeline_phase``):
   the port's ``run_pipeline`` quantizes Qwen2-VL-7B (published widths,
   depth PIPE_DEPTH = 2, seeded random weights) in the reference's headline W4A8
   configuration (rotations, full online Hadamard before ``down``, RMS
   split, GPTQ W4 with act_order on 32 synthetic batches of a 448² image
   and 32 text tokens, RTN W8 vision tower and merger, static int8
   activations, ``realize_int``) into a temporary artifact: each stage's
   seconds and peak memory, the GPTQ time split; no RTN fallback, GPTQ's
   proxy loss tr(ΔWᵀ H ΔW) no worse than round-to-nearest's on every
   site, lossless realization, the walk's CUDA-graph blocks bit-equal to
   the eager walk; the artifact loaded by ``build_runner_from_artifact``
   serves one 448² image request (1024-token prompt, 128 tokens), counted
   (``down`` at K = 18943 on the TMA GEMM, a call a layer) and held against
   the plain integer products (``against_plain``).
   Then InternVL2-8B (``run_internvl_phase``): ``run_pipeline("InternVL2-8B")``
   at the published widths (InternViT 24 layers with learned positions and
   LayerScale, pixel shuffle + mlp1, the InternLM2 decoder cut to
   IVL_DEPTH = 2 of its 32 layers (8 from the GLM-4V phase's coming to
   the MiniCPM-V phase's):
   GQA 32 / 8, intermediate 14336 = 28 · 512, vocabulary 92553), seeded
   random weights drawn on the card, the headline W4A8 flags (the full
   online Hadamard hadK₂₈ ⊗ H₅₁₂ before ``down``, RMS split, GPTQ W4 with
   act_order on 8 synthetic batches of a 448² image, 1/16 of the
   reference's 128, RTN W8 ViT and mlp1) with an int8 lm_head, realized,
   into a temporary artifact: stage seconds and peaks, no RTN fallback,
   GPTQ's proxy loss no worse than round-to-nearest's, lossless
   realization; served by ``build_runner_from_artifact``: one request (a
   448² image in a 1024-token prompt, 128 tokens), counted (``down`` at
   K = 14335 on the TMA ``int8_gemm`` a layer; ``int8_gemv`` for ``down``
   and the head at N = 92553 every step), held against the plain integer
   products (logits max |d| 0, tokens equal), its graph decode loop
   against the eager loop (the step's wall, stream and busy ms); a
   ``ServingEngine`` burst of 4 id prompts (77, 300, 513, 1000 ids, 16
   tokens each), counted, each equal to itself sent alone; ``python -m
   mquant_tpu_torch.quant_vlm --model InternVL2-8B --tiny`` on the card
   with the headline flags and visual GPTQ (exit 0, no RTN fallback).
   Then GLM-4V-9B (``run_glm4v_phase``) the same way (``family_phase``):
   the published widths (the EVA2CLIP tower, 63 layers × 1792, neither
   fused nor rotated; the GLU projector with boi / eoi; ChatGLM cut to
   GLM_DEPTH = 2 of its 40 layers (8 until the MiniCPM-V phase), MQA 32 / 2
   heads, half-width interleaved rotary, intermediate 13696 padded to
   13824 = 108 · 128 by the full online Hadamard, vocabulary 151552),
   seeded random bf16 weights drawn on the card; the request's decode
   steps must launch ``attn_decode`` at G = 16 a layer (none on the
   einsum), ``int8_gemv`` for ``down`` at K = 13823 and the head at
   N = 151552; the launches a decode step printed; ``quant_vlm --model
   GLM-4V-9B --tiny`` on the card with visual GPTQ (the GLU projector's
   five sites included). Then Qwen-VL-Chat (``run_qwenvl_phase``) the
   same way: the published widths (the CLIP-style tower, 48 layers ×
   1664 with ln_pre, ``fc_sub_mean`` and ln_post; the attn_pool
   resampler, 256 queries, width 4096; the Qwen decoder cut to QVL_DEPTH
   = 2 of its 32 layers, 32 / 32 heads, intermediate 11008 = 172 · 64
   under the full online Hadamard's order-172 block, vocabulary 151936);
   its decode steps must launch ``attn_decode`` at G = 1 a layer,
   ``int8_gemv`` for ``down`` at K = 11007 and the head at N = 151936;
   ``quant_vlm --model Qwen-VL-Chat --tiny`` on the card with visual
   GPTQ (the resampler's six sites included). Then MiniCPM-V-2.6
   (``run_minicpmv_phase``) the same way: the published widths (the
   SigLIP tower, 27 layers × 1152, 16 heads of 72, the tanh GELU, 4900
   learned positions and post_layernorm; the resampler, 64 queries,
   width 3584; the Qwen2 decoder cut to MCPM_DEPTH = 4 of its 28 layers
   (8 until the long context phase came),
   28 / 4 heads, intermediate 18944, vocabulary 151666); its decode steps
   must launch ``attn_decode`` at G = 7 a layer, ``int8_gemv`` for
   ``down`` at K = 18943 and the head at N = 151666; then A6 on the card
   (``run_pad_check``): a 300 × 600 image served by a runner that pads
   every patch sequence to its largest bucket's (the 448 × 896 bucket's
   2048 patches padded to 4096, the mask through the tower's and the
   resampler's einsum attention): its features and 8 full-depth tokens
   bit-equal with noise in place of the zero padding; against the same
   image unpadded, the float vision path through one tower block within
   the bound; the decoder's logits and tokens on those, the whole tower's
   features and the full-depth tokens compared and printed; ``quant_vlm
   --model MiniCPM-V-2_6 --tiny`` on the card with visual GPTQ (the
   resampler's six sites included).
   Then the offline pipeline from an HF checkpoint
   (``run_checkpoint_phase``), at depth CKPT_DEPTH = 2 (28 until the
   InternVL phase came, 14 until the GLM-4V phase did, 4 until the long
   context phase and the other families' golden entries did; the
   calibration CKPT_BATCHES = 8 batches, 16 until then): seeded random
   bf16 weights written as a sharded HF checkpoint (HF names, the fused
   visual qkv, the conv3d patch embed, an index) by
   ``models.loader.save_qwen2vl_hf`` with the port's safetensors writer
   (bytes, seconds, free disk);
   ``run_pipeline(model_dir=...)`` with SmoothQuant (alpha 0.5), the
   online-Hadamard gate, the head gate, auto bits (5.0), visual GPTQ (patch
   embed, 32 blocks, merger) and the LLM's GPTQ W4 with act_order,
   realized, with an artifact: the loaded tree equal leaf for leaf to the
   drawn one (digests printed), each stage's seconds and peak memory, the
   Hadamard pick and its errors, the head pick and its ratios, the
   allocation report, both GPTQ reports (no RTN fallback); the params and
   state exported as safetensors and read back onto the card with
   ``import_safetensors`` (every leaf equal; bytes and seconds); one 448²
   image request served from the artifact, counted (it must launch
   int8_gemm, int8_gemv, attn_decode and, where a layer site is W4,
   w4a8_gemv) and held against the plain integer products. Then the
   evaluation harness on that runner (``run_eval_phase``, counted): MMBench (circular), MME
   and DocVQA TSVs the phase writes with PNG images at 448² and 224×448,
   and SyntheticVQA, through ``evaluation.eval.eval_dataset`` single and
   through ``engine_server(slots=8)``, 16 tokens a row: metrics finite and
   in range, shards merged equal, each batched row equal to itself alone
   through the engine, ``runner_judge`` on the MCQ rows exact matching
   misses; rows/s and tok/s single against batched; then
   ``run_pipeline(calib_dataset=<the MCQ TSV>)`` at 7B widths cut to
   EVAL_CALIB_DEPTH = 2 layers through GPTQ (no RTN fallback). Random weights: no accuracy is
   claimed. Last, GPTQ at 7B widths and STREAM_DEPTH = 2 layers (4 until
   the long context phase came) resident,
   with ``stream_from_host`` and with ``realize_on_device`` too
   (``run_stream_check``): weights bit-equal, realized codes equal to the
   post-hoc realization, lower device peaks; and ``python -m
   mquant_tpu_torch.quant_vlm --tiny`` on the card with every flag of
   those options, ``--model_dir`` (a tiny checkpoint the phase writes) and
   ``--export_safetensors`` (``cli_check``, a child process started
   beside the evaluation phase and collected after the stream check; each
   family phase's ``quant_vlm --tiny`` likewise runs beside its phase).
   Each directory is deleted as soon as it has been read.
5. profile: wall time (best of 3) and, under ``torch.profiler``, device
   busy time, idle share and the largest device items of the vision tower,
   the 1024-token prefill and a decode step (block Hadamard, then path F's,
   then path S's prefill, beside it with ``down`` forced onto the ragged
   kernel, and its decode step), then of the
   4096-token prefill and a decode step at position ~4100; and the stream
   time between CUDA events around
   every ``layers.attention`` call. For each decode step (the eager step,
   where the profiler sees every kernel): device operations per step, the
   wrappers' calls per step, and device launches per W4 GEMV and per
   attention call (one each).
6. bench: ``mquant_tpu_torch.bench.main`` (W4A8 against bf16 at depth 28:
   the lm_head gate, chained TTFT, decode tok/s of the decode loop, the
   LLM and full-VLM requests, the rooflines; best of BENCH_ITERS = 2, 3
   until the long context phase came), its JSON on a line of its own.

The tp phase (``run_tp_phase``, right after phase 3): tensor parallelism
(``mquant_tpu_torch.parallel``) at tp = 2, two ranks spawned on this card
(gloo over a file store: NCCL refuses two ranks on one device), each
drawing the same seeded Qwen2-VL-7B (published widths, TP_DEPTH = 4 of 28
decoder layers, TP_VIT_DEPTH = 4 of 32 ViT blocks, block-path W4A8 with the
int8 head, W8A8 tower and merger) and serving its shard; rank 0 also
serves the whole model. Holds: (a) the full-VLM request's 32 tokens equal
and its last-step logits within one bf16 ulp (and a 2048-id text
prefill through the flash kernel at 14 heads), (b) paths F and S, one
1024-token prefill and 8 steps each, (c) a four-prompt engine burst (77,
300, 513 and 1000 ids, 16 tokens each) equal to the whole model's engine,
(d) ``gptq_matrix_sharded`` on one 7B ``down`` (18944 × 3584, 256
calibration rows a rank through ``hessian_dp``): codes, scales and the
act_order permutation bit-equal to the single-rank walk on the same H.
Each rank's launch counts and the shapes its kernels ran at are printed,
with wall times of two ranks time-sharing one card (not tensor-parallel
speed); decode steps run eagerly under the mesh. Both ranks' counts join
the kernel table's.

Last line of stdout: {"ok": true, "device": {...}}. Usage:
``python3 chip_smoke.py [--seed 0]``; ``--phase NAME`` builds the
kernels and runs only the phase NAME (pipeline, internvl, glm4v, qwenvl,
minicpmv, checkpoint, longctx or golden with its LLM uncut; tp as in the
whole script), and prints no result line.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time


from mquant_tpu_torch.scripts.timing import card_line, cuda_ms


_BESIDE: list = []  # the Child processes whose with block is open


def log(*a):
    if _BESIDE:  # a time in this line shared the card with the child
        a = (*a, f"[shared card: {len(_BESIDE)} quant_vlm child process "
                 "beside this phase]")
    print(*a, flush=True)


def bf16_ulp_err(a, b) -> tuple[float, float]:
    """(max |a − b|, max |a − b| in units of the bf16 ulp at max(|a|, |b|))."""
    import torch

    a = a.float()
    b = b.float()
    d = (a - b).abs()
    mag = torch.maximum(a.abs(), b.abs()).clamp(min=2.0**-126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(d.max()), float((d / ulp).max())


# (kernel, label, M, K, N, packed W4); the main path's shapes at 7B widths
KERNEL_SHAPES = [
    ("w4a8_gemv", "decode q|k|v", 1, 3584, 4608, True),
    ("w4a8_gemv", "decode o", 1, 3584, 3584, True),
    ("w4a8_gemv", "decode gate|up", 1, 3584, 37888, True),
    ("w4a8_gemv", "decode down", 1, 18944, 3584, True),
    ("int8_gemv", "decode lm_head", 1, 3584, 152064, False),
    ("int8_gemm", "prefill q|k|v", 1024, 3584, 4608, True),
    ("int8_gemm", "prefill o", 1024, 3584, 3584, True),
    ("int8_gemm", "prefill gate|up", 1024, 3584, 37888, True),
    ("int8_gemm", "prefill down", 1024, 18944, 3584, True),
    ("int8_gemm", "vit q/k/v/o", 1024, 1280, 1280, False),
    ("int8_gemm", "vit fc1", 1024, 1280, 5120, False),
    ("int8_gemm", "vit fc2", 1024, 5120, 1280, False),
    ("int8_gemm", "merger mlp0", 256, 5120, 5120, False),
    ("int8_gemm", "merger mlp2", 256, 5120, 3584, False),
    ("int8_gemv", "S decode down", 1, 18943, 3584, False),
    # the engine's pool step: path S's `down` at 8 slots
    ("int8_gemv", "engine S down, 8 rows", 8, 18943, 3584, False),
    ("int8_gemm", "S prefill down", 1024, 18943, 3584, False),
    # the prefill probe's W8 products (s8mm): q, k / v, fused q|k|v, g / u,
    # fused gate|up, down
    ("int8_gemm", "probe q W8", 1024, 3584, 3584, False),
    ("int8_gemm", "probe k / v W8", 1024, 3584, 512, False),
    ("int8_gemm", "probe q|k|v W8", 1024, 3584, 4608, False),
    ("int8_gemm", "probe g / u W8", 1024, 3584, 18944, False),
    ("int8_gemm", "probe gate|up W8", 1024, 3584, 37888, False),
    ("int8_gemm", "probe down W8", 1024, 18944, 3584, False),
]
# the document path's products at its 4096-token prefill and 4096-row ViT
# (main path, held and timed, outside the 1024-token sums that earlier runs
# give)
DOC_GEMM_SHAPES = [
    ("int8_gemm", "doc prefill q|k|v", 4096, 3584, 4608, True),
    ("int8_gemm", "doc prefill o", 4096, 3584, 3584, True),
    ("int8_gemm", "doc prefill gate|up", 4096, 3584, 37888, True),
    ("int8_gemm", "doc prefill down", 4096, 18944, 3584, True),
    ("int8_gemm", "doc vit q/k/v/o", 4096, 1280, 1280, False),
    ("int8_gemm", "doc vit fc1", 4096, 1280, 5120, False),
    ("int8_gemm", "doc vit fc2", 4096, 5120, 1280, False),
    ("int8_gemm", "doc merger mlp0", 1024, 5120, 5120, False),
]
# the W4 GEMV at several token rows (_qmm_pallas_w4's M <= 32 branch): the
# ragged batch decodes 4 rows; 8 and 32 are the contract's n8 tiles. Held and
# timed, summed apart from the 1-token decode shapes (PERF.md's row 2)
ROWS_SHAPES = [("w4a8_gemv", f"{site}, {m} rows", m, k, n, True)
               for m in (4, 8, 32)
               for site, k, n in (("gate|up", 3584, 37888),
                                  ("down", 18944, 3584))]
# off the 1-token decode path but inside the kernels' contract: several rows
# in the GEMV, ragged M, N and K edges in the GEMM (N odd, N % 4 = 2 and
# W4 with (K/2) % 16 != 0 on the ragged kernel)
EDGE_SHAPES = [
    ("w4a8_gemv", "q|k|v, 5 rows", 5, 3584, 4608, True),
    ("int8_gemv", "lm_head, 3 rows", 3, 3584, 152064, False),
    ("int8_gemm", "ragged W8", 333, 1280, 1000, False),
    ("int8_gemm", "ragged W4", 77, 3584, 4100, True),
    ("int8_gemm", "ragged K W8", 77, 1001, 1000, False),
    ("int8_gemm", "ragged K W8, N % 16 = 0", 77, 1001, 1024, False),
    ("int8_gemm", "ragged K W8, N odd", 77, 1001, 1003, False),
    ("int8_gemm", "W4 (K/2) % 16 = 4", 77, 1000, 1024, True),
]
# the int8 GEMV off the main path, inside its contract (any K and N, M <=
# 32): `down` at the last n8 tile, the int8 lm_head of an 8-slot engine on
# an lm_head_bits=8 artifact, the decode lm_heads of InternVL2-8B (N odd)
# and MiniCPM-V-2.6 (N = 2 mod 16: the producer's word loads), K tails at
# N % 16 = 8 (cp.async), N odd and N % 16 = 0 with x rows 1 byte off
# alignment
I8_GEMV_SHAPES = [
    ("int8_gemv", "S down, 32 rows", 32, 18943, 3584, False),
    ("int8_gemv", "lm_head, 8 rows", 8, 3584, 152064, False),
    ("int8_gemv", "InternVL2-8B lm_head", 1, 4096, 92553, False),
    ("int8_gemv", "InternVL2-8B lm_head, 8 rows", 8, 4096, 92553, False),
    ("int8_gemv", "MiniCPM-V-2.6 lm_head", 1, 3584, 151666, False),
    ("int8_gemv", "MiniCPM-V-2.6 lm_head, 8 rows", 8, 3584, 151666, False),
] + [("int8_gemv", f"K tail, unaligned x, {m} rows", m, k, n, False)
     for m in (3, 5) for k, n in ((1001, 1000), (1001, 1003), (3584, 1024))]
# the ragged kernel's main-path shapes: the full-logit lm_head (calibration,
# scoring, speculative verification: decoder_forward with every position's
# logits) over a 1024-token prompt at the published vocabularies, N % 16 != 0
RAGGED_SHAPES = [
    ("int8_gemm", "InternVL2-8B lm_head", 1024, 4096, 92553, False),
    ("int8_gemm", "MiniCPM-V-2.6 lm_head", 1024, 3584, 151666, False),
]
# InternVL2-8B's shapes (hidden 4096, GQA 32 / 8, intermediate 14336 =
# 28 · 512, vocab 92553): the W4 decode products at 1 and 8 rows (the
# engine's), the split `down` at K = 14335 on the int8 GEMV, the prefill
# products at T = 1024 (the split `down`'s x in rows padded to 16 bytes),
# block mode's W4 `down` at K = 14336, and the ViT's (K = 1024) and mlp1's
# (K = 4096) products at W8. Held and timed in phase 3, summed apart from
# the 7B rows (the InternVL phase's own numbers are its request's)
IVL_SHAPES = [
    *[(k, f"IVL {site}, {m} rows", m, kk, n, packed)
      for m in (1, 8)
      for k, site, kk, n, packed in (
          ("w4a8_gemv", "decode q|k|v", 4096, 6144, True),
          ("w4a8_gemv", "decode o", 4096, 4096, True),
          ("w4a8_gemv", "decode gate|up", 4096, 28672, True),
          ("w4a8_gemv", "block decode down", 14336, 4096, True),
          ("int8_gemv", "S decode down", 14335, 4096, False))],
    ("int8_gemm", "IVL prefill q|k|v", 1024, 4096, 6144, True),
    ("int8_gemm", "IVL prefill o", 1024, 4096, 4096, True),
    ("int8_gemm", "IVL prefill gate|up", 1024, 4096, 28672, True),
    ("int8_gemm", "IVL S prefill down", 1024, 14335, 4096, False),
    ("int8_gemm", "IVL block prefill down", 1024, 14336, 4096, True),
    ("int8_gemm", "IVL vit q|k|v", 1024, 1024, 3072, False),
    ("int8_gemm", "IVL vit o", 1024, 1024, 1024, False),
    ("int8_gemm", "IVL vit fc1", 1024, 1024, 4096, False),
    ("int8_gemm", "IVL vit fc2", 1024, 4096, 1024, False),
    ("int8_gemm", "IVL mlp1 fc1 / fc2", 256, 4096, 4096, False),
]
# Qwen-VL-Chat's shapes (hidden 4096, 32 / 32 heads, intermediate 11008 =
# 172 · 64, vocab 151936): the W4 decode products at 1 and 8 rows, the
# split `down` at K = 11007 and the int8 head on the int8 GEMV, the
# prefill products at T = 1024 (the split `down`'s x in rows padded to 16
# bytes). Held and timed in phase 3, summed apart like IVL_SHAPES
QVL_SHAPES = [
    *[(k, f"QVL {site}, {m} rows", m, kk, n, packed)
      for m in (1, 8)
      for k, site, kk, n, packed in (
          ("w4a8_gemv", "decode q|k|v", 4096, 12288, True),
          ("w4a8_gemv", "decode o", 4096, 4096, True),
          ("w4a8_gemv", "decode gate|up", 4096, 22016, True),
          ("int8_gemv", "S decode down", 11007, 4096, False))],
    ("int8_gemv", "QVL lm_head, 1 rows", 1, 4096, 151936, False),
    ("int8_gemm", "QVL prefill q|k|v", 1024, 4096, 12288, True),
    ("int8_gemm", "QVL prefill o", 1024, 4096, 4096, True),
    ("int8_gemm", "QVL prefill gate|up", 1024, 4096, 22016, True),
    ("int8_gemm", "QVL S prefill down", 1024, 11007, 4096, False),
]
# MiniCPM-V-2.6's products are Qwen2-VL-7B's (hidden 3584, 28 / 4 heads,
# intermediate 18944: the main path's KERNEL_SHAPES) but for its decode
# head, the int8 GEMV at N = 151666 (N % 8 = 2: the word producer). Held,
# timed and summed apart like IVL_SHAPES, torch._int_mm beside it
MCPM_SHAPES = [
    ("int8_gemv", "MCPM lm_head, 1 rows", 1, 3584, 151666, False),
]
REPLACES = {
    "w4a8_gemv": "mquant_tpu/kernels/qmm.py:869",
    "int8_gemv": "mquant_tpu/kernels/qmm.py:637",
    "int8_gemm": "mquant_tpu/kernels/qmm.py:840, scripts/mxu_rate.py:90",
    "int8_gemm_ragged": "mquant_tpu/kernels/qmm.py:840",
    "attn_decode": "mquant_tpu/kernels/attn_decode.py:206",
    "flash_attn_causal": "mquant_tpu/models/layers.py:385",
    "fused_swiglu_had_quant": "mquant_tpu/kernels/fwht.py:320",
    "rms_norm_quant": "mquant_tpu/kernels/fwht.py:246",
    "had_quant": "mquant_tpu/kernels/fwht.py:187",
    "fwht_two_matmul": "mquant_tpu/kernels/fwht.py:122",
    "w8_bf16_gemv": "scripts/gemv_bench.py:70",
    "w4_unpack_gemv": "scripts/w4_unpack_tune.py:115",
    "dequant_swiglu_had_quant": "scripts/mlp_variants.py:180",
    # an XLA scan, not a Pallas kernel: the grouped / zero-point epilogue
    "group_epilogue": "mquant_tpu/kernels/qmm.py:407",
}
SOURCES = {"w4a8_gemv": "mquant_tpu_torch/kernels/csrc/qmm.cu",
           "int8_gemv": "mquant_tpu_torch/kernels/csrc/qmm.cu",
           "int8_gemm": "mquant_tpu_torch/kernels/csrc/qmm.cu",
           "int8_gemm_ragged": "mquant_tpu_torch/kernels/csrc/qmm.cu",
           "attn_decode": "mquant_tpu_torch/kernels/csrc/attn.cu",
           "flash_attn_causal": "mquant_tpu_torch/kernels/csrc/attn.cu",
           "fused_swiglu_had_quant": "mquant_tpu_torch/kernels/csrc/fwht.cu",
           "rms_norm_quant": "mquant_tpu_torch/kernels/csrc/fwht.cu",
           "had_quant": "mquant_tpu_torch/kernels/csrc/fwht.cu",
           "fwht_two_matmul": "mquant_tpu_torch/kernels/csrc/fwht.cu",
           "w8_bf16_gemv": "mquant_tpu_torch/kernels/csrc/qmm.cu",
           "w4_unpack_gemv": "mquant_tpu_torch/kernels/csrc/qmm.cu",
           "dequant_swiglu_had_quant":
               "mquant_tpu_torch/kernels/csrc/fwht.cu",
           "group_epilogue": "mquant_tpu_torch/kernels/csrc/group.cu"}
# published H100 SXM f32 rate outside the tensor cores (the epilogue's FMAs)
F32_FLOPS = 67e12
L2_COLD_BYTES = 128 * 2**20
# published H100 SXM peaks (dense): HBM bytes/s, int8 op/s, bf16 FLOP/s
HBM_BPS, INT8_OPS, BF16_FLOPS = 3.35e12, 1979e12, 989e12


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    """Least time in ms for the work: the larger of bytes over the HBM rate
    and operations over the dense peak, and which of the two it is."""
    tb, to = nbytes / HBM_BPS * 1e3, ops / peak_ops * 1e3
    return (to, "operations") if to >= tb else (tb, "bytes")


def new_summary() -> dict:
    return {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "op_bound_ms": 0.0, "library_ms": 0.0, "lib_kernel_ms": 0.0,
            "lib_shapes": 0, "shapes": 0}


def add_main(s: dict, ms, pms, bms, bound_by, lms):
    """Sum one main-path shape into a kernel's summary. The library time
    sums over the shapes that have one, beside the kernel's time over the
    same shapes; the summary line's ``library_ms`` takes it only if every
    main-path shape has one."""
    s["ms"] += ms
    s["plain_ms"] += pms
    s["bound_ms"] += bms
    s["op_bound_ms"] += bms if bound_by == "operations" else 0.0
    s["shapes"] += 1
    if lms is not None:
        s["library_ms"] += lms
        s["lib_kernel_ms"] += ms
        s["lib_shapes"] += 1


def check_kernels(seed: int) -> dict:
    """Phase 3, integer kernels. Returns per-kernel summaries (max error,
    times and bounds summed over the main-path shapes)."""
    import torch

    from mquant_tpu_torch.kernels import qmm

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    summary = {k: new_summary() for k in ("w4a8_gemv", "int8_gemv",
                                          "int8_gemm", "int8_gemm_ragged")}
    rows_sum = new_summary()
    # the families' shapes, summed apart by the label's first word
    apart = {fam: {k: new_summary() for k in summary}
             for fam in ("IVL", "QVL", "MCPM")}
    for name, label, M, K, N, packed in (KERNEL_SHAPES + DOC_GEMM_SHAPES
                                         + ROWS_SHAPES + EDGE_SHAPES
                                         + I8_GEMV_SHAPES + RAGGED_SHAPES
                                         + IVL_SHAPES + QVL_SHAPES
                                         + MCPM_SHAPES):
        main = (name, label, M, K, N, packed) in KERNEL_SHAPES + RAGGED_SHAPES
        rows = K // 2 if packed else K
        x = torch.randint(-127, 128, (M, K), generator=g, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-128, 128, (rows, N), generator=g, device=dev,
                          dtype=torch.int8)
        if not packed:
            w.clamp_(min=-127)
        xs = torch.rand((M,), generator=g, device=dev) * 0.1 + 1e-3
        ws = torch.rand((N,), generator=g, device=dev) * 0.01 + 1e-4
        # the GEMM's route: the TMA kernel inside its contract, the ragged
        # kernel (its own launch count) outside
        if name == "int8_gemm" and not qmm.tma_supports(K, N, packed):
            name = "int8_gemm_ragged"
        kern = qmm.KERNELS[name]
        plain = qmm.PLAIN[name]
        extra = {"packed": packed} if name.startswith("int8_gemm") else {}
        # x as the GEMM meets it on the served path: a K that is no multiple
        # of 16 in rows padded to 16 bytes (qmm._codes_out), read in place
        xk = x
        if name.startswith("int8_gemm") and K % 16:
            xk = torch.empty((M, -(-K // 16) * 16), dtype=torch.int8,
                             device=dev)[:, :K].copy_(x)
        if "unaligned x" in label:  # rows 1 byte off 4-byte alignment
            xk = torch.empty((M * K + 1,), dtype=torch.int8,
                             device=dev)[1:].view(M, K).copy_(x)
        before = qmm.LAUNCHES[name]
        acc_k = kern(xk, xs, w, ws, torch.int32, **extra)
        if qmm.LAUNCHES[name] != before + 1:
            raise AssertionError(f"{name} [{label}]: not launched")
        acc_p = plain(x, xs, w, ws, torch.int32, **extra)
        torch.cuda.synchronize()
        if not torch.equal(acc_k, acc_p):
            bad = int((acc_k != acc_p).sum())
            raise AssertionError(f"{name} [{label}]: int32 accumulator differs "
                                 f"in {bad} of {acc_k.numel()} entries")
        del acc_p
        y_k = kern(xk, xs, w, ws, torch.bfloat16, **extra)
        y_p = plain(x, xs, w, ws, torch.bfloat16, **extra)
        err, ulps = bf16_ulp_err(y_k, y_p)
        if not torch.equal(y_k, y_p):
            raise AssertionError(f"{name} [{label}]: bf16 output differs from "
                                 f"the plain version's by up to {ulps} ulp "
                                 f"(max abs {err})")
        del y_p
        if name == "int8_gemv" and not torch.equal(
                kern(xk, xs, w, ws, torch.float32),
                plain(x, xs, w, ws, torch.float32)):
            raise AssertionError(f"{name} [{label}]: f32 output differs")
        # timed calls cycle over weight copies that together exceed the
        # 50 MB L2, so each call streams its weight from HBM as decode does
        wbytes = rows * N
        ws_cold = [w] + [w.clone() for _ in range(
            min(15, -(-L2_COLD_BYTES // wbytes) - 1))]
        ms = cuda_ms(lambda i: kern(xk, xs, ws_cold[i % len(ws_cold)], ws,
                                    torch.bfloat16, **extra), 20)
        pms = cuda_ms(lambda i: plain(x, xs, ws_cold[i % len(ws_cold)], ws,
                                      torch.bfloat16, **extra), 4, reps=3)
        # one library call on the same int8 operands: torch._int_mm (W8
        # only; it needs more than 16 rows, so a GEMV's rows are padded to
        # 32, and K % 8 == 0 and N % 8 == 0, so K and N are zero-padded,
        # which leaves the int32 sums as they are, and the output sliced);
        # no single call computes the packed-W4 product
        lms = None
        if not packed and (main or label.startswith(("doc", "QVL",
                                                      "MCPM"))):
            kp, np_ = -K % 8, -N % 8
            xl = torch.nn.functional.pad(
                x, (0, kp, 0, 32 - M if M <= 16 else 0))
            wl = ws_cold if kp == np_ == 0 else [
                torch.nn.functional.pad(c, (0, np_, 0, kp)) for c in ws_cold]
            if not torch.equal(torch._int_mm(xl, wl[0])[:M, :N], acc_k):
                raise AssertionError(f"{name} [{label}]: torch._int_mm on the "
                                     "padded operands differs")
            lms = cuda_ms(lambda i: torch._int_mm(xl, wl[i % len(wl)]), 20)
            del wl
        nbytes = wbytes + M * K + 2 * M * N + 4 * (M + N)
        bms, by = bound(nbytes, 2 * M * K * N, INT8_OPS)
        lib_txt = "none" if lms is None else f"{lms:.4f} ms"
        # the ragged kernel on the TMA kernel's shapes, held and timed in the
        # same call (its launches count as comparisons only): what the
        # threads' W producer costs against TMA's
        old_txt = ""
        if name == "int8_gemm":
            if not torch.equal(qmm.int8_gemm_ragged(xk, xs, w, ws,
                                                    torch.bfloat16, packed),
                               y_k):
                raise AssertionError(f"int8_gemm_ragged [{label}]: differs")
            oms = cuda_ms(lambda i: qmm.int8_gemm_ragged(
                xk, xs, ws_cold[i % len(ws_cold)], ws, torch.bfloat16,
                packed), 20)
            # the block width the wrapper did not pick
            other = 384 - qmm.tma_tokens(M, N, torch.cuda.get_device_properties(
                dev).multi_processor_count)
            if not torch.equal(qmm._gemm_tma(xk, xs, w, ws, torch.bfloat16,
                                             packed, other), y_k):
                raise AssertionError(f"int8_gemm [{label}] at {other} tokens "
                                     "a block: differs")
            tms = cuda_ms(lambda i: qmm._gemm_tma(
                xk, xs, ws_cold[i % len(ws_cold)], ws, torch.bfloat16, packed,
                other), 20)
            old_txt = (f", ragged kernel {oms:.4f} ms ({oms / ms:.2f}x), "
                       f"{other} tokens a block {tms:.4f} ms")
        log(f"kernel {name:10s} {label:20s} M={M:5d} K={K:6d} N={N:6d}: "
            "acc exact, bf16 bit-equal; "
            f"{ms:.4f} ms vs plain {pms:.4f} ms, library {lib_txt}, bound "
            f"{bms:.4f} ms ({by}){old_txt}; weight stream "
            f"{wbytes / ms / 1e6:.1f} GB/s, {2 * M * K * N / ms / 1e9:.2f} "
            f"TOP/s ({2 * M * K * N / ms / 1e9 / (INT8_OPS / 1e12):.1%} of "
            "the int8 peak)")
        s = summary[name]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        if main:
            add_main(s, ms, pms, bms, by, lms)
        elif (name, label, M, K, N, packed) in ROWS_SHAPES:
            add_main(rows_sum, ms, pms, bms, by, lms)
        elif label.split()[0] in apart:
            add_main(apart[label.split()[0]][name], ms, pms, bms, by, lms)
        del x, xk, w, ws_cold, acc_k, y_k
        torch.cuda.empty_cache()
    log(f"kernel w4a8_gemv at 4 / 8 / 32 rows (gate|up, down): {rows_sum['ms']:.4f} "
        f"ms summed, plain {rows_sum['plain_ms']:.4f} ms, bound "
        f"{rows_sum['bound_ms']:.4f} ms")
    for fam, model in (("IVL", "InternVL2-8B"), ("QVL", "Qwen-VL-Chat"),
                       ("MCPM", "MiniCPM-V-2.6")):
        for name, s in apart[fam].items():
            if s["shapes"]:
                lib = ("" if not s["lib_shapes"] else
                       f", library {s['library_ms']:.4f} ms over "
                       f"{s['lib_shapes']} of them (the kernel "
                       f"{s['lib_kernel_ms']:.4f} ms over the same)")
                log(f"kernel {name} at {model}'s {s['shapes']} shapes: "
                    f"{s['ms']:.4f} ms summed, plain {s['plain_ms']:.4f} ms, "
                    f"bound {s['bound_ms']:.4f} ms{lib}")
    for name, s in summary.items():
        if 0 < s["lib_shapes"] < s["shapes"]:
            log(f"kernel {name}: library {s['library_ms']:.4f} ms summed over "
                f"the {s['lib_shapes']} main-path shapes that have one (of "
                f"{s['shapes']}), the kernel {s['lib_kernel_ms']:.4f} ms over "
                "the same shapes")
    torch.cuda.empty_cache()
    return summary


# the group-blocked epilogue at path A's shapes (asym W4 per 128-row group,
# static asym activations): (label, rows, K, N, groups in the call); decode
# folds every group in one call, prefill one group a call
GROUP_SHAPES = [
    ("decode q / o", 1, 3584, 3584, 28),
    ("decode k / v", 1, 3584, 512, 28),
    ("decode gate / up", 1, 3584, 18944, 28),
    ("decode down", 1, 18944, 3584, 148),
    ("prefill q / o, a group", 1024, 3584, 3584, 1),
    ("prefill k / v, a group", 1024, 3584, 512, 1),
    ("prefill gate / up, a group", 1024, 3584, 18944, 1),
    ("prefill down, a group", 1024, 18944, 3584, 1),
    ("engine down, 8 rows", 8, 18944, 3584, 148),
]


def check_group_epilogue(seed: int) -> dict:
    """Phase 3, the group-blocked epilogue (``qmm.group_epilogue``) at path
    A's shapes: its f32 accumulator and bf16 output bit-equal to the plain
    version's (the same op order, ``qmm.fma32`` for the FMAs) on the same
    int32 group accumulators, beside its bound (no PyTorch call computes
    it); then on the strided views that ``qmm._blockdiag_partials`` gives
    it on the main path (:func:`check_blockdiag_views`). Returns its
    summary as :func:`check_kernels`."""
    import torch

    from mquant_tpu_torch.kernels import qmm

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 9)
    s = new_summary()
    for label, M, K, N, n in GROUP_SHAPES:
        G = K // GROUP
        P = torch.randint(-2**20, 2**20, (n, M, N), generator=g, device=dev,
                          dtype=torch.int32)
        wsum = torch.randint(-1000, 1000, (n, N), generator=g, device=dev,
                             dtype=torch.int32)
        xsum = torch.randint(-2**14, 2**14, (M, G), generator=g, device=dev,
                             dtype=torch.int32)
        xs = torch.rand((M, 1), generator=g, device=dev) * 0.02 + 1e-3
        xz = torch.randint(-40, 40, (M, 1), generator=g, device=dev).float()
        ws = torch.rand((G, N), generator=g, device=dev) * 0.01 + 1e-4
        wz = torch.randint(-8, 8, (G, N), generator=g, device=dev).float()
        g0 = 0 if n == G else G // 2
        acc0 = torch.randn((M, N), generator=g, device=dev)
        outs = []
        for fn in (qmm.group_epilogue, qmm.group_epilogue_ref):
            acc = acc0.clone()
            before = qmm.LAUNCHES["group_epilogue"]
            y = fn(P, wsum, xsum, xs, xz, ws, wz, acc, g0, G, GROUP,
                   torch.bfloat16)
            outs.append((acc, y))
            if fn is qmm.group_epilogue and \
                    qmm.LAUNCHES["group_epilogue"] != before + 1:
                raise AssertionError(f"group_epilogue [{label}]: not "
                                     "launched")
        torch.cuda.synchronize()
        (ak, yk), (ap, yp) = outs
        if not (torch.equal(ak, ap) and torch.equal(yk, yp)):
            raise AssertionError(f"group_epilogue [{label}]: differs from "
                                 "the plain version")
        # the bytes the call must move: the n groups' P, Σw, Σx columns and
        # W scale / zero point rows, x's scale and zero point, acc read
        # (g0 > 0) and written, the bf16 output
        nbytes = (4 * n * M * N + 4 * n * N + 4 * M * n + 8 * M
                  + 8 * n * N + (4 if g0 else 0) * M * N + 6 * M * N)
        # timed calls cycle over input copies that together exceed the 50 MB
        # L2 (the decode shapes' tables are ~8 MB), so each call reads them
        # from HBM as the decode step's 196 calls do
        copies = [(P, wsum, xsum, ws, wz, acc0.clone())] + [
            (P.clone(), wsum.clone(), xsum.clone(), ws.clone(), wz.clone(),
             acc0.clone())
            for _ in range(min(15, -(-L2_COLD_BYTES // nbytes) - 1))]

        def call(fn, i):
            p_, w_, x_, s_, z_, a_ = copies[i % len(copies)]
            return fn(p_, w_, x_, xs, xz, s_, z_, a_, g0, G, GROUP,
                      torch.bfloat16)

        ms = cuda_ms(lambda i: call(qmm.group_epilogue, i), 20)
        pms = cuda_ms(lambda i: call(qmm.group_epilogue_ref, i), 2, reps=3)
        bms, by = bound(nbytes, 8 * n * M * N, F32_FLOPS)
        log(f"kernel group_epilogue {label:26s} M={M:4d} N={N:5d} groups "
            f"{n:3d}: f32 accumulator and bf16 output bit-equal; {ms:.4f} ms "
            f"vs plain {pms:.4f} ms, library none, bound {bms:.4f} ms "
            f"({by}); {nbytes / ms / 1e6:.1f} GB/s; {len(copies)} input "
            "copies")
        add_main(s, ms, pms, bms, by, None)
        del P, copies, outs
    check_blockdiag_views(seed)
    torch.cuda.empty_cache()
    return {"group_epilogue": s}


def check_blockdiag_views(seed: int) -> None:
    """``qmm._blockdiag_partials`` at path A's decode ``down`` (1 row, the
    engine's 8), as the main path calls it: its int32 group accumulators
    and the ones block's Σw equal to the exact dots group by group, then
    ``group_epilogue`` on those strided views (row stride G·N, group
    stride N) bit-equal to its plain version."""
    import torch

    from mquant_tpu_torch.kernels import qmm

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 10)
    K, N = 18944, 3584
    G, u = K // GROUP, GROUP
    w = torch.randint(-8, 8, (K, N), generator=g, device=dev,
                      dtype=torch.int8)
    ws = torch.rand((G, N), generator=g, device=dev) * 0.01 + 1e-4
    wz = torch.randint(-8, 8, (G, N), generator=g, device=dev).float()
    exact_w = w.reshape(G, u, N).double()
    for M in (1, 8):
        xq = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                           dtype=torch.int8)
        P, wsum = qmm._blockdiag_partials(xq, w, G, ones=True)
        if P.stride()[:2] != (N, G * N):
            raise AssertionError("blockdiag views: P is not the strided "
                                 f"view (strides {P.stride()})")
        ref = torch.einsum("mgu,gun->gmn", xq.reshape(M, G, u).double(),
                           exact_w).to(torch.int32)
        if not (torch.equal(P, ref) and torch.equal(
                wsum, exact_w.sum(1).to(torch.int32))):
            raise AssertionError(f"blockdiag views, {M} rows: the group "
                                 "accumulators or Σw differ from the exact "
                                 "dots")
        xsum = xq.reshape(M, G, u).sum(-1, dtype=torch.int32).contiguous()
        xs = torch.rand((M, 1), generator=g, device=dev) * 0.02 + 1e-3
        xz = torch.randint(-40, 40, (M, 1), generator=g, device=dev).float()
        outs = []
        for fn in (qmm.group_epilogue, qmm.group_epilogue_ref):
            acc = torch.empty((M, N), device=dev)
            outs.append((acc, fn(P, wsum, xsum, xs, xz, ws, wz, acc, 0, G,
                                 u, torch.bfloat16)))
        (ak, yk), (ap, yp) = outs
        if not (torch.equal(ak, ap) and torch.equal(yk, yp)):
            raise AssertionError(f"blockdiag views, {M} rows: group_epilogue "
                                 "differs from the plain version")
        log(f"kernel group_epilogue on _blockdiag_partials' views, M={M} "
            f"K={K} N={N} groups {G} (P strides {P.stride()}): partials and "
            "Σw equal to the exact dots, f32 accumulator and bf16 output "
            "bit-equal to the plain version")


ATTN_RTOL = 1e-2  # attention outputs: max |Δ| ≤ ATTN_RTOL · max |plain|
KVH, HD, HEADS = 4, 128, 28  # Qwen2-VL-7B's attention widths
# decode attention (label, B, S, pos, start, main path, NaN tail): the
# 1024-token request's first and last decode steps and the document
# request's last, on the bucketed 8192-row cache; the ragged batch's
# per-row start; per-row pos; the engine's pool step (8 slots at their own
# positions over its 1280-row buffer, the columns ≥ pos NaN as a reused
# slot's stale rows may be, ROADMAP C-w1); a short context where every
# column weighs ~1/36 of the output (a dropped column or new-token term
# fails the bound), with host ints by value. Other poisoned columns hold
# finite values that swamp the output if read.
DECODE_SHAPES = [
    ("decode pos 40, start 5", 1, 8192, 40, 5, False, False),
    ("decode pos 1024", 1, 8192, 1024, None, True, False),
    ("decode pos 1151", 1, 8192, 1151, None, True, False),
    ("doc decode pos 4223", 1, 8192, 4223, None, True, False),
    ("batch 4, per-row start", 4, 8192, 1030, [0, 37, 500, 724], True, False),
    ("batch 4, per-row pos", 4, 8192, [1030, 700, 4223, 1],
     [0, 37, 500, 0], False, False),
    ("engine 8 slots, per-row pos", 8, 1280,
     [1127, 78, 301, 514, 1001, 300, 590, 1200], None, True, True),
]
# InternVL2-8B's decode attention (32 query heads over 8 KV heads, G = 4;
# hd 128): the request's first and last steps and the engine burst's 4
# slots at their own positions, held and timed apart from the 7B rows
IVL_DECODE_SHAPES = [
    ("IVL decode pos 1024, G 4", 1, 8192, 1024, None, False, False),
    ("IVL decode pos 1151, G 4", 1, 8192, 1151, None, False, False),
    ("IVL engine 4 slots, G 4", 4, 1280, [92, 315, 528, 1015], None, False,
     True),
]
# GLM-4V-9B's (32 query heads over 2 KV heads, G = 16, the kernel's
# widest): the request's first and last steps over its 1280-row bucket and
# the engine's 8-slot pool step, every column ≥ pos NaN
GLM_DECODE_SHAPES = [
    ("GLM decode pos 1024, G 16", 1, 1280, 1024, None, False, True),
    ("GLM decode pos 1151, G 16", 1, 1280, 1151, None, False, True),
    ("GLM engine 8 slots, G 16", 8, 1280,
     [1127, 78, 301, 514, 1001, 300, 590, 1200], None, False, True),
]
# Qwen-VL-Chat's (32 query heads over 32 KV heads, G = 1): the request's
# first and last steps over its 1280-row bucket and the engine burst's 4
# slots at their own positions, every column ≥ pos NaN
QVL_DECODE_SHAPES = [
    ("QVL decode pos 1024, G 1", 1, 1280, 1024, None, False, True),
    ("QVL decode pos 1151, G 1", 1, 1280, 1151, None, False, True),
    ("QVL engine 4 slots, G 1", 4, 1280, [92, 315, 528, 1015], None, False,
     True),
]
# (query heads, KV heads) of the shapes a label's first word names
ATTN_HEADS = {"IVL": (32, 8), "GLM": (32, 2), "QVL": (32, 32)}
# causal flash prefill (label, T, main path)
FLASH_SHAPES = [("prefill T 1024", 1024, False),
                ("prefill T 2048", 2048, False),
                ("doc prefill T 4096", 4096, True),
                ("longctx prefill T 16384", 16384, False)]
# the plain version's f32 scores of all heads at once up to this many bytes
# (a (T, T) f32 tensor a head, and its masked copy and softmax beside it);
# past it, one query head at a time
FLASH_REF_BYTES = 8 << 30


def same_bits(a, b) -> bool:
    """Bit-equal tensors (NaN rows too, which ``torch.equal`` never
    calls equal)."""
    import torch

    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def _attn_err(out, ref, label):
    """(max |d|, the same in bf16 ulps at max |ref|, max |ref|); fails
    outside the bound or on a non-finite output."""
    import torch

    err = float((out.float() - ref.float()).abs().max())
    mag = float(ref.float().abs().max())
    if not bool(torch.isfinite(out.float()).all()) or err > ATTN_RTOL * mag:
        raise AssertionError(f"{label}: max |d| {err} against max |ref| {mag}")
    return err, err / 2.0 ** (math.floor(math.log2(mag)) - 7), mag


def flash_ref(q, k, v, scale):
    """``flash_attention_causal_ref`` on all heads, or one query head at a
    time (with its KV head) where the f32 scores of all would pass
    FLASH_REF_BYTES: each head's einsum is the same function of its own
    q, k, v."""
    import torch

    from mquant_tpu_torch.kernels import flash_attn as TF

    T, H, kvh = q.shape[1], q.shape[2], k.shape[2]
    if 4 * H * T * T <= FLASH_REF_BYTES:
        return TF.flash_attention_causal_ref(q, k, v, scale)
    G = H // kvh
    return torch.cat([TF.flash_attention_causal_ref(
        q[:, :, h:h + 1].contiguous(), k[:, :, h // G:h // G + 1].contiguous(),
        v[:, :, h // G:h // G + 1].contiguous(), scale) for h in range(H)],
        dim=2)


def check_attention(seed: int) -> dict:
    """Phase 3, attention kernels, with the cache columns outside
    [start, pos) poisoned. Returns summaries as :func:`check_kernels`."""
    import torch
    import torch.nn.functional as F

    from mquant_tpu_torch.kernels import attn_decode as TA

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 1)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    summary = {"attn_decode": new_summary()}
    apart = {k: new_summary() for k in ATTN_HEADS}  # summed apart
    scale = HD**-0.5
    for label, B, S, pos, start, main, nan_tail in (
            DECODE_SHAPES + IVL_DECODE_SHAPES + GLM_DECODE_SHAPES
            + QVL_DECODE_SHAPES):
        heads, kvh = ATTN_HEADS.get(label.split()[0], (HEADS, KVH))
        q, kn, vn = r(B, 1, heads, HD), r(B, 1, kvh, HD), r(B, 1, kvh, HD)
        kc, vc = r(B, S, kvh, HD), r(B, S, kvh, HD)
        p = torch.as_tensor(pos, device=dev).reshape(-1).expand(B)
        st = torch.as_tensor(0 if start is None else start,
                             device=dev).reshape(-1).expand(B)
        cols = torch.arange(S, device=dev)[None]
        bad = ((cols < st[:, None]) | (cols >= p[:, None]))[..., None, None]
        # a read of either swamps the output (or makes it NaN)
        kc.masked_fill_(bad, float("nan") if nan_tail else 50.0)
        vc.masked_fill_(bad, float("nan") if nan_tail else 3e4)
        kc_p, vc_p = kc.clone(), vc.clone()
        pos_a = pos if isinstance(pos, int) else p.to(torch.int32)
        st_a = start if start is None or isinstance(start, int) else \
            st.to(torch.int32)
        out, _, _ = TA.attn_decode(q, kn, vn, kc, vc, pos_a, scale, start=st_a)
        ref, _, _ = TA.attn_decode_ref(q, kn, vn, kc_p, vc_p, pos_a, scale,
                                       start=st_a)
        torch.cuda.synchronize()
        if not (same_bits(kc, kc_p) and same_bits(vc, vc_p)):
            raise AssertionError(f"attn_decode [{label}]: cache rows differ")
        err, ulps, mag = _attn_err(out, ref, f"attn_decode [{label}]")
        # timed calls cycle over cache copies beyond the 50 MB L2, as the 28
        # layers' caches are at decode
        cbytes = 2 * kc.numel() * 2
        n_copy = max(1, min(8, -(-L2_COLD_BYTES // cbytes)))
        caches = [(kc, vc)] + [(kc.clone(), vc.clone())
                               for _ in range(n_copy - 1)]
        ms = cuda_ms(lambda i: TA.attn_decode(
            q, kn, vn, *caches[i % n_copy], pos_a, scale, start=st_a), 20)
        pms = cuda_ms(lambda i: TA.attn_decode_ref(
            q, kn, vn, *caches[i % n_copy], pos_a, scale, start=st_a), 4,
            reps=3)
        # SDPA as the yardstick, without the cache write: with one start
        # and pos for every row, over K / V sliced to the columns start ≤
        # col ≤ pos (the rows the kernel reads, the new one in place of row
        # pos); with per-row indices, over the whole cache with a mask (it
        # reads all S rows: no single call reads only the kernel's)
        qt = q.transpose(1, 2)
        if isinstance(pos, int) and not isinstance(start, list):
            s0, s1 = (start or 0), pos + 1
            sdpa_txt = f"SDPA on columns [{s0}, {s1})"
            lms = cuda_ms(lambda i: F.scaled_dot_product_attention(
                qt, caches[i % n_copy][0][:, s0:s1].transpose(1, 2),
                caches[i % n_copy][1][:, s0:s1].transpose(1, 2),
                scale=scale, enable_gqa=True), 20)
        else:
            amask = ((cols >= st[:, None])
                     & (cols <= p[:, None]))[:, None, None]
            sdpa_txt = f"SDPA masked over all {S} rows"
            lms = cuda_ms(lambda i: F.scaled_dot_product_attention(
                qt, caches[i % n_copy][0].transpose(1, 2),
                caches[i % n_copy][1].transpose(1, 2), attn_mask=amask,
                scale=scale, enable_gqa=True), 20)
        cols_read = int((p - st).clamp(min=0).sum())
        nbytes = (2 * cols_read * kvh * HD * 2 + 2 * B * heads * HD * 2
                  + 4 * B * kvh * HD * 2)
        bms, by = bound(nbytes, 4 * heads * HD * (cols_read + B), BF16_FLOPS)
        log(f"kernel attn_decode {label:24s} B={B} S={S}: cache rows equal, "
            f"max |d| {err:.3g} ({ulps:.2f} bf16 ulp at max |ref| {mag:.3g}); "
            f"{ms:.4f} ms vs plain {pms:.4f} ms, {sdpa_txt} {lms:.4f} ms"
            f"{' (faster than the kernel)' if lms < ms else ''}, bound "
            f"{bms:.4f} ms ({by}); {nbytes / ms / 1e6:.1f} GB/s")
        s = summary["attn_decode"]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        if main:
            add_main(s, ms, pms, bms, by, lms)
        elif label.split()[0] in apart:
            add_main(apart[label.split()[0]], ms, pms, bms, by, lms)
        del q, kn, vn, kc, vc, kc_p, vc_p, caches, out, ref
    for key, model in (("IVL", "InternVL2-8B"), ("GLM", "GLM-4V-9B"),
                       ("QVL", "Qwen-VL-Chat")):
        a = apart[key]
        heads, kvh = ATTN_HEADS[key]
        log(f"kernel attn_decode at {model}'s {a['shapes']} shapes (G = "
            f"{heads // kvh}): {a['ms']:.4f} ms summed, plain "
            f"{a['plain_ms']:.4f} ms, SDPA {a['library_ms']:.4f} ms, bound "
            f"{a['bound_ms']:.4f} ms")
    summary.update(check_flash(seed, FLASH_SHAPES, g))
    return summary


def check_flash(seed: int, shapes=FLASH_SHAPES, g=None) -> dict:
    """Phase 3, ``flash_attn_causal`` against its plain version
    (:func:`flash_ref`) at each (label, T, main path) of ``shapes``, timed
    beside SDPA, on inputs drawn from ``g`` (a new generator of ``seed``
    where None). Returns a summary as :func:`check_kernels`."""
    import torch
    import torch.nn.functional as F

    from mquant_tpu_torch.kernels import flash_attn as TF

    dev = torch.device("cuda")
    if g is None:
        g = torch.Generator(device=dev).manual_seed(seed + 1)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    summary = {"flash_attn_causal": new_summary()}
    scale = HD**-0.5
    for label, T, main in shapes:
        q, k, v = r(1, T, HEADS, HD), r(1, T, KVH, HD), r(1, T, KVH, HD)
        out = TF.flash_attention_causal(q, k, v, scale)
        ref = flash_ref(q, k, v, scale)
        torch.cuda.synchronize()
        err, ulps, mag = _attn_err(out, ref, f"flash_attn_causal [{label}]")
        del ref
        ms = cuda_ms(lambda i: TF.flash_attention_causal(q, k, v, scale), 10)
        pms = cuda_ms(lambda i: flash_ref(q, k, v, scale), 2, reps=3)
        torch.cuda.empty_cache()
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lms = cuda_ms(lambda i: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=scale, enable_gqa=True), 10)
        flops = 4 * HEADS * HD * T * T / 2
        nbytes = (2 * q.numel() + 2 * 2 * k.numel()) * 2
        bms, by = bound(nbytes, flops, BF16_FLOPS)
        by_head = (" (a head at a time)" if 4 * HEADS * T * T > FLASH_REF_BYTES
                   else "")
        log(f"kernel flash_attn_causal {label:20s} H={HEADS} KVH={KVH}: "
            f"max |d| {err:.3g} ({ulps:.2f} bf16 ulp at max |ref| {mag:.3g}); "
            f"{ms:.4f} ms vs plain{by_head} {pms:.4f} ms, SDPA {lms:.4f} ms, "
            f"bound {bms:.4f} ms ({by}); {flops / ms / 1e9:.1f} TFLOP/s")
        s = summary["flash_attn_causal"]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        if main:
            add_main(s, ms, pms, bms, by, lms)
        del q, k, v, out
    torch.cuda.empty_cache()
    return summary


def check_bf16_reduction(seed: int) -> None:
    """Phase 3 (ROADMAP C-w11): the port's bf16 products outside the
    kernels, with cuBLAS's ``allow_bf16_reduced_precision_reduction`` on
    (PyTorch's default) and off, on the same inputs: the einsum attention
    at T = 1024 (its P·V product, ``layers.einsum_attention``) and the
    fp-mode ``qlinear`` at the ViT patch-embed shape (1024, 1176) × (1176,
    1280). Prints whether the two results are bit-equal."""
    import torch

    from mquant_tpu_torch.models import layers as L

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 5)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    q, k, v = r(1, 1024, HEADS, HD), r(1, 1024, KVH, HD), r(1, 1024, KVH, HD)
    x, w = r(1024, 1176), r(1176, 1280) * 0.03
    cases = {"einsum attention P.V, T 1024": lambda: L.einsum_attention(
                 q, k, v, None, HD**-0.5, causal=True),
             "fp qlinear patch embed (1024, 1176) x (1176, 1280)":
                 lambda: L.qlinear(x, {"w": w}, "vis.patch_embed")}
    flags = torch.backends.cuda.matmul
    prev = flags.allow_bf16_reduced_precision_reduction
    try:
        for label, fn in cases.items():
            outs = []
            for on in (True, False):
                flags.allow_bf16_reduced_precision_reduction = on
                outs.append(fn().float())
            d = (outs[0] - outs[1]).abs()
            log(f"bf16 reduction [{label}]: flag on vs off "
                + ("bit-equal" if torch.equal(*outs) else
                   f"differ in {int((d > 0).sum())} of {d.numel()} outputs, "
                   f"max |d| {float(d.max()):.3g} of max "
                   f"{float(outs[1].abs().max()):.3g}"))
    finally:
        flags.allow_bf16_reduced_precision_reduction = prev


TAIL_N, TAIL_SCALE = 18944, 0.05  # Qwen2-VL-7B's intermediate = 148 · 128
# the fused tail (label, T, main path, f32 rows, g and u as the halves of
# one gate|up row): path F's 1024-token prefill, the shortest prefill that
# takes it, a few rows, one token past a block per SM (132 blocks: one
# takes two), the served halves, f32 rows
# (label, T, main path, f32 rows, g / u as halves of one row, n): path F's
# prefill, edges, and GLM-4V-9B's padded intermediate 13824 = 108 · 128 (a
# hadK no served model reaches the kernel with)
TAIL_SHAPES = [("F prefill T 1024", 1024, True, False, False, TAIL_N),
               ("T 256", 256, False, False, False, TAIL_N),
               ("T 5", 5, False, False, False, TAIL_N),
               ("T 133", 133, False, False, False, TAIL_N),
               ("T 1024, gate|up halves", 1024, False, False, True, TAIL_N),
               ("T 1024, f32 g, u", 1024, False, True, False, TAIL_N),
               ("GLM T 1024, K 108", 1024, False, False, False, 13824)]
TAIL_MAX_FRAC = 0.01  # at most 1% of the codes one step off the plain's


def tail_diff(q, ref, label) -> tuple[int, float]:
    """(max |code difference|, fraction of codes that differ); fails beyond
    ±1 or TAIL_MAX_FRAC."""
    d = (q.int() - ref.int()).abs()
    worst, frac = int(d.max()), float((d > 0).float().mean())
    if q.shape != ref.shape or worst > 1 or frac > TAIL_MAX_FRAC:
        raise AssertionError(f"{label}: codes differ by up to {worst} in a "
                             f"fraction {frac} of {ref.numel()}")
    return worst, frac


def check_tail(seed: int) -> dict:
    """Phase 3, the fused tail kernel. Returns its summary as
    :func:`check_kernels`; prints the unfused torch chain's time."""
    import torch

    from mquant_tpu_torch.core.formats import INT8
    from mquant_tpu_torch.core.quant import QuantParams, quantize
    from mquant_tpu_torch.kernels import fwht
    from mquant_tpu_torch.models.layers import swiglu

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    s = torch.tensor(TAIL_SCALE, device=dev)
    summary = new_summary()
    for label, T, main, f32, halves, n in TAIL_SHAPES:
        K = fwht._factors(n)[2]
        dt = torch.float32 if f32 else torch.bfloat16
        # two input copies: 155 MB at T = 1024 in bf16, beyond the 50 MB L2
        ins = []
        for _ in range(2):
            gu = torch.randn((T, 2 * n), generator=g, device=dev).to(dt)
            ins.append([gu[:, :n], gu[:, n:]] if halves else
                       [gu[:, :n].contiguous(), gu[:, n:].contiguous()])
            del gu
        q = fwht.fused_swiglu_had_quant(*ins[0], s)
        ref = fwht.fused_swiglu_had_quant_ref(*ins[0], s)
        torch.cuda.synchronize()
        worst, frac = tail_diff(q, ref, f"fused_swiglu_had_quant [{label}]")
        ms = cuda_ms(lambda i: fwht.fused_swiglu_had_quant(*ins[i % 2], s),
                     20)
        pms = cuda_ms(lambda i: fwht.fused_swiglu_had_quant_ref(
            *ins[i % 2], s), 4, reps=3)
        nbytes = 2 * ins[0][0].element_size() * T * n + T * n
        bms, by = bound(nbytes, 2 * T * n * (K + n // K), BF16_FLOPS)
        log(f"kernel fused_swiglu_had_quant {label:22s} n={n}: codes "
            f"within {worst}, {frac:.6f} of them differ; {ms:.4f} ms vs "
            f"plain {pms:.4f} ms, library none, bound {bms:.4f} ms ({by}); "
            f"{nbytes / ms / 1e6:.1f} GB/s")
        if main:
            chain_ms = cuda_ms(lambda i: quantize(
                fwht.online_hadamard(swiglu(*ins[i % 2])), QuantParams(s),
                INT8), 4, reps=3)
            log(f"kernel fused_swiglu_had_quant {label}: the unfused torch "
                f"chain (swiglu → online_hadamard → quantize) {chain_ms:.4f} "
                "ms")
            add_main(summary, ms, pms, bms, by, None)
        summary["max_abs_err"] = max(summary["max_abs_err"], float(worst))
        del ins, q, ref
    torch.cuda.empty_cache()
    return {"fused_swiglu_had_quant": summary}


F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
RMS_MAX_FRAC = 1e-3  # rms_norm_quant: at most 1e-3 of the codes one step off
FWHT_RTOL = 1e-5  # fwht: max |Δ| ≤ FWHT_RTOL · max |plain|
# the prefill probe's kernels (kernel, label, T, n, f32 input, main path):
# the probe's shapes, then edges (one row, a ragged T, K = 28, f32 in and
# out, a power-of-two n, K = 1, and fwht's dense route: the K = 156 block
# that is no scaled sign matrix)
PROBE_SHAPES = [
    ("rms_norm_quant", "probe", 1024, 3584, False, True),
    ("rms_norm_quant", "T 1", 1, 3584, False, False),
    ("rms_norm_quant", "T 333", 333, 3584, False, False),
    ("had_quant", "probe", 1024, 18944, False, True),
    ("had_quant", "K 28", 256, 3584, False, False),
    ("had_quant", "T 133", 133, 18944, False, False),
    ("had_quant", "f32", 1024, 18944, True, False),
    ("fwht_two_matmul", "probe, bf16", 1024, 18944, False, True),
    ("fwht_two_matmul", "f32", 1024, 18944, True, False),
    ("fwht_two_matmul", "pow2, f32", 64, 4096, True, False),
    ("fwht_two_matmul", "K 1", 133, 128, False, False),
    ("fwht_two_matmul", "K 156, f32", 64, 19968, True, False),
    # GLM-4V-9B's padded intermediate 13824 = 108 · 128
    ("had_quant", "GLM K 108", 1024, 13824, False, False),
    ("fwht_two_matmul", "GLM K 108", 1024, 13824, False, False),
]


def _probe_kernel_check(name, x, w, s, out, ref) -> tuple[float, str]:
    """(max error, text) of one probe kernel against its plain version;
    fails outside its bound. Codes: within ±1 (rms_norm_quant: at most
    RMS_MAX_FRAC differing, and the fraction a correctly rounded 1/sqrt
    would move; had_quant: TAIL_MAX_FRAC). fwht: f32 within FWHT_RTOL of
    max |plain|; bf16 within one ulp plus that bound."""
    import torch

    if name == "fwht_two_matmul":
        o, r = out.float(), ref.float()
        err, mag = float((o - r).abs().max()), float(r.abs().max())
        m = torch.maximum(o.abs(), r.abs()).clamp(min=2.0**-126)
        ulp = torch.exp2(torch.floor(torch.log2(m)) - 7)
        beyond = float(((o - r).abs() > ulp).float().mean())
        ok = (err <= FWHT_RTOL * mag if out.dtype == torch.float32 else
              bool(((o - r).abs() <= ulp + FWHT_RTOL * mag).all()))
        if out.shape != ref.shape or not ok:
            raise AssertionError(f"{name}: max |d| {err} of max |plain| {mag}")
        return err, (f"max |d| {err:.3g} ({err / mag:.2e} of max |plain|), "
                     f"{beyond:.2e} of outputs beyond one bf16 ulp")
    if name == "had_quant":
        worst, frac = tail_diff(out, ref, name)
        return float(worst), f"codes within {worst}, {frac:.6f} of them differ"
    d = (out.int() - ref.int()).abs()
    worst, frac = int(d.max()), float((d > 0).float().mean())
    if worst > 1 or frac > RMS_MAX_FRAC:
        raise AssertionError(f"{name}: codes differ by up to {worst} in a "
                             f"fraction {frac}")
    xf = x.float()
    y = xf * (1.0 / torch.sqrt((xf * xf).mean(-1, keepdim=True) + 1e-6))
    alt = torch.clamp(torch.round(y * w.float() * (1.0 / s)), -128, 127)
    moved = float((alt != out.float()).float().mean())
    return float(worst), (f"codes within {worst}, {frac:.2e} of them differ "
                          f"(rsqrtf; 1/sqrt correctly rounded would move "
                          f"{moved:.2e})")


def check_probe_kernels(seed: int) -> dict:
    """Phase 3, the prefill probe's kernels: rms_norm_quant, had_quant and
    fwht_two_matmul against their plain versions, their device times beside
    the plain version's and the unfused torch chain's (none of the three has
    one PyTorch call), and their bounds. Returns summaries as
    :func:`check_kernels`."""
    import torch

    from mquant_tpu_torch.core.formats import INT8
    from mquant_tpu_torch.core.quant import QuantParams, quantize
    from mquant_tpu_torch.kernels import fwht
    from mquant_tpu_torch.models.layers import rms_norm

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    s = torch.tensor(TAIL_SCALE, device=dev)
    qp = QuantParams(s)
    summary = {k: new_summary() for k in ("rms_norm_quant", "had_quant",
                                          "fwht_two_matmul")}
    chains = {
        "rms_norm_quant": lambda x, w: quantize(rms_norm(x, w), qp, INT8),
        "had_quant": lambda x, w: quantize(fwht.online_hadamard(x), qp, INT8),
        "fwht_two_matmul": lambda x, w: fwht.online_hadamard(x)}
    for name, label, T, n, f32, main in PROBE_SHAPES:
        dt = torch.float32 if f32 else torch.bfloat16
        in_bytes = T * n * (4 if f32 else 2)
        # input copies beyond the 50 MB L2, so each call reads from HBM
        xs = [(torch.randn((T, n), generator=g, device=dev) * 3).to(dt)
              for _ in range(min(16, max(2, -(-L2_COLD_BYTES // in_bytes))))]
        w = (torch.randn((n,), generator=g, device=dev) * 0.5).to(
            torch.bfloat16)
        args = {"rms_norm_quant": lambda x: (x, w, s),
                "had_quant": lambda x: (x, s),
                "fwht_two_matmul": lambda x: (x,)}[name]
        kern, plain = fwht.KERNELS[name], fwht.PLAIN[name]
        out, ref = kern(*args(xs[0])), plain(*args(xs[0]))
        torch.cuda.synchronize()
        err, text = _probe_kernel_check(name, xs[0], w, s, out, ref)
        ms = cuda_ms(lambda i: kern(*args(xs[i % len(xs)])), 20)
        pms = cuda_ms(lambda i: plain(*args(xs[i % len(xs)])), 4, reps=3)
        K = fwht._factors(n)[2] if name != "rms_norm_quant" else 0
        if name == "rms_norm_quant":
            nbytes, ops, peak = 3 * T * n + 2 * n + 4, 5 * T * n, F32_FLOPS
        elif name == "had_quant":
            nbytes = in_bytes + T * n + 2 * (160 * 160 + 128 * 128) + 4
            ops, peak = 2 * T * n * (K + 128), BF16_FLOPS
        elif fwht._sign_factor(n) is None:  # dense hadK by f32 FMA
            nbytes = 2 * in_bytes + 4 * K * 160
            ops, peak = T * (2 * K * n + 8 * n), F32_FLOPS
        else:
            # hadK = c · sign(hadK) on the tensor cores: three exact bf16
            # products of 2 K n flops a row, the butterfly's 8 n f32 flops
            # as the bf16 flops of the same time
            nbytes = 2 * in_bytes + 2 * 160 * 160
            ops = T * (3 * 2 * K * n + 8 * n * BF16_FLOPS / F32_FLOPS)
            peak = BF16_FLOPS
        bms, by = bound(nbytes, ops, peak)
        log(f"kernel {name} {label:11s} T={T:5d} n={n:5d}: {text}; {ms:.4f} "
            f"ms vs plain {pms:.4f} ms, library none, bound {bms:.4f} ms "
            f"({by}); {nbytes / ms / 1e6:.1f} GB/s, {ops / ms / 1e9:.2f} "
            "TFLOP/s")
        s_ = summary[name]
        s_["max_abs_err"] = max(s_["max_abs_err"], err)
        if main:
            chain_ms = cuda_ms(lambda i: chains[name](xs[i % len(xs)], w), 4,
                               reps=3)
            log(f"kernel {name} {label}: {ms:.4f} ms, bound {bms:.4f} ms "
                f"({by}), the unfused torch chain ("
                + ("online_hadamard" if name == "fwht_two_matmul" else
                   "torch ops") + f") {chain_ms:.4f} ms")
            add_main(s_, ms, pms, bms, by, None)
        del xs, out, ref
    torch.cuda.empty_cache()
    return summary


W8_SLACK = 1e-5  # w8_bf16_gemv: one bf16 ulp + W8_SLACK · max |plain|
# the decode probes' kernels (label, M, K, N, main path): gemv_bench's
# shape, then edges (one and five rows, a partial 128-column block, rows
# that TMA cannot stream (N % 16 = 8) with a K that is no multiple of 4)
W8_SHAPES = [("gemv_bench", 8, 3584, 19968, True),
             ("M 1", 1, 3584, 19968, False), ("M 5", 5, 3584, 19968, False),
             ("N 1040", 8, 3584, 1040, False),
             ("N % 16 = 8", 3, 2051, 1032, False)]
# w4_unpack_tune's layer shape for each variant, and an edge with K/2 odd
# (the predicated tail)
W4U_SHAPES = [("w4_unpack_tune", 8, 18944, 3584, True),
              ("K/2 odd", 3, 1002, 1040, False)]
# mlp_variants' fused epilogue (label, T, n, main path): T = 1024 at 18944,
# a few rows, K = 28
DEQ_SHAPES = [("mlp_variants T 1024", 1024, 18944, True),
              ("T 5", 5, 18944, False), ("K 28", 64, 3584, False),
              ("T 133", 133, 18944, False)]


def check_decode_probe_kernels(seed: int) -> dict:
    """Phase 3, the kernels of the decode probes: ``w8_bf16_gemv`` (bf16
    within one ulp plus W8_SLACK of max |plain|; f32 sums against float64
    ones), ``w4_unpack_gemv`` P0-P3 (int32 bit-equal; P1-P3 also to
    ``w4a8_gemv``'s) and ``dequant_swiglu_had_quant`` (codes: the tail's
    rule), each beside its plain version, its unfused torch chain (none has
    one PyTorch call) and its bound. The w4 summary sums P0-P3 at the
    probe's shape. Returns summaries as :func:`check_kernels`."""
    import torch
    import torch.nn.functional as F

    from mquant_tpu_torch.kernels import fwht, qmm

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 4)
    summary = {k: new_summary() for k in ("w8_bf16_gemv", "w4_unpack_gemv",
                                          "dequant_swiglu_had_quant")}
    for label, M, K, N, main in W8_SHAPES:
        x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
        ws = [torch.randint(-127, 127, (K, N), generator=g, device=dev,
                            dtype=torch.int8) for _ in range(2)]
        sc = torch.rand((N,), generator=g, device=dev) * 0.01 + 1e-3
        y, ref = qmm.w8_bf16_gemv(x, ws[0], sc), qmm.w8_bf16_gemv_ref(
            x, ws[0], sc)
        torch.cuda.synchronize()
        err, ulps = bf16_ulp_err(y, ref)
        yf, rf = y.float(), ref.float()
        m = torch.maximum(yf.abs(), rf.abs()).clamp(min=2.0**-126)
        ulp = torch.exp2(torch.floor(torch.log2(m)) - 7)
        beyond = float(((yf - rf).abs() > ulp).float().mean())
        if y.shape != ref.shape or not bool(
                ((yf - rf).abs() <= ulp + W8_SLACK * rf.abs().max()).all()):
            raise AssertionError(f"w8_bf16_gemv [{label}]: up to {ulps} ulp "
                                 f"(max abs {err})")
        if not torch.equal(y, qmm.w8_bf16_gemv(x, ws[0], sc)):
            raise AssertionError(f"w8_bf16_gemv [{label}]: not deterministic")
        # two weight copies: 143 MB at N = 19968, beyond the 50 MB L2
        ms = cuda_ms(lambda i: qmm.w8_bf16_gemv(x, ws[i % 2], sc), 20)
        pms = cuda_ms(lambda i: qmm.w8_bf16_gemv_ref(x, ws[i % 2], sc), 4,
                      reps=3)
        nbytes = K * N + 2 * M * K + 4 * N + 2 * M * N
        bms, by = bound(nbytes, 2 * M * K * N, BF16_FLOPS)
        log(f"kernel w8_bf16_gemv {label:14s} M={M} K={K} N={N:5d}: max |d| "
            f"{err:.3g} ({ulps:.2f} ulp, {beyond:.2e} of outputs beyond one "
            f"ulp), deterministic; {ms:.4f} ms vs plain {pms:.4f} ms, "
            f"library none, bound {bms:.4f} ms ({by}); "
            f"{nbytes / ms / 1e6:.1f} GB/s")
        s_ = summary["w8_bf16_gemv"]
        s_["max_abs_err"] = max(s_["max_abs_err"], err)
        if main:
            chain_ms = cuda_ms(lambda i: (torch.matmul(
                x, ws[i % 2].to(torch.bfloat16)).float() * sc).to(
                torch.bfloat16), 4, reps=3)
            log(f"kernel w8_bf16_gemv {label}: the unfused torch chain "
                f"(convert, torch.matmul, scale) {chain_ms:.4f} ms")
            # the library call on the same operands: int8 W as (N, K),
            # transposed once outside the timing, bf16 per-channel scales
            lms = None
            try:
                wts = [w.t().contiguous() for w in ws]
                scb = sc.to(torch.bfloat16)
                yl = torch._weight_int8pack_mm(x, wts[0], scb)
                torch.cuda.synchronize()
                lms = cuda_ms(lambda i: torch._weight_int8pack_mm(
                    x, wts[i % 2], scb), 20)
                log(f"kernel w8_bf16_gemv {label}: torch._weight_int8pack_mm "
                    f"{lms:.4f} ms (max |d| to the plain version "
                    f"{float((yl.float() - rf).abs().max()):.3g}: bf16 "
                    "scales)")
                del wts
            except (RuntimeError, NotImplementedError) as e:
                log(f"kernel w8_bf16_gemv {label}: torch._weight_int8pack_mm "
                    f"has no CUDA kernel in torch {torch.__version__}: "
                    f"{str(e).splitlines()[0][:160]}")
            add_main(s_, ms, pms, bms, by, lms)
        del x, ws, y, ref
    for label, M, K, N, main in W4U_SHAPES:
        x = torch.randint(-127, 128, (M, K), generator=g, device=dev,
                          dtype=torch.int8)
        wps = [torch.randint(-128, 128, (K // 2, N), generator=g, device=dev,
                             dtype=torch.int8) for _ in range(4)]
        ones_m, ones_n = torch.ones(M, device=dev), torch.ones(N, device=dev)
        served = qmm.w4a8_gemv(x, ones_m, wps[0], ones_n, torch.int32)
        if not torch.equal(served, qmm.w4a8_gemv_ref(x, ones_m, wps[0],
                                                     ones_n, torch.int32)):
            raise AssertionError(f"w4a8_gemv [{label}]: int32 differs")
        # the served kernel at the same shape, on the same weight cycle: the
        # yardstick of each unpack in front of the same tensor-core product
        sms_ = cuda_ms(lambda i: qmm.w4a8_gemv(x, ones_m, wps[i % 4], ones_n,
                                               torch.int32), 20)
        nbytes = K // 2 * N + M * K + 4 * M * N
        bms, by = bound(nbytes, 2 * M * K * N, INT8_OPS)
        for v, name in qmm.W4_VARIANTS.items():
            before = qmm.LAUNCHES["w4_unpack_gemv"]
            acc = qmm.w4_unpack_gemv(x, wps[0], v)
            if qmm.LAUNCHES["w4_unpack_gemv"] != before + 1:
                raise AssertionError(f"w4_unpack_gemv {name}: not launched")
            ref = qmm.w4_unpack_gemv_ref(x, wps[0], v)
            torch.cuda.synchronize()
            if not torch.equal(acc, ref) or (v and not torch.equal(acc,
                                                                   served)):
                raise AssertionError(f"w4_unpack_gemv {name} [{label}]: int32 "
                                     "differs")
            # four packed copies (136 MB at the probe's shape) beyond the L2
            ms = cuda_ms(lambda i: qmm.w4_unpack_gemv(x, wps[i % 4], v), 20)
            pms = cuda_ms(lambda i: qmm.w4_unpack_gemv_ref(x, wps[i % 4], v),
                          4, reps=3)
            log(f"kernel w4_unpack_gemv {name:20s} [{label}] M={M} K={K} "
                f"N={N}: int32 bit-equal{' (and to w4a8_gemv)' if v else ''};"
                f" {ms:.4f} ms vs plain {pms:.4f} ms, served w4a8_gemv "
                f"{sms_:.4f} ms ({ms / sms_:.2f}x), library none, bound "
                f"{bms:.4f} ms ({by}); {K // 2 * N / ms / 1e6:.1f} GB/s of "
                "packed weight")
            if main:
                add_main(summary["w4_unpack_gemv"], ms, pms, bms, by, None)
        if main:
            chain_ms = cuda_ms(lambda i: torch.matmul(
                x.to(torch.bfloat16), qmm.unpack_int4_weights(
                    {"w_q": wps[i % 4]}).to(torch.bfloat16)).to(torch.int32),
                4, reps=3)
            log(f"kernel w4_unpack_gemv [{label}]: the unfused torch chain "
                f"(unpack, convert, bf16 torch.matmul) {chain_ms:.4f} ms")
        del x, wps, served
    s = torch.tensor(TAIL_SCALE, device=dev)
    for label, T, n, main in DEQ_SHAPES:
        K = fwht._factors(n)[2]
        # int32 sums and scales that put silu(g)·u near 1: codes spread
        # over the range, a few clip (at the probe's own scales nearly all
        # clip); two copies, 155 MB at T = 1024
        ins = [[torch.randint(-2**20, 2**20, (T, n), generator=g,
                              device=dev, dtype=torch.int32)
                for _ in range(2)] for _ in range(2)]
        gs = torch.rand((n,), generator=g, device=dev) * 2e-6 + 1e-7
        us = torch.rand((n,), generator=g, device=dev) * 2e-6 + 1e-7

        def kern(i):
            return fwht.dequant_swiglu_had_quant(*ins[i % 2], gs, us, s,
                                                 -127, 127)

        def plain(i):
            return fwht.dequant_swiglu_had_quant_ref(*ins[i % 2], gs, us, s,
                                                     -127, 127)

        q, ref = kern(0), plain(0)
        torch.cuda.synchronize()
        worst, frac = tail_diff(q, ref, f"dequant_swiglu_had_quant [{label}]")
        clipped = float((q.abs() == 127).float().mean())
        ms = cuda_ms(kern, 20)
        pms = cuda_ms(plain, 4, reps=3)
        nbytes = 9 * T * n + 8 * n + 2 * (160 * 160 + 128 * 128) + 4
        bms, by = bound(nbytes, 2 * T * n * (K + 128), BF16_FLOPS)
        log(f"kernel dequant_swiglu_had_quant {label:19s} T={T:4d} n={n}: "
            f"codes within {worst}, {frac:.6f} of them differ ({clipped:.4f} "
            f"at ±127); {ms:.4f} ms vs plain {pms:.4f} ms, library none, "
            f"bound {bms:.4f} ms ({by}); {nbytes / ms / 1e6:.1f} GB/s")
        s_ = summary["dequant_swiglu_had_quant"]
        s_["max_abs_err"] = max(s_["max_abs_err"], float(worst))
        if main:
            def chain(i):
                gi, ui = ins[i % 2]
                a = (F.silu(gi.float() * gs) * (ui.float() * us)).to(
                    torch.bfloat16)
                a = fwht.online_hadamard(a)
                return torch.clamp(torch.round(a.float() / TAIL_SCALE), -127,
                                   127).to(torch.int8)

            chain_ms = cuda_ms(chain, 4, reps=3)
            log(f"kernel dequant_swiglu_had_quant {label}: the unfused torch "
                f"chain (dequant, silu·u, online_hadamard, quantize) "
                f"{chain_ms:.4f} ms")
            add_main(s_, ms, pms, bms, by, None)
        del ins, q, ref
    torch.cuda.empty_cache()
    return summary


def sass_functions(lib) -> dict:
    """Phase 2: the SASS of the built library (``cuobjdump -sass``) as
    {function name: [instruction, ...]}; fails without ``cuobjdump``."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        raise AssertionError("sass: cuobjdump not found")
    dump = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    funcs, cur = {}, None
    for line in dump.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            cur.append(m.group(1))
    return funcs


# the tensor-core kernels: the product instruction each must contain (wgmma
# IGMMA / HGMMA, mma.sync IMMA / HMMA) and its copy into shared memory (TMA
# UTMALDG, cp.async LDGSTS)
HOPPER_SASS = {"gemm_tma_kernel": ("IGMMA", "UTMALDG"),
               "flash_causal_kernel": ("HGMMA", "UTMALDG"),
               "gemv_tc_kernel": ("IMMA", "UTMALDG"),
               "w8_bf16_tc_kernel": ("HMMA", "UTMALDG|LDGSTS"),
               "decode_attn_kernel": ("HMMA", "LDGSTS"),
               "tail_kernel": ("HGMMA", "UBLKCP"),
               "fwht_tc_kernel": ("HGMMA", "UBLKCP")}


# gemv_tc_kernel's copy by its W load path (GemvWLoad, the fourth template
# argument): a TMA box, 8-byte cp.async, or none (words the producer's lanes
# load and store themselves)
GEMV_COPY = {"0": "UTMALDG", "1": "LDGSTS", "2": None}


def sass_hopper_kernels(funcs: dict) -> None:
    """Phase 2: counts of the tensor-core product and the shared-memory copy
    instructions (and TMA / bulk copies: ``UTMALDG``, ``UBLKCP``) in each
    instantiation of the tensor-core kernels; fails if one lacks its product
    or its copy, so that a CUDA-core kernel cannot pass for them. The
    tensor-core GEMV's copy follows its W load path (GEMV_COPY)."""
    for kern, (mma, cp_all) in HOPPER_SASS.items():
        hits = {k: v for k, v in funcs.items() if kern in k}
        if not hits:
            raise AssertionError(f"sass: {kern} not found in the library")
        for fn, code in sorted(hits.items()):
            cp = cp_all
            wl = re.search(r"gemv_tc_kernelILi\d+ELb[01]ELi\d+ELi(\d)E", fn)
            if wl:
                cp = GEMV_COPY[wl.group(1)]
            op = lambda name: sum(  # noqa: E731 (a predicate may lead)
                bool(re.match(rf"(@!?U?P\w+\s+)?({name})\b", i))
                for i in code)
            n_mma = op(mma)
            n_cp = op(cp) if cp else None
            extra = "".join(f", {c} {op(c)}" for c in ("UTMALDG", "UBLKCP",
                                                       "LDGSTS")
                            if c not in (cp or "").split("|"))
            log(f"sass: {fn}: {len(code)} instructions, {mma} {n_mma}, "
                + (f"{cp} {n_cp}" if cp else "W by the producer's words")
                + extra)
            if n_mma == 0 or n_cp == 0:
                raise AssertionError(f"sass: {fn} has no {mma} or no {cp}")


def sass_w8_bf16(funcs: dict) -> None:
    """Phase 2: the consumer loop of each instantiation of w8_bf16_gemv's
    tensor-core kernel (the shortest backward branch around its HMMA; a
    listed instruction is 16 bytes): instructions, and the conversion's
    byte permutes, f32 adds and logic ops (PRMT, FADD, LOP3), per weight
    byte of a thread (an HMMA m16n8k16 takes 256 bytes of a warp, 8 a
    thread)."""
    def op(i):
        w = i.split()
        return (w[1] if w[0].startswith("@") else w[0]).split(".")[0]

    for fn, code in sorted((k, v) for k, v in funcs.items()
                           if "w8_bf16_tc_kernel" in k):
        loops = []
        for at, ins in enumerate(code):
            m = re.search(r"\bBRA (0x[0-9a-f]+)", ins)
            if m and int(m.group(1), 16) // 16 < at:
                body = [op(i) for i in code[int(m.group(1), 16) // 16:at + 1]]
                if "HMMA" in body:
                    loops.append(body)
        if not loops:
            raise AssertionError(f"sass: {fn}: no loop around its HMMA")
        body = min(loops, key=len)
        nbytes = 8 * body.count("HMMA")
        conv = sum(body.count(k) for k in ("PRMT", "FADD", "LOP3"))
        log(f"sass: {fn}: consumer loop {len(body)} instructions for "
            f"{nbytes} weight bytes a thread: {len(body) / nbytes:.2f} a "
            f"byte, of them PRMT + FADD + LOP3 {conv / nbytes:.2f}")


def sass_unpack_variants(funcs: dict) -> None:
    """Phase 2: instructions, ``IMMA`` and ``UTMALDG`` per variant of
    w4_unpack_gemv's instantiations of the tensor-core GEMV (one token tile,
    each tail instantiation) beside the served unpack's, and whether P2 (int8
    shifts) and P3 (int32 shifts) compiled to the same code; fails if a
    variant is missing or lacks the tensor-core product or the TMA copy."""

    def code(u, tail):
        key = f"gemv_tc_kernelILi1ELb{tail}ELi{u}E"
        hits = [v for k, v in funcs.items() if key in k]
        if len(hits) != 1:
            raise AssertionError(f"sass: {key} found {len(hits)} times")
        return hits[0]

    def op(c, name):
        return sum(bool(re.match(rf"(@!?U?P\w+\s+)?{name}\b", i)) for i in c)

    # the GemvUnpack enum of qmm.cu: P0 .. P3 = 0 .. 3, the served one 4
    for tail in (0, 1):
        c = {n: code(u, tail) for n, u in
             (("P0", 0), ("P1", 1), ("P2", 2), ("P3", 3), ("served", 4))}
        for n, v in c.items():
            if op(v, "IMMA") == 0 or op(v, "UTMALDG") == 0:
                raise AssertionError(f"sass: {n}, tail {tail}: no IMMA or no "
                                     "UTMALDG")
        same = c["P2"] == c["P3"]
        ndiff = sum(a != b for a, b in zip(c["P2"], c["P3"])) + abs(
            len(c["P2"]) - len(c["P3"]))
        log(f"sass: gemv_tc one token tile, tail {tail}: "
            + ", ".join(f"{n} {len(v)} instructions ({op(v, 'IMMA')} IMMA, "
                        f"{op(v, 'UTMALDG')} UTMALDG)" for n, v in c.items())
            + f"; P2 and P3 {'identical' if same else 'differ'}"
            + ("" if same else f" ({ndiff} instructions)"))


def kernel_modules():
    from mquant_tpu_torch.kernels import attn_decode, flash_attn, fwht, qmm

    return (qmm, attn_decode, flash_attn, fwht)


@contextlib.contextmanager
def plain_kernels(only=None, names=None):
    """Route the integer products and the attention (or only the kernels
    of the modules named in ``only``, or only the kernels named in
    ``names``) through the kernels' plain versions."""
    mods = [m for m in kernel_modules()
            if only is None or m.__name__.rsplit(".", 1)[1] in only]
    saved = [dict(m.KERNELS) for m in mods]
    for m in mods:
        m.KERNELS.update({k: f for k, f in m.PLAIN.items()
                          if names is None or k in names})
    try:
        yield
    finally:
        for m, sv in zip(mods, saved):
            m.KERNELS.update(sv)


def reset_launches():
    for m in kernel_modules():
        for k in m.LAUNCHES:
            m.LAUNCHES[k] = 0


def read_launches(path: str, needed) -> dict:
    """The launch counts since :func:`reset_launches`; fails if a kernel of
    ``needed`` never launched on this path."""
    counts = {k: n for m in kernel_modules() for k, n in m.LAUNCHES.items()}
    log(f"{path}: launches {counts}")
    missing = [k for k in needed if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{path}: kernels never launched: {missing}")
    return counts


PROBE_CHAIN = 16  # chained steps per timed probe segment
# kernels the probes must launch
PROBE_KERNELS = ("rms_norm_quant", "had_quant", "fwht_two_matmul",
                 "fused_swiglu_had_quant", "int8_gemm", "flash_attn_causal")


def run_probe(seed: int, card: str) -> dict:
    """Phase 4, the probes (``mquant_tpu_torch.scripts``): every segment of
    the T = 1024 prefill probe at Qwen2-VL-7B widths (PROBE_CHAIN chained
    steps in one CUDA graph, device ms per step), then the int8 rate probe
    at (1024, 3584, 19968) with its int32 output bit-equal to
    ``torch._int_mm``'s. Launch counts cover the two (wrapper calls:
    warm-up, capture and the eager checks; graph replays launch without
    them). Then each fused segment against its unfused twin. Returns the
    launch counts."""
    import torch

    from mquant_tpu_torch.scripts import mxu_rate
    from mquant_tpu_torch.scripts import prefill_probe as PP

    with torch.no_grad():
        probe = PP.Probe(PP.ProbeConfig(), "cuda", seed)
        reset_launches()
        times = PP.run(probe, PROBE_CHAIN, timed=True,
                       log=lambda s: log(f"probe: {s}"))
        mxu_rate.run(seed=seed, log=lambda s: log(f"mxu_rate: {s}"))
        launches = read_launches("probe", PROBE_KERNELS)
        PP.check_twins(probe, log=lambda s: log(f"probe: {s}"))
    log(f"probe: T={probe.cfg.T}, chain {PROBE_CHAIN}: the segments sum to "
        f"{sum(times.values()):.4f} ms per step; card {card}")
    del probe
    torch.cuda.empty_cache()
    return launches


MLP_CHAIN = 4  # chained MLP steps per timed mlp_variants line
# kernels the decode probes must launch
DECODE_PROBE_KERNELS = ("w8_bf16_gemv", "w4_unpack_gemv",
                        "dequant_swiglu_had_quant", "int8_gemm", "int8_gemv",
                        "w4a8_gemv")


def run_decode_probes(seed: int, card: str) -> dict:
    """Phase 4, the decode-rate probes (``mquant_tpu_torch.scripts``):
    ``gemv_bench`` (M = 8 against (3584, 19968): five lines, 16 chained
    steps in one CUDA graph, the kernel line held against the torch line),
    ``w4_unpack_tune`` (8 stacked (9472, 3584) packed layers at M = 8: µs
    per layer of the torch line, the served W4 GEMV and P0-P3, which are
    then held bit-equal) and ``mlp_variants`` at T = 1024 (bf16, int8, fp8
    and the two epilogue prototypes, MLP_CHAIN chained MLPs per line; the
    fused epilogue's MLP held against the unfused one), counted as one path
    that must launch DECODE_PROBE_KERNELS (wrapper calls: warm-up, capture
    and the eager checks). Returns the launch counts."""
    import torch

    from mquant_tpu_torch.scripts import gemv_bench as GB
    from mquant_tpu_torch.scripts import mlp_variants as MV
    from mquant_tpu_torch.scripts import w4_unpack_tune as WU

    t0 = time.perf_counter()
    with torch.no_grad():
        gb, wu = GB.Bench(seed=seed), WU.Bench(seed=seed)
        mw = MV.Weights(seed=seed)
        reset_launches()
        GB.run(gb, log=lambda s: log(f"gemv_bench: {s}"))
        GB.check(gb, log=lambda s: log(f"gemv_bench: {s}"))
        WU.run(wu, log=lambda s: log(f"w4_unpack_tune: {s}"))
        WU.check(wu, log=lambda s: log(f"w4_unpack_tune: {s}"))
        MV.run(mw, chain=MLP_CHAIN, proto=True,
               log=lambda s: log(f"mlp_variants: {s}"))
        MV.check_fused(mw, log=lambda s: log(f"mlp_variants: {s}"))
        launches = read_launches("decode probes", DECODE_PROBE_KERNELS)
    log(f"decode probes: {time.perf_counter() - t0:.1f} s; card {card}")
    del gb, wu, mw
    torch.cuda.empty_cache()
    return launches


PREFILL = 1024  # the full-VLM request of bench.py: 1024-token prompt
GEN_TOKENS = 128  # + 128 greedy tokens
TEXT_PROMPTS = (300, 77)  # two text-only requests of different lengths
TEXT_TOKENS = 64
DOC_SIDE, DOC_PROMPT, DOC_TOKENS = 896, 4096, 128  # the document request
BATCH_PROMPTS, BATCH_TOKENS = (300, 77, 1000, 513), 64  # the ragged batch
N_CMP = 8  # greedy steps compared with the plain-kernel run
# logits held where two runs should agree: max |Δ| ≤ LOGIT_RTOL · max |ref|
LOGIT_RTOL = 1e-2
# The integer kernels' int32 accumulators are bit-equal to their plain
# versions'; the attention kernels round the probabilities to bf16 at other
# points. These random weights meet coarse static int8 activation scales (0.05
# for attention outputs of magnitude ~0.2), so a rounding difference flips
# int8 codes and grows through the layers: the depth-28 logits of two runs
# that round differently are far outside any useful bound. So
# each path is held against a run with the integer products through their
# plain versions and the (deterministic) attention kernels on both sides:
# prefill and decode logits equal (max |d| 0 expected), greedy tokens equal;
# and every attention kernel call against its plain version on the call's
# own inputs (shadow_attention). A ragged batch row against the row alone
# (the einsum's masked pad columns, other reduction lengths) is held through
# the first CMP_LAYERS layers: last-token prefill logits within the bound
# (max |d| 0) and all N_CMP greedy tokens equal. One layer is the deepest
# cut that can agree exactly: its output hidden states already differ at
# some positions (an int8 activation code that rounded otherwise; printed),
# which the next layer spreads to the last token's logits.
CMP_LAYERS = 1
# kernels each path must launch
SLICE_KERNELS = ("w4a8_gemv", "int8_gemv", "int8_gemm", "attn_decode")
DOC_KERNELS = SLICE_KERNELS + ("flash_attn_causal",)
BATCH_KERNELS = SLICE_KERNELS
FULL_KERNELS = SLICE_KERNELS + ("fused_swiglu_had_quant",)
FS_DEPTH = 4  # paths F and S: the block model's first layers (28 until the
# tp phase, which holds both routes at tp = 2, made room for itself)
# path S: its K = 18943 `down` runs on the TMA GEMM (int8_gemm) since the K
# tail; int8_gemm_ragged must launch no time there (run_split checks both)
SPLIT_KERNELS = SLICE_KERNELS
# path F's text request (bucket 128, below the tail's 256, on the default
# route): two tokens show the route and the loop at that shape
FULL_TEXT, FULL_TEXT_TOKENS = 77, 2


def check_close(what: str, out, ref, quiet: bool = False) -> float:
    """max |out − ref| ≤ LOGIT_RTOL · max |ref|, finite, same shape; returns
    max |out − ref|."""
    import torch

    out, ref = out.float(), ref.float()
    if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{what}: shape {tuple(out.shape)} vs "
                             f"{tuple(ref.shape)} or non-finite values")
    err = float((out - ref).abs().max())
    mag = float(ref.abs().max())
    if not quiet or err > LOGIT_RTOL * mag:
        log(f"{what}: max |d| {err:.3g} (max |ref| {mag:.3g}, bound "
            f"{LOGIT_RTOL} x max |ref|)")
    if err > LOGIT_RTOL * mag:
        raise AssertionError(f"{what}: outside the bound")
    return err


@contextlib.contextmanager
def shadow_attention(path: str):
    """Every attention kernel call also runs the kernel's plain version on
    copies of the same inputs and is held against it: output within
    ATTN_RTOL of the plain version's largest magnitude, written cache rows
    bit-equal. Only plain versions run beside, so launch counts are
    untouched."""
    import torch

    from mquant_tpu_torch.kernels import attn_decode as TA
    from mquant_tpu_torch.kernels import flash_attn as TF

    kd, kf = TA.KERNELS["attn_decode"], TF.KERNELS["flash_attn_causal"]
    worst = {"attn_decode": [0, 0.0], "flash_attn_causal": [0, 0.0]}

    def held(name, out, ref):
        w = worst[name]
        w[0] += 1
        err, _, mag = _attn_err(out, ref, f"{path}: {name} call {w[0]}")
        w[1] = max(w[1], err / mag)

    def decode(q, kn, vn, kc, vc, pos, scale, start=None):
        kc_p, vc_p = kc.clone(), vc.clone()
        ref, _, _ = TA.PLAIN["attn_decode"](q, kn, vn, kc_p, vc_p, pos, scale,
                                            start=start)
        out = kd(q, kn, vn, kc, vc, pos, scale, start=start)
        if not (same_bits(kc, kc_p) and same_bits(vc, vc_p)):
            raise AssertionError(f"{path}: attn_decode cache rows differ")
        held("attn_decode", out[0], ref)
        return out

    def flash(q, k, v, scale):
        out = kf(q, k, v, scale)
        held("flash_attn_causal", out, TF.PLAIN["flash_attn_causal"](
            q, k, v, scale))
        return out

    TA.KERNELS["attn_decode"], TF.KERNELS["flash_attn_causal"] = decode, flash
    try:
        yield
    finally:
        TA.KERNELS["attn_decode"], TF.KERNELS["flash_attn_causal"] = kd, kf
    log(f"{path}: every attention kernel call held against its plain "
        "version on its own inputs: "
        + (", ".join(f"{k} {n} calls, max |d| {r:.3g} of max |plain|"
                     for k, (n, r) in worst.items() if n) or "none made"))


@contextlib.contextmanager
def shadow_tail(path: str):
    """Every fused tail kernel call also runs the kernel's plain version on
    the same inputs and is held against it (:func:`tail_diff`). Only the
    plain version runs beside, so launch counts are untouched."""
    from mquant_tpu_torch.kernels import fwht

    name = "fused_swiglu_had_quant"
    kern = fwht.KERNELS[name]
    seen = [0, 0, 0.0]  # calls, worst |difference|, worst fraction

    def held(g, u, scale):
        q = kern(g, u, scale)
        seen[0] += 1
        worst, frac = tail_diff(q, fwht.PLAIN[name](g, u, scale),
                                f"{path}: {name} call {seen[0]}")
        seen[1], seen[2] = max(seen[1], worst), max(seen[2], frac)
        return q

    fwht.KERNELS[name] = held
    try:
        yield
    finally:
        fwht.KERNELS[name] = kern
    log(f"{path}: every {name} call held against its plain version on its "
        f"own inputs: {seen[0]} calls, codes within {seen[1]}, at most "
        f"{seen[2]:.6f} of them differ")


@contextlib.contextmanager
def gemm_depths(store: list):
    """Appends (kernel, K, the launch counts it moved) of every int8_gemv /
    int8_gemm call to ``store`` (the wrappers still count their
    launches)."""
    from mquant_tpu_torch.kernels import qmm

    saved = {k: qmm.KERNELS[k] for k in ("int8_gemv", "int8_gemm")}

    def recorder(name):
        def call(xq, *a, **kw):
            before = dict(qmm.LAUNCHES)
            out = saved[name](xq, *a, **kw)
            store.append((name, xq.shape[-1], tuple(
                k for k, v in qmm.LAUNCHES.items() if v != before[k])))
            return out
        return call

    qmm.KERNELS.update({k: recorder(k) for k in saved})
    try:
        yield
    finally:
        qmm.KERNELS.update(saved)


def against_plain(path: str, gen, prefill, attn_start=None, names=None,
                  exact: bool = False):
    """The kernel run's prefill (``prefill()`` → (logits (B, V), cache)) and
    N_CMP − 1 greedy steps under :func:`shadow_attention`, each held against
    the same prefill or step (from a copy of the kernel run's cache) with the
    integer products (or only the qmm kernels in ``names``) through their
    plain versions: logits within the bound (equal where ``exact``) and the
    same greedy tokens."""
    import torch

    what_plain = ("plain qmm" if names is None
                  else "plain " + " / ".join(names))

    def held(what, out, ref, quiet=False):
        err = check_close(what, out, ref, quiet)
        if exact and err != 0:
            raise AssertionError(f"{what}: logits differ (max |d| {err})")
        return err

    with shadow_attention(path):
        logits_k, cache = prefill()
        with plain_kernels(("qmm",), names):
            held(f"{path}: prefill logits vs {what_plain}", logits_k,
                 prefill()[0])
        worst = 0.0
        for step in range(1, N_CMP):
            tok = logits_k.argmax(dim=-1).to(torch.int32)[:, None]
            copy_p = {n: t.clone() if isinstance(t, torch.Tensor) else t
                      for n, t in cache.items()}
            with plain_kernels(("qmm",), names):
                logits_p = gen._forward(tok, copy_p, attn_start=attn_start)[
                    0][:, -1]
            lk, cache = gen._forward(tok, cache, attn_start=attn_start)
            logits_k = lk[:, -1]
            what = f"{path}: decode step {step} logits vs {what_plain}"
            worst = max(worst, held(what, logits_k, logits_p, True))
            if not torch.equal(logits_k.argmax(-1), logits_p.argmax(-1)):
                raise AssertionError(f"{what}: greedy tokens differ")
    log(f"{path}: {N_CMP - 1} decode steps vs {what_plain}: logits max |d| "
        f"{worst:.3g}, greedy tokens equal")


@contextlib.contextmanager
def layer_outputs(store: list):
    """Appends every decoder layer's output hidden states to ``store``."""
    from mquant_tpu_torch.models import llm

    step = llm._layer_step

    def recorded(*a, **kw):
        h = step(*a, **kw)
        store.append(h)
        return h

    llm._layer_step = recorded
    try:
        yield
    finally:
        llm._layer_step = step


def depth_cut(gen, n: int):
    """``gen`` with only its first ``n`` decoder layers: the weights and the
    quant state are views of the same tensors."""
    import torch

    from mquant_tpu_torch.models.llm import LLM_SITES

    def cut(t):
        if isinstance(t, dict):
            return {k: cut(v) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(None if v is None else cut(v) for v in t))
        return t[:n] if isinstance(t, torch.Tensor) else t

    sites = {"llm." + s for s in LLM_SITES}
    g = copy.copy(gen)
    g._kv, g._loops = {}, {}  # decode loops of its own depth
    g.cfg = dataclasses.replace(gen.cfg, n_layers=n)
    g.params = {**gen.params, "layers": cut(gen.params["layers"])}
    g.state = {k: cut(v) if k in sites else v for k, v in gen.state.items()}
    return g


def check_tokens(path: str, out, n: int, vocab: int):
    import torch

    out = torch.as_tensor(out)
    if out.shape[-1] != n or int(out.min()) < 0 or int(out.max()) >= vocab:
        raise AssertionError(f"{path}: bad generated tokens "
                             f"{tuple(out.shape)}")


def build_model(seed: int) -> dict:
    """Qwen2-VL-7B widths, depth 28, seeded W4A8 LLM + W8A8 vision tower."""
    import torch

    from mquant_tpu_torch import random_init as R
    from mquant_tpu_torch.models.qwen2vl import Qwen2VLConfig
    from mquant_tpu_torch.serve.generate import Generator

    dev = torch.device("cuda")
    vcfg = Qwen2VLConfig.qwen2vl_7b()
    cfg = vcfg.llm
    g = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params, state = R.init_w4a8(cfg, g, dev)
    vp, mp, vstate = R.init_vision_w8a8(vcfg.vit, vcfg.merger, g, dev)
    gen = Generator(cfg, params, specs=R.llm_specs(), state=state,
                    mode="real", max_len=PREFILL + GEN_TOKENS)
    del params
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    log(f"slice: Qwen2-VL-7B widths, depth {cfg.n_layers}, W4A8 LLM + W8A8 vision "
        f"built in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return dict(gen=gen, vcfg=vcfg, vp=vp, mp=mp, vstate=vstate,
                vspecs=R.vision_specs(), g=g, dev=dev)


def image_request(m: dict, side: int, prefill: int):
    """(embeds() → (spliced prompt embeddings, merger output), tokens) of a
    request with one side × side image in a ``prefill``-token prompt."""
    from mquant_tpu_torch import random_init as R
    from mquant_tpu_torch.models.qwen2vl import splice_image_embeds
    from mquant_tpu_torch.models.vision import merger_forward, vit_forward

    vcfg, gen = m["vcfg"], m["gen"]
    patches, grid, toks = R.vlm_inputs(vcfg.image_token_id,
                                       vcfg.vit.patch_dim, prefill, m["g"],
                                       m["dev"], side=side)

    def embeds():
        feats, _ = vit_forward(vcfg.vit, m["vp"], patches, m["vspecs"],
                               m["vstate"], "real", grid_hw=grid)
        merged, _ = merger_forward(vcfg.merger, m["mp"], feats, m["vspecs"],
                                   m["vstate"], "real")
        emb = gen.params["embed"]["w"][toks]
        return splice_image_embeds(emb, toks, merged,
                                   vcfg.image_token_id), merged

    return embeds, toks


def timed(request, at_first=None):
    """(``request(mark)``'s result, request s, TTFT s): the clock stamped
    where the request calls ``mark`` with its first token, after a
    synchronize (then ``at_first()`` is called, if given)."""
    import torch

    first = []

    def mark(_tok):
        torch.cuda.synchronize()
        first.append(time.perf_counter())
        if at_first is not None:
            at_first()

    t0 = time.perf_counter()
    out = request(mark)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, first[0] - t0


def timed_request(gen, x, n: int, at_first=None, **kw):
    """One request through ``generate_on_device``, :func:`timed`; ``x`` the
    prompt or a function that makes it (inside the timed span)."""
    return timed(lambda mark: gen.generate_on_device(
        x() if callable(x) else x, max_new_tokens=n, on_first_token=mark,
        **kw), at_first)


EOS_PROMPTS, EOS_TOKENS = (300, 77), 32  # graph decode's 2-row eos batch


def poison(gen):
    """NaN into every KV buffer of ``gen``'s decode loops (an int8 / int4
    cache: NaN scales and zero points, the largest codes): a request must
    read only the rows its prefill and steps write (ROADMAP C-w1)."""
    for kv in gen._kv.values():
        for t in kv.values():
            t.fill_(float("nan") if t.is_floating_point() else 127)


def eos_pick(rows):
    """An eos id at which the rows' free-running tokens stop at different
    steps, and those steps: one that every row meets if there is one (the
    loop then exits early), else one that some row never meets (that row
    runs to the end)."""
    cands = []
    for row in rows:
        for t in row[1:]:
            firsts = [r.index(t) if t in r else len(r) for r in rows]
            if len(set(firsts)) > 1 and min(firsts) < len(row) - 1:
                cands.append((max(firsts) >= len(row), t, firsts))
    if not cands:
        raise AssertionError(f"no eos id stops the rows at different "
                             f"steps: {rows}")
    _, t, firsts = min(cands, key=lambda c: c[0])
    return t, firsts


def graph_matches_eager(path: str, gen, x, m: dict, eos_batch: bool = True):
    """Phase 4, graph decode (``serve.generate.DecodeLoop``: one greedy step
    captured in a CUDA graph, one replay a token) with every KV buffer of
    the loops poisoned first (NaN): the request ``x`` through the loop
    against the eager reference ``_decode_loop`` from its own prefill (all
    GEN_TOKENS tokens equal, last-step logits max |d| 0), then, unless
    ``eos_batch`` is False, a 2-row ``generate_batch`` with an eos id at
    which the rows stop at different steps against the eager loop (tokens
    equal). Returns the loop."""
    import torch

    poison(gen)
    out = gen.generate_on_device(x, GEN_TOKENS)
    loop = gen._loop(1, None, False)
    logits_g = loop.logits.clone()
    lg, cache = gen.prefill(x)
    tok = lg.argmax(-1).to(torch.int32)[:, None]
    ref, logits_e = gen._decode_loop(tok, cache, GEN_TOKENS, None,
                                     with_logits=True)
    err = float((logits_g.float() - logits_e.float()).abs().max())
    if not torch.equal(out, ref) or err != 0:
        raise AssertionError(f"{path}: graph decode tokens equal to eager: "
                             f"{torch.equal(out, ref)}; last-step logits "
                             f"max |d| {err}")
    eos_txt = "no eos batch"
    if eos_batch:
        V = gen.cfg.vocab
        seqs = [torch.randint(0, V, (n,), generator=m["g"], device=m["dev"])
                for n in EOS_PROMPTS]
        eos, firsts = eos_pick(gen.generate_batch(seqs, EOS_TOKENS))
        poison(gen)
        got = gen.generate_batch(seqs, EOS_TOKENS, eos_id=eos)
        lb, cb, starts = gen.prefill_batch(seqs)
        tb = lb.argmax(-1).to(torch.int32)[:, None]
        ref_b = gen._decode_loop(tb, cb, EOS_TOKENS, eos,
                                 attn_start=starts).tolist()
        ref_b = [r[:r.index(eos)] if eos in r else r for r in ref_b]
        if got != ref_b:
            raise AssertionError(f"{path}: graph eos batch {got} vs eager "
                                 f"{ref_b}")
        eos_txt = (f"eos batch ({len(seqs)} rows of {EOS_PROMPTS} tokens, "
                   f"eos {eos} at steps {firsts}) equal to the eager loop")
    log(f"{path}: graph decode: {GEN_TOKENS} tokens equal to the eager loop,"
        f" last-step logits max |d| {err}; {eos_txt}; every KV buffer "
        "poisoned (NaN) before each request")
    return loop


def graph_step_runs(gen, x, loop, n_runs: int) -> tuple:
    """(wall, host enqueue, stream (CUDA events)) ms a step of ``n_runs``
    runs of GEN_TOKENS − 1 replays of ``loop`` on ``x``'s prefill, each
    synchronized at both ends; with the prefill's (token, cache)."""
    import torch

    lg, cache = gen.prefill(x, kv=loop.kv)
    tok = lg.argmax(-1).to(torch.int32)[:, None]
    steps = GEN_TOKENS - 1
    runs = []
    for _ in range(n_runs):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        loop.run(tok, cache, GEN_TOKENS)
        t1 = time.perf_counter()
        ev[1].record()
        torch.cuda.synchronize()
        runs.append(((time.perf_counter() - t0) * 1e3 / steps,
                     (t1 - t0) * 1e3 / steps,
                     ev[0].elapsed_time(ev[1]) / steps))
    return runs, tok, cache


def graph_decode(path: str, gen, x, m: dict, card: str) -> float:
    """Phase 4, graph decode: :func:`graph_matches_eager`, then, a step:
    the wall time, host enqueue time and stream time (CUDA events) of
    GEN_TOKENS − 1 replays (the median of 3 runs), the device busy time of
    PROFILE_STEPS replays under torch.profiler (not measured where it sees
    no kernel) and the idle share against the median wall, and
    ``measure_decode_tps``'s rate on the same request. Returns the step's
    median wall ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mquant_tpu_torch.serve.generate import measure_decode_tps

    loop = graph_matches_eager(path, gen, x, m)
    runs, tok, cache = graph_step_runs(gen, x, loop, 3)
    wall, enq, stream = sorted(runs)[len(runs) // 2]  # the median run
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loop.run(tok, cache, PROFILE_STEPS + 1)
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / PROFILE_STEPS
    busy_s = (f"device busy {busy:.3f} ms under torch.profiler "
              f"({PROFILE_STEPS} replays), idle share 1 − busy / median wall "
              f"{1 - busy / wall:.3f}" if busy > 0 else
              "device busy not measured (the profiler saw no kernel of the "
              "graph)")
    steps = GEN_TOKENS - 1
    tps = measure_decode_tps(gen, x, n_tokens=steps)
    log(f"profile: decode step, graph ({path}): wall {wall:.3f} ms a step "
        f"(median of 3 runs of {steps} replays, synchronized at both ends; "
        f"all {', '.join(f'{r[0]:.3f}' for r in runs)}), host enqueue "
        f"{enq:.3f} ms a step, stream {stream:.3f} ms a step (CUDA events); "
        f"{busy_s}; measure_decode_tps {tps:.1f} tok/s; card {card}")
    return wall


def run_slice(m: dict, card: str) -> dict:
    """Phase 4. Serves one full-VLM and two text requests at Qwen2-VL-7B
    widths; returns the kernel launch counts of that main-path run."""
    import torch

    gen = m["gen"]
    cfg = gen.cfg
    embeds, _ = image_request(m, 448, PREFILL)
    texts = [torch.randint(0, cfg.vocab, (1, n), generator=m["g"],
                           device=m["dev"]) for n in TEXT_PROMPTS]
    with torch.no_grad():
        # warm-up request (allocator, cuBLAS handles); not counted
        gen.generate_on_device(embeds()[0], max_new_tokens=4)
        torch.cuda.synchronize()

        # the main path, counted: one full-VLM request + two text requests
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        held = {}

        def vlm():
            held["emb"], held["merged"] = embeds()
            return held["emb"]

        out_vlm, t_req, ttft = timed_request(gen, vlm, GEN_TOKENS)
        decode_tps = (GEN_TOKENS - 1) / (t_req - ttft)
        outs_txt, t_txt = [], []
        for t in texts:
            o, s, _ = timed_request(gen, t, TEXT_TOKENS)
            outs_txt.append(o)
            t_txt.append(s)
        launches = read_launches("slice", SLICE_KERNELS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        check_tokens("slice", out_vlm, GEN_TOKENS, cfg.vocab)
        for o in outs_txt:
            check_tokens("slice", o, TEXT_TOKENS, cfg.vocab)

        # the same forward with the kernels' plain versions on the card
        emb = held["emb"]
        with plain_kernels():
            merged_p = embeds()[1]
        check_close("slice: merger out vs plain kernels", held["merged"],
                    merged_p)
        against_plain("slice", gen, lambda: gen.prefill(emb))
        step = graph_decode("slice", gen, emb, m, card)
    m["block_row"] = {"request_s": t_req, "ttft_s": ttft,
                      "decode_tok_s": decode_tps, "graph_step_ms": step}
    log(f"slice: full-VLM request (448² image, {PREFILL}-token prompt, "
        f"{GEN_TOKENS} tokens) {t_req:.3f} s; TTFT {ttft * 1e3:.1f} ms; "
        f"decode {decode_tps:.1f} tok/s; text requests "
        f"{', '.join(f'{n} tok + {TEXT_TOKENS}: {s:.3f} s' for n, s in zip(TEXT_PROMPTS, t_txt))}; "
        f"peak {peak:.2f} GiB; card {card}")

    with torch.no_grad():
        profile_phases([("vision", embeds, 1),
                        ("prefill", lambda: gen.prefill(emb), 1),
                        ("decode step", decode_steps(gen, gen.prefill(emb)[1]),
                         PROFILE_STEPS)], card)
    return launches


@contextlib.contextmanager
def fused_tail():
    """``MQUANT_FUSED_TAIL=1`` inside (the fused tail's opt-in route, as
    JAX's), restored after."""
    prev = os.environ.get("MQUANT_FUSED_TAIL")
    os.environ["MQUANT_FUSED_TAIL"] = "1"
    try:
        yield
    finally:
        if prev is None:
            del os.environ["MQUANT_FUSED_TAIL"]
        else:
            os.environ["MQUANT_FUSED_TAIL"] = prev


def run_full(m: dict, card: str) -> dict:
    """Phase 4, path F: the full online Hadamard before ``down`` on the same
    weights. The full-VLM request and a 77-token text request on the
    default route (the unfused chain, JAX's default: no tail launch), then
    the request's 1024-token prefill with ``MQUANT_FUSED_TAIL=1`` (the
    fused tail: one launch a layer, each call held against its plain
    version). Returns the launch counts of the three; holds the default
    route against plain, checks the graph decode loop, profiles the prefill
    on both routes and a decode step."""
    import torch

    from mquant_tpu_torch import random_init as R
    from mquant_tpu_torch.kernels import fwht
    from mquant_tpu_torch.serve.generate import Generator

    base = depth_cut(m["gen"], FS_DEPTH)
    cfg = base.cfg
    gen = Generator(cfg, base.params, specs=R.llm_specs("full"),
                    state=base.state, mode="real",
                    max_len=PREFILL + GEN_TOKENS)
    embeds, _ = image_request(m, 448, PREFILL)
    text = torch.randint(0, cfg.vocab, (1, FULL_TEXT), generator=m["g"],
                         device=m["dev"])
    tail = fwht.LAUNCHES
    name = "fused_swiglu_had_quant"
    with torch.no_grad():
        # warm-up at both prefill shapes and on the fused route; not counted
        gen.generate_on_device(embeds()[0], max_new_tokens=4)
        gen.generate_on_device(text, max_new_tokens=2)
        with fused_tail():
            gen.prefill(embeds()[0])
        torch.cuda.synchronize()

        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        held = {}

        def vlm():
            held["emb"], held["merged"] = embeds()
            return held["emb"]

        out_vlm, t_req, ttft = timed_request(gen, vlm, GEN_TOKENS)
        out_txt, t_txt, _ = timed_request(gen, text, FULL_TEXT_TOKENS)
        on_default = tail[name]
        emb = held["emb"]
        with fused_tail(), shadow_tail("full, fused tail"):
            gen.prefill(emb)
        launches = read_launches("full", FULL_KERNELS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        if (on_default, launches[name]) != (0, cfg.n_layers):
            raise AssertionError(
                f"full: tail launches {on_default} on the default route, "
                f"{launches[name] - on_default} in the {PREFILL}-token "
                f"prefill with MQUANT_FUSED_TAIL=1; expected 0, "
                f"{cfg.n_layers}")
        check_tokens("full", out_vlm, GEN_TOKENS, cfg.vocab)
        check_tokens("full", out_txt, FULL_TEXT_TOKENS, cfg.vocab)
        against_plain("full", gen, lambda: gen.prefill(emb))
        graph_decode("full", gen, emb, m, card)
    log(f"full: full-VLM request ({PREFILL}-token prompt, {GEN_TOKENS} "
        f"tokens, default route: the unfused chain) {t_req:.3f} s; TTFT "
        f"{ttft * 1e3:.1f} ms; decode {(GEN_TOKENS - 1) / (t_req - ttft):.1f}"
        f" tok/s; text request {FULL_TEXT} tok + {FULL_TEXT_TOKENS}: "
        f"{t_txt:.3f} s; tail launches 0 on the default route, "
        f"{launches[name]} in one prefill with MQUANT_FUSED_TAIL=1; peak "
        f"{peak:.2f} GiB; card {card}")
    with torch.no_grad():
        profile_phases([("prefill 1024 (full Hadamard)",
                         lambda: gen.prefill(emb), 1)], card)
        with fused_tail():
            profile_phases([("prefill 1024 (full Hadamard, "
                             "MQUANT_FUSED_TAIL=1)",
                             lambda: gen.prefill(emb), 1)], card)
        profile_phases([("decode step (full Hadamard)",
                         decode_steps(gen, gen.prefill(emb)[1]),
                         PROFILE_STEPS)], card)
    return launches


def run_split(m: dict, card: str) -> dict:
    """Phase 4, path S: path F plus the RMS first-column split (``down`` as
    18943 int8 rows and an f32 ``w_col0``; the pipeline's default artifact).
    The full-VLM request; ``down`` runs through ``int8_gemm`` at prefill (the
    TMA kernel, on codes the split's quantizer writes in padded rows: 28
    launches, none of ``int8_gemm_ragged``) and ``int8_gemv`` in decode at
    K = 18943. Then the prefill with ``down`` forced onto
    ``int8_gemm_ragged`` (28 launches, outside the returned counts) is held
    against plain as the served one is. Returns the launch counts; profiles
    the prefill (beside it with ``down`` on the ragged kernel) and a decode
    step."""
    import torch

    from mquant_tpu_torch import random_init as R
    from mquant_tpu_torch.kernels import qmm
    from mquant_tpu_torch.serve.generate import Generator

    # the artifact phase serves the whole depth's split down; this phase
    # runs its first FS_DEPTH layers
    m["split_down"] = R.init_split_down(m["gen"].cfg, m["g"], m["dev"])
    base = depth_cut(m["gen"], FS_DEPTH)
    cfg = base.cfg
    down = {k: v[:FS_DEPTH] if isinstance(v, torch.Tensor) else v
            for k, v in m["split_down"].items()}
    params = {**base.params, "layers": {**base.params["layers"],
                                        "down": down}}
    gen = Generator(cfg, params, specs=R.llm_specs("full", split=True),
                    state=base.state, mode="real",
                    max_len=PREFILL + GEN_TOKENS)
    del params
    K = cfg.inter_eff - 1
    embeds, _ = image_request(m, 448, PREFILL)
    with torch.no_grad():
        gen.generate_on_device(embeds()[0], max_new_tokens=4)  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        held, depths = {}, []

        def vlm():
            held["emb"], held["merged"] = embeds()
            return held["emb"]

        with gemm_depths(depths):  # the prefill's calls (decode replays)
            out, t_req, ttft = timed_request(gen, vlm, GEN_TOKENS)
        launches = read_launches("split", SPLIT_KERNELS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        emb = held["emb"]
        # the request's GEMM calls (its prefill's), and the int8_gemv calls
        # of one eager decode step
        step = [d for d in depths if d[0] == "int8_gemm"]
        lg, cache = gen.prefill(emb)
        with gemm_depths(step):
            gen._forward(lg.argmax(-1).to(torch.int32)[:, None], cache)
        down = {k: sum(1 for n, d, moved in step if n == k and d == K
                       and moved == (k,))
                for k in ("int8_gemm", "int8_gemv")}
        want = {"int8_gemm": cfg.n_layers, "int8_gemv": cfg.n_layers}
        # the request's int8_gemv launches: the prefill's head, then down
        # and the head each step (the decode loop's replays)
        gemv = (cfg.n_layers + 1) * (GEN_TOKENS - 1) + 1
        if (down != want or launches["fused_swiglu_had_quant"]
                or launches["int8_gemm_ragged"]
                or launches["int8_gemv"] != gemv):
            raise AssertionError(f"split: down calls at K = {K} {down} (the "
                                 f"prefill, one eager step), expected {want};"
                                 f" int8_gemv launches {launches['int8_gemv']}"
                                 f", expected {gemv}; tail launches "
                                 f"{launches['fused_swiglu_had_quant']}, "
                                 f"int8_gemm_ragged "
                                 f"{launches['int8_gemm_ragged']}, expected 0")
        check_tokens("split", out, GEN_TOKENS, cfg.vocab)
        against_plain("split", gen, lambda: gen.prefill(emb))
        # the one decoder path through the ragged kernel: `down` forced
        # onto it, held against plain in the same way
        before = qmm.LAUNCHES["int8_gemm_ragged"]
        with ragged_route():
            against_plain("split, down on int8_gemm_ragged", gen,
                          lambda: gen.prefill(emb))
        forced = qmm.LAUNCHES["int8_gemm_ragged"] - before
        if forced != cfg.n_layers:
            raise AssertionError(f"split: down forced onto int8_gemm_ragged "
                                 f"launched it {forced} times, expected "
                                 f"{cfg.n_layers}")
        graph_decode("split", gen, emb, m, card)
    m["split_request"] = (t_req, ttft, (GEN_TOKENS - 1) / (t_req - ttft))
    log(f"split: full-VLM request ({PREFILL}-token prompt, {GEN_TOKENS} "
        f"tokens) {t_req:.3f} s; TTFT {ttft * 1e3:.1f} ms; decode "
        f"{(GEN_TOKENS - 1) / (t_req - ttft):.1f} tok/s; down calls at K "
        f"= {K}: {down} (prefill, one eager step), int8_gemv launches "
        f"{launches['int8_gemv']}, int8_gemm_ragged 0 (forced: {forced} in "
        f"one prefill); peak {peak:.2f} GiB; card {card}")
    with torch.no_grad():
        profile_phases([("prefill 1024 (full Hadamard + RMS split)",
                         lambda: gen.prefill(emb), 1)], card)
        with ragged_route():
            profile_phases([("prefill 1024 (full Hadamard + RMS split), down "
                             "on int8_gemm_ragged", lambda: gen.prefill(emb),
                             1)], card)
        profile_phases([("decode step (full Hadamard + RMS split)",
                         decode_steps(gen, gen.prefill(emb)[1]),
                         PROFILE_STEPS)], card)
    del gen
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def ragged_route():
    """``int8_gemm`` calls at a K that is no multiple of 16 (path S's
    ``down``) go to the ragged kernel, on the padded rows the split's
    quantizer writes (the comparison of path S's prefill in one run)."""
    from mquant_tpu_torch.kernels import qmm

    gemm = qmm.KERNELS["int8_gemm"]

    def forced(xq, *a, **kw):
        if xq.shape[-1] % 16:
            return qmm.int8_gemm_ragged(xq, *a, **kw)
        return gemm(xq, *a, **kw)

    qmm.KERNELS["int8_gemm"] = forced
    try:
        yield
    finally:
        qmm.KERNELS["int8_gemm"] = gemm


ART_IMAGE_SIZE = 224  # the runner's base bucket: a 448² image at full size
ART_SEED = 12  # the artifact's own draws (float head, ViT), beside --seed
ART_BATCH_TOKENS = 64
ARTIFACT_KERNELS = SLICE_KERNELS


def artifact_trees(m: dict, seed: int):
    """(params, state, specs, meta) of a Qwen2-VL-7B artifact as the JAX
    pipeline writes it for the default QuantizeConfig with ``realize_int``:
    path S's LLM (its W4 codes unpacked to one per int8 byte, the split
    ``down`` at 18943 rows with its f32 ``w_col0``, the embedding) with an
    fp bf16 lm_head; a float bf16 ViT and merger with the fused norms (no
    bias: RMSNorm); static activation scales of 0.05 on every vision site
    and path S's on the LLM; ``default_w4a8_specs`` (``build_specs`` of
    that config) and the config dict."""
    import torch

    from mquant_tpu_torch import random_init as R
    from mquant_tpu_torch.core.quant import QuantParams
    from mquant_tpu_torch.kernels.qmm import unpack_int4_weights
    from mquant_tpu_torch.models import layers as L
    from mquant_tpu_torch.models.qwen2vl import default_w4a8_specs
    from mquant_tpu_torch.models.vision import (init_merger_params,
                                                init_vit_params)
    from mquant_tpu_torch.utils.checkpoint import config_to_dict

    base, vcfg, dev = m["gen"], m["vcfg"], m["dev"]
    cfg, lay = base.cfg, base.params["layers"]
    g = torch.Generator(device=dev).manual_seed(seed + ART_SEED)
    layers = {"ln1": lay["ln1"], "ln2": lay["ln2"], "down": m["split_down"]}
    for group in (("q", "k", "v"), ("gate", "up")):
        codes = unpack_int4_weights({"w_q": lay[group[0]]["w_q_fused"]})
        lo = 0
        for n in group:
            hi = lo + lay[n]["w_scale"].shape[-1]
            layers[n] = {"w_q": codes[..., lo:hi].contiguous(),
                         "w_scale": lay[n]["w_scale"], "b": lay[n]["b"]}
            lo = hi
        del codes
    layers["o"] = {"w_q": unpack_int4_weights(lay["o"]),
                   "w_scale": lay["o"]["w_scale"], "b": None}
    llm = {"embed": base.params["embed"], "layers": layers,
           "ln_f": base.params["ln_f"],
           "lm_head": {"w": L.normal_init(g, (cfg.hidden, cfg.vocab), 0.02,
                                          device=dev)}}
    vit = init_vit_params(vcfg.vit, g, device=dev)
    merger = init_merger_params(vcfg.merger, g, device=dev)
    for nrm in (vit["blocks"]["ln1"], vit["blocks"]["ln2"], merger["ln_q"]):
        del nrm["b"]
    state = {k: v for k, v in base.state.items() if k != "llm.lm_head"}
    state.update(R.vision_state(vcfg.vit.n_layers, dev))
    state["vis.patch_embed"] = {"act": QuantParams(
        torch.full((), 0.05, device=dev))}
    meta = {"model": "qwen2vl", "config": str(vcfg),
            "config_dict": config_to_dict(vcfg),
            "quantize_config": {"realize_int": True}}
    return ({"llm": llm, "vit": vit, "merger": merger}, state,
            default_w4a8_specs(), meta)


def artifact_prompts(runner, seed: int):
    """The single request (a 448² image and text to PREFILL tokens in all,
    path S's prompt bucket) and the batch's three prompts (a 448² and a
    224×448 image, one text only), seeded."""
    import numpy as np

    rng = np.random.default_rng(seed + ART_SEED)

    def image(h, w):
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)

    def text(n):
        return "".join(rng.choice(list("abcdefghij klmnop"), n))

    img = image(448, 448)
    head = runner.build_inputs({"text": "", "image": img})[0].shape[1]
    single = {"text": text(PREFILL - head), "image": img}
    batch = [{"text": text(40), "image": image(448, 448)},
             {"text": text(120), "image": image(224, 448)},
             {"text": text(300)}]
    return single, batch


def runner_inputs(runner, prompts):
    """Each prompt's spliced embeddings (T_i, hidden) and M-RoPE positions
    as the runner's ``generate_batch`` builds them."""
    seqs, poss = [], []
    for p in prompts:
        emb, pos = runner._embeds(*runner.build_inputs(p))
        seqs.append(emb[0])
        poss.append(pos)
    return seqs, poss


def batch_rows_alone(path: str, gen, seqs, poss, dev):
    """Each row of ``gen``'s batch of ``seqs`` against the row served
    alone, by :func:`run_batch`'s rule: through the first CMP_LAYERS
    layers, the row's prefill logits within the bound and its first N_CMP
    greedy tokens equal, the row alone at the batch row's positions.
    Returns the rows' starts in the left-padded batch."""
    import torch

    cut = depth_cut(gen, CMP_LAYERS)
    outs_c = cut.generate_batch(seqs, max_new_tokens=N_CMP, positions=poss)
    logits_c, _, starts = cut.prefill_batch(seqs, positions=poss)
    for i, x in enumerate(seqs):
        n, st = x.shape[0], int(starts[i])
        at_pos = torch.from_numpy(poss[i] + st).to(dev)
        what = f"{path}, depth {CMP_LAYERS}: row {i} ({n} tokens)"
        check_close(f"{what} prefill logits vs alone", logits_c[i],
                    cut.prefill(x[None], positions=at_pos)[0][0])
        alone = cut.generate_on_device(x[None], max_new_tokens=N_CMP,
                                       positions=at_pos)[0].tolist()
        if outs_c[i] != alone:
            raise AssertionError(f"{what}: tokens {outs_c[i]} vs alone "
                                 f"{alone}")
    log(f"{path}, depth {CMP_LAYERS}: every row's first {N_CMP} tokens "
        f"equal to the row served alone (rows of {[x.shape[0] for x in seqs]}"
        f" tokens, starts {starts.tolist()})")
    return starts


def id_tokenizer():
    """A ByteTokenizer without eos whose ``decode`` gives the token ids:
    runners' outputs compare token for token and run their full length."""
    from mquant_tpu_torch.evaluation.adapter import ByteTokenizer

    class IdTokenizer(ByteTokenizer):
        eos_id = -1

        def decode(self, ids):
            return [int(i) for i in ids]

    return IdTokenizer()


def run_artifact(m: dict, card: str, seed: int) -> tuple:
    """Phase 4, the artifact: path S's weights written as the pipeline's
    artifact (:func:`artifact_trees`) with ``save_artifact`` to a temporary
    directory, loaded by ``build_runner_from_artifact(dir, "cuda")`` (the
    runner's base bucket ART_IMAGE_SIZE) and served: one request through
    ``generate`` (a 448² image in a PREFILL-token prompt, GEN_TOKENS
    tokens) and a ``generate_batch`` of three prompts, counted. The
    request's tokens and last-step logits equal (max |d| 0) those of the
    same runner built on the in-memory trees; the packed W4 bytes equal
    path S's; each batch row holds against itself alone
    (:func:`batch_rows_alone`); the request's and the batch's prefill and
    first decode steps hold against the integer products' plain versions
    (:func:`against_plain`, every attention call against its own). Then,
    before the directory goes, the engine phase (:func:`run_engine_phase`)
    on the same artifact. Returns the launch counts of the two; profiles
    the request's inputs and its vision pass."""
    import tempfile

    art = tempfile.mkdtemp(prefix="mquant_artifact_")
    try:
        launches = serve_artifact(m, card, seed, art)
        return launches, run_engine_phase(art, card, seed)
    finally:
        shutil.rmtree(art)


def serve_artifact(m: dict, card: str, seed: int, art: str) -> dict:
    """:func:`run_artifact`'s artifact phase in the directory ``art``."""
    import torch

    from mquant_tpu_torch.evaluation.adapter import VLMRunner
    from mquant_tpu_torch.serve.server import build_runner_from_artifact
    from mquant_tpu_torch.utils.checkpoint import save_artifact

    dev, vcfg = m["dev"], m["vcfg"]
    params, state, specs, meta = artifact_trees(m, seed)
    kw = dict(tokenizer=id_tokenizer(), max_len=PREFILL + GEN_TOKENS)
    t0 = time.perf_counter()
    nbytes = save_artifact(art, params, state, specs, meta)
    t_write = time.perf_counter() - t0
    free = shutil.disk_usage(art).free
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner = build_runner_from_artifact(art, device=dev,
                                        image_size=ART_IMAGE_SIZE, **kw)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    log(f"artifact: wrote {nbytes} bytes ({nbytes / 2**30:.2f} GiB) in "
        f"{t_write:.1f} s ({nbytes / t_write / 2**30:.2f} GiB/s), "
        f"{free / 2**30:.1f} GiB free beside it; build_runner_from_artifact "
        f"(load, to the card, W4 packing) {t_load:.1f} s; mode "
        f"{runner.mode}; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated; card {card}")
    ref = VLMRunner("qwen2vl", vcfg, params, specs=specs, state=state,
                    mode="real", image_size=ART_IMAGE_SIZE, **kw)
    del params, state
    lt, lb, lr = (runner.gen.params["layers"], m["gen"].params["layers"],
                  ref.gen.params["layers"])
    for n, key in (("q", "w_q_fused"), ("gate", "w_q_fused"), ("o", "w_q")):
        if not (torch.equal(lt[n][key], lb[n][key])
                and torch.equal(lr[n][key], lb[n][key])):
            raise AssertionError(f"artifact: packed {n} bytes differ from "
                                 "path S's")
    if not torch.equal(lt["down"]["w_q"], m["split_down"]["w_q"]):
        raise AssertionError("artifact: down codes differ from path S's")
    single, batch = artifact_prompts(runner, seed)
    with torch.no_grad():
        runner.generate(single, max_new_tokens=4)  # warm-up; not counted
        runner.generate_batch(batch, max_new_tokens=2)
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        out, t_req, ttft = timed(lambda mark: runner.generate(
            single, max_new_tokens=GEN_TOKENS, on_first_token=mark))
        logits = runner.gen._loop(1, None, False).logits.clone()
        t0 = time.perf_counter()
        outs_b = runner.generate_batch(batch, max_new_tokens=ART_BATCH_TOKENS)
        torch.cuda.synchronize()
        t_b = time.perf_counter() - t0
        launches = read_launches("artifact", ARTIFACT_KERNELS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        check_tokens("artifact", [out], GEN_TOKENS, vcfg.llm.vocab)
        check_tokens("artifact batch", outs_b, ART_BATCH_TOKENS,
                     vcfg.llm.vocab)
        out_r = ref.generate(single, max_new_tokens=GEN_TOKENS)
        err = float((logits.float() - ref.gen._loop(1, None, False).logits
                     .float()).abs().max())
        if out != out_r or err != 0:
            raise AssertionError(f"artifact: tokens equal to the in-memory "
                                 f"runner's: {out == out_r}; last-step "
                                 f"logits max |d| {err}")
        n_prompt = runner.build_inputs(single)[0].shape[1]
        log(f"artifact: {GEN_TOKENS} tokens and last-step logits (max |d| "
            f"{err}) equal to the runner on the in-memory trees; packed W4 "
            f"bytes equal to path S's")
        gen = runner.gen
        (emb,), (pos,) = runner_inputs(runner, [single])
        pos = torch.from_numpy(pos).to(dev)
        against_plain("artifact", gen,
                      lambda: gen.prefill(emb[None], positions=pos))
        seqs, poss = runner_inputs(runner, batch)
        starts = batch_rows_alone("artifact batch", gen, seqs, poss, dev)
        against_plain("artifact batch", gen,
                      lambda: gen.prefill_batch(seqs, positions=poss)[:2],
                      attn_start=starts)
        del gen
    s_req, s_ttft, s_tps = m["split_request"]
    log(f"artifact: request ({n_prompt}-token prompt with a 448² image, "
        f"{GEN_TOKENS} tokens) {t_req:.3f} s; TTFT {ttft * 1e3:.1f} ms; "
        f"decode {(GEN_TOKENS - 1) / (t_req - ttft):.1f} tok/s; beside path "
        f"S's request in this run (its decoder at {FS_DEPTH} layers, the "
        f"artifact's at 28): {s_req:.3f} s, TTFT {s_ttft * 1e3:.1f} "
        f"ms, {s_tps:.1f} tok/s; generate_batch {len(batch)} prompts, "
        f"{ART_BATCH_TOKENS} tokens each: {t_b:.3f} s, "
        f"{len(batch) * ART_BATCH_TOKENS / t_b:.1f} tok/s; peak "
        f"{peak:.2f} GiB; card {card}")
    with torch.no_grad():
        profile_phases([
            ("artifact: build_inputs (chat template, image resize, "
             "patchify)", lambda: runner.build_inputs(single), 1),
            ("artifact: build_inputs + float ViT (fake path) + merger + "
             "splice", lambda: runner._embeds(*runner.build_inputs(single)),
             1)], card)
    del runner, ref, m["split_down"]
    gc.collect()
    torch.cuda.empty_cache()
    return launches


ENGINE_SLOTS, ENGINE_MAX_LEN, ENGINE_STEPS = 8, 2048, 8  # the CLI's
ENGINE_TOP_K = 64
ENGINE_PREFIX = 256  # the registered system prefix, in ids
ENGINE_TEXT = (77, 300, 513, 1000)  # id prompts, three of each
ENGINE_IMAGE = 448  # the chat requests' image side
ENGINE_KERNELS = SLICE_KERNELS


def engine_bodies(vocab: int, seed: int):
    """The burst: 4 image chats (a 448² PNG, built without PIL; one
    Paeth-filtered, the others unfiltered) and 12 id
    completions (77, 300, 513 and 1000 tokens, three each; two 300-token
    prompts start with the registered prefix), max_tokens 64 for 8 and 128
    for 8, 4 sampled (temperature 0.8, top_p 0.9, a seed; one with
    frequency_penalty 0.5), one streamed and one streamed whose client
    hangs up after its first chunk. Returns (prefix, [(kind, body)])."""
    import base64

    import numpy as np

    from mquant_tpu_torch.utils.png import encode_png

    rng = np.random.default_rng(seed + 14)
    prefix = rng.integers(1, vocab, ENGINE_PREFIX).tolist()
    out = []
    for i in range(4):
        img = rng.integers(0, 256, (ENGINE_IMAGE, ENGINE_IMAGE, 3),
                           dtype=np.uint8)
        # one image Paeth-filtered, as an adaptive encoder writes photos
        url = ("data:image/png;base64," + base64.b64encode(
            encode_png(img, 4 if i == 0 else 0)).decode())
        out.append(("chat", {"messages": [{"role": "user", "content": [
            {"type": "image_url", "image_url": {"url": url}},
            {"type": "text", "text": f"describe picture {i} in detail"}]}]}))
    for n in ENGINE_TEXT:
        for j in range(3):
            ids = rng.integers(1, vocab, n).tolist()
            if n == 300 and j < 2:
                ids[:ENGINE_PREFIX] = prefix
            out.append(("text", {"prompt": ids}))
    for i, (_, b) in enumerate(out):
        b["max_tokens"] = 64 if i % 2 else 128
    for i in (1, 5, 9, 13):  # sampled: a chat and three completions
        out[i][1].update(temperature=0.8, top_p=0.9, seed=1000 + i)
    out[13][1]["frequency_penalty"] = 0.5
    out[6][1]["stream"] = True
    out[10][1]["stream"] = True
    out[10] = ("hangup", out[10][1])
    return prefix, out


def _http(port: int, kind: str, body: dict):
    """One request: (status, tokens, seconds); a stream's tokens are its
    deltas' concatenation; "hangup" closes after the first chunk."""
    import http.client
    import socket

    path = "/v1/chat/completions" if kind == "chat" else "/v1/completions"
    t0 = time.perf_counter()
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    c.request("POST", path, json.dumps(body),
              {"Content-Type": "application/json"})
    r = c.getresponse()
    if kind == "hangup":
        r.fp.readline()  # the first chunk's size line: decoding has begun
        c.sock.shutdown(socket.SHUT_RDWR)
        c.sock.close()
        return r.status, None, time.perf_counter() - t0
    data = r.read().decode()
    c.close()
    if body.get("stream"):
        evs = [ln[6:] for ln in data.split("\n") if ln.startswith("data: ")]
        if evs[-1] != "[DONE]":
            raise AssertionError(f"engine: stream ended with {evs[-1]!r}")
        toks = sum((json.loads(e)["choices"][0]["tokens"] for e in evs[:-1]),
                   [])
        return r.status, toks, time.perf_counter() - t0
    out = json.loads(data)
    if r.status != 200:
        raise AssertionError(f"engine: HTTP {r.status}: {out}")
    return r.status, out["choices"][0]["tokens"], time.perf_counter() - t0


def _metrics(port: int) -> dict:
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    c.request("GET", "/metrics")
    text = c.getresponse().read().decode()
    c.close()
    return {k: float(v) for k, v in (ln.split() for ln in text.splitlines())}


def _pct(xs, q):
    import numpy as np

    return float(np.percentile(np.asarray(xs), q))


def admissions_against_plain(eng) -> list:
    """On the worker thread: admit the engine's queue with every attention
    kernel call held against its plain version (:func:`shadow_attention`)
    and every batched (k ≥ 2 rows) admission prefill held against the same
    prefill with the integer products through their plain versions
    (``against_plain``'s rule: logits within the bound, the same first
    tokens). Returns [((k, Tb), max |d|)] of the batched prefills."""
    import torch

    held, fwd = [], eng._forward

    def admission(x, cache, **kw):
        if not (kw.get("prefill_fresh") and x.shape[0] > 1):
            return fwd(x, cache, **kw)
        rows_p = {**cache, "k": cache["k"].clone(), "v": cache["v"].clone()}
        logits, rows = fwd(x, cache, **kw)
        with plain_kernels(("qmm",)):
            logits_p = fwd(x, rows_p, **kw)[0]
        what = (f"engine: batched admission ({x.shape[0]} x {x.shape[1]}) "
                "logits vs plain qmm")
        err = check_close(what, logits, logits_p)
        if not torch.equal(logits.argmax(-1), logits_p.argmax(-1)):
            raise AssertionError(f"{what}: first tokens differ")
        held.append((tuple(x.shape[:2]), err))
        return logits, rows

    eng._forward = admission
    try:
        with torch.no_grad(), shadow_attention("engine admissions"):
            eng._admit()
    finally:
        del eng._forward  # the class's method again
    if not held:
        raise AssertionError("engine: no batched admission was held")
    return held


def block_against_plain(eng, prompts) -> dict:
    """On the worker thread: the prompts admitted as
    :func:`admissions_against_plain` holds them, then one decode block of
    the pool (the captured graph, ENGINE_STEPS replays) held against the
    same block run eagerly from the same state with the integer products
    through their plain versions (``against_plain``'s rule): last-step
    logits max |d| 0, tokens equal; every attention kernel call of the
    eager block (``attn_decode`` at the pool's shape: per-row positions,
    the buffer's NaN tail) held against its plain version. Then the
    block's wall (CUDA-synchronized, best of 3) and device busy time under
    torch.profiler. The requests are cancelled after."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mquant_tpu_torch.serve.engine import _Block

    rids = [eng.submit(p, max_new_tokens=128) for p in prompts]
    admitted = admissions_against_plain(eng)
    eng.step_block()  # a first block
    live, ints, floats = eng._block_inputs()
    if len(live) != len(prompts):
        raise AssertionError("engine: block check rows not live")
    snap = {k: eng.cache[k].clone() for k in ("k", "v", "pos")}
    counts = eng.tok_counts.clone()
    blk = eng._block(False)
    blk.load(ints, floats)
    blk.graph(eng.steps_per_block)
    out_g, _, _ = blk.read()
    logits_g = blk.logits.clone()
    ref = _Block(eng, eng.steps_per_block, False)
    ref.graph.graph = None  # the step runs eagerly
    for k, v in snap.items():
        eng.cache[k].copy_(v)
    eng.tok_counts.copy_(counts)
    with plain_kernels(("qmm",)), shadow_attention("engine block"):
        ref.load(ints, floats)
        ref.graph(eng.steps_per_block)
        out_p, _, _ = ref.read()
    err = float((logits_g.float() - ref.logits.float()).abs().max())
    if err != 0 or not (out_g == out_p).all():
        raise AssertionError(f"engine: decode block vs plain qmm: logits "
                             f"max |d| {err}, tokens equal "
                             f"{bool((out_g == out_p).all())}")
    del ref, snap

    events = []

    def one_block():  # as the engine's: inputs in, replays, outputs read
        blk.load(ints, floats)
        if events is not None and torch.cuda.is_available():
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            blk.graph(eng.steps_per_block)
            ev[1].record()
            events.append(ev)
        else:
            blk.graph(eng.steps_per_block)
        blk.read()

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_block()
        walls.append((time.perf_counter() - t0) * 1e3)
    stream = min((a.elapsed_time(b) for a, b in events), default=None)
    events = None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        one_block()
    items = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and e.self_device_time_total > 0), reverse=True)
    busy = sum(ms for ms, _, _ in items)
    for ms, n, key in items[:TOP_ITEMS]:
        log(f"engine: block device item {ms:8.3f} ms {n:6d}x  {key[:90]}")
    # int8_gemv: the tensor-core GEMV's int8 instantiations (GemvUnpack kI8
    # = 5, its third template argument)
    i8 = [(ms, n) for ms, n, key in items
          if re.search(r"gemv_tc_kernel<\d+, (true|false), 5, \d+>", key)]
    i8_ms, i8_n = sum(ms for ms, _ in i8), sum(n for _, n in i8)
    if i8_n:
        log(f"engine: block int8_gemv {i8_ms:.3f} ms over {i8_n} calls, "
            f"{1e3 * i8_ms / i8_n:.1f} us a call (M = {ENGINE_SLOTS})")
    for r in rids:
        eng.cancel(r)
    eng.step_block()
    for r in rids:
        eng.release(r)
    wall = min(walls)
    return {"rows": len(prompts), "logits_max_abs_d": err,
            "admissions": admitted, "wall_ms": wall,
            "int8_gemv_ms": i8_ms, "int8_gemv_calls": i8_n,
            "stream_ms": stream, "busy_ms": busy if busy > 0 else None,
            "idle_share": 1 - busy / wall if busy > 0 else None}


ENGINE_SPEC_K = 3  # the speculative pass's draft length


def verify_sites(eng) -> list:
    """On the worker thread, ROADMAP C-w18: each product or reduction of a
    decoder layer (layer 0 of the served weights), of the head and of the
    logprob at a speculative verify window of ENGINE_SPEC_K + 1 rows per
    slot ((k + 1) · B rows, random bf16 inputs at the site's width) against
    the same call on each window row's B rows apart, concatenated: whether
    the bits agree. The integer products alone (``quantized_matmul_pre`` on
    the site's int8 codes: exact in int32, per-element epilogue) must agree;
    the others are what ``layers.per_step`` runs on each step's rows.
    Returns [(site, rows, equal)]."""
    import torch

    from mquant_tpu_torch.kernels import qmm
    from mquant_tpu_torch.models import layers as L
    from mquant_tpu_torch.models.llm import layer_views

    B, T = eng.slots, ENGINE_SPEC_K + 1
    g = torch.Generator(device=eng.device).manual_seed(15)
    lp = layer_views(eng.params["layers"], 0)
    lst = layer_views({k: v for k, v in eng.state.items()
                       if k.startswith("llm.") and k != "llm.lm_head"}, 0)
    specs = eng.specs

    def xin(C):
        return torch.randn((B, T, C), generator=g, device=eng.device
                           ).to(torch.bfloat16)

    def codes(C):
        return torch.randint(-127, 128, (B, T, C), generator=g,
                             device=eng.device, dtype=torch.int8)

    H, I = eng.cfg.hidden, lp["down"]["w_q"].shape[0]
    dspec = specs["llm.down"]
    sites = [
        ("rms_norm (ln1)", xin(H),
         lambda x: L.rms_norm(x, lp["ln1"]["w"], eng.cfg.norm_eps)),
        ("q|k|v site (W4, one product)", xin(H),
         lambda x: torch.cat(L.qlinear_group(
             x, [lp["q"], lp["k"], lp["v"]], ["llm.q", "llm.k", "llm.v"],
             specs, lst, "real"), dim=-1)),
        ("o site", xin(eng.cfg.n_heads * eng.cfg.head_dim),
         lambda x: L.qlinear(x, lp["o"], "llm.o", specs.get("llm.o"), lst,
                             "real")),
        ("gate|up site", xin(H),
         lambda x: torch.cat(L.qlinear_group(
             x, [lp["gate"], lp["up"]], ["llm.gate", "llm.up"], specs, lst,
             "real"), dim=-1)),
        ("down site (Hadamard, split, int8)", xin(eng.cfg.inter_eff),
         lambda x: L.qlinear(x, lp["down"], "llm.down", dspec, lst, "real")),
        ("head", xin(H),
         lambda x: L.qlinear(x, eng.params["lm_head"], "llm.lm_head",
                             specs.get("llm.lm_head"), eng.state, "real")),
        ("logsumexp (f32, vocabulary)",
         torch.randn((B, T, eng.cfg.vocab), generator=g, device=eng.device),
         lambda x: torch.logsumexp(x.float(), dim=-1)),
    ]
    if dspec.online_had is not None:
        sites.append(("down: online Hadamard", xin(eng.cfg.inter_eff),
                      lambda x: L._online_hadamard(x, dspec)))
    if "w_col0" in lp["down"]:
        sites.append(("down: split column (f32)", xin(1),
                      lambda x: x.float() @ lp["down"]["w_col0"].float()))
    pw = lambda n: lp[n].get("w_q_fused", lp[n].get("w_q"))  # noqa: E731
    ints = [(f"int product q|k|v (K {H})", codes(H),
             {"w_q": pw("q"), "w_scale": lp["q"].get("w_scale_fused",
                                                     lp["q"]["w_scale"])}),
            (f"int product gate|up (K {H})", codes(H),
             {"w_q": pw("gate"), "w_scale": lp["gate"].get(
                 "w_scale_fused", lp["gate"]["w_scale"])}),
            (f"int product down (K {I})", codes(I), lp["down"])]
    for name, x, p in ints:
        ws = torch.full((B * T,), 0.01, device=eng.device)
        sites.append((name, x, lambda c, p=p, ws=ws: qmm.quantized_matmul_pre(
            c, ws[:c.shape[0] * c.shape[1]], p, torch.bfloat16)))
    out = []
    for name, x, fn in sites:
        full = fn(x)
        steps = torch.cat([fn(x[:, j:j + 1].contiguous()) for j in range(T)],
                          dim=1)
        eq = torch.equal(full, steps)
        out.append((name, B * T, eq))
        log(f"engine: verify site {name:36s} {B * T} rows vs {T} x {B}: "
            + ("bit-equal" if eq else "differs"))
        if name.startswith("int product") and not eq:
            raise AssertionError(f"engine: {name} at {B * T} rows differs "
                                 f"from {T} calls at {B} rows")
    return out


def spec_pass(srv, bodies, results, prefix, need) -> dict:
    """After the burst: its greedy id completions again, sent at once over
    HTTP to a server of the CLI's ``--spec_k`` configuration on the same
    runner (``spec_k=ENGINE_SPEC_K``, ``sample_top_k=0``: sampling and
    speculation are exclusive), its pool of the burst's shape with the same
    prefix registered: every token equal to the burst's (ROADMAP C-w18).
    Returns the pass's seconds, tokens per second and acceptance (tokens
    emitted per live row and round)."""
    import threading

    import torch

    from mquant_tpu_torch.serve.server import InferenceServer

    picks = [i for i, (kind, b) in enumerate(bodies)
             if kind == "text" and not b.get("temperature")]
    spec = InferenceServer.for_vlm(
        srv.vlm_runner, slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN,
        steps_per_block=ENGINE_STEPS, spec_k=ENGINE_SPEC_K, sample_top_k=0,
        seed=0)
    try:
        def setup(e):
            e._grow(need)
            for nm in ("k", "v"):
                e.cache[nm].fill_(float("nan"))
            e.register_prefix(prefix)
            e.warmup(prompt_lens=ENGINE_TEXT)
            torch.cuda.synchronize()
            return e._cache_S()

        S = spec.worker.call(setup)
        if S != srv.worker.call(lambda e: e._cache_S()):
            raise AssertionError(f"engine spec_k: pool of {S} rows")
        got = [None] * len(picks)

        def client(j):
            body = {k: v for k, v in bodies[picks[j]][1].items()
                    if k != "stream"}
            got[j] = _http(spec.port, "text", body)

        threads = [threading.Thread(target=client, args=(j,))
                   for j in range(len(picks))]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
            if t.is_alive():
                raise AssertionError("engine spec_k: a client did not finish")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_tok = 0
        for j, i in enumerate(picks):
            toks, want = got[j][1], results[i][1]
            if toks != want:
                d = next((k for k, (a, b) in enumerate(zip(toks, want))
                          if a != b), min(len(toks), len(want)))
                raise AssertionError(f"engine spec_k={ENGINE_SPEC_K}: request "
                                     f"{i} differs from the burst at token "
                                     f"{d}")
            n_tok += len(toks)
        acc = spec.worker.stats()["spec_accept_per_round"]
        log(f"engine: spec_k={ENGINE_SPEC_K} pass: {len(picks)} greedy id "
            f"requests, every token equal to the burst's; {n_tok} tokens in "
            f"{wall:.3f} s ({n_tok / wall:.2f} tok/s), {acc:.3f} tokens a "
            "live row and round")
        return {"spec_requests": len(picks), "spec_s": wall,
                "spec_tok_per_s": n_tok / wall, "spec_accept_per_round": acc}
    finally:
        spec.shutdown()


def run_engine_phase(art: str, card: str, seed: int, dev: str = "cuda"
                     ) -> dict:
    """Phase 4, the engine: the artifact served over HTTP on localhost by
    ``build_server_from_artifact(art, device="cuda", slots=8,
    max_len=2048, steps_per_block=8, sample_top_k=64, seed=0)`` (the CLI's
    values), the pool grown to the burst's bucket, every KV row poisoned
    with NaN, one 256-id prefix registered and the admissions and block
    warmed; then the 16-request burst of :func:`engine_bodies` from 16
    client threads, counted. Checks: every greedy request equal to itself
    sent alone, every sampled one replayed alone by its seed, the stream's
    deltas equal to the request's response, no active slot and one
    cancellation after the hang-up, two prefix hits; one decode block
    against plain qmm (:func:`block_against_plain`). Prints one JSON line
    of the phase's numbers. Returns the launch counts. Rehearse on the CPU
    with ``dev="cpu"`` on a tiny artifact (the cuda calls stubbed)."""
    import threading

    import numpy as np
    import torch

    from mquant_tpu_torch.kernels import attn_decode
    from mquant_tpu_torch.serve.generate import bucket_len
    from mquant_tpu_torch.serve.server import build_server_from_artifact

    t0 = time.perf_counter()
    srv = build_server_from_artifact(
        art, device=dev, slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN,
        steps_per_block=ENGINE_STEPS, sample_top_k=ENGINE_TOP_K, seed=0,
        tokenizer=id_tokenizer(), image_size=ART_IMAGE_SIZE)
    try:
        worker, eng = srv.worker, srv.worker.engine
        vocab = eng.cfg.vocab
        prefix, bodies = engine_bodies(vocab, seed)
        if eng.device.type != dev or eng.mode != "real":
            raise AssertionError(f"engine: on {eng.device}, {eng.mode}")
        # the burst's KV rows (the engine's own rule), so no growth and no
        # new capture happens inside it
        need = max(max(n + 128, bucket_len(n, 16)) for n in ENGINE_TEXT)
        seen = []  # attn_decode calls at capture: their pos's shape
        kern = attn_decode.KERNELS["attn_decode"]

        def spy(q, k_new, v_new, kc, vc, pos, *a, **kw):
            seen.append(tuple(pos.shape) if torch.is_tensor(pos) else ())
            return kern(q, k_new, v_new, kc, vc, pos, *a, **kw)

        def setup(e):
            e._grow(need)
            for nm in ("k", "v"):
                e.cache[nm].fill_(float("nan"))
            e.register_prefix(prefix)
            attn_decode.KERNELS["attn_decode"] = spy
            try:
                e.warmup(prompt_lens=ENGINE_TEXT)
                e.warmup(prompt_lens=(300,), embeds=True,
                         with_positions=True)
            finally:
                attn_decode.KERNELS["attn_decode"] = kern
            torch.cuda.synchronize()
            return e._cache_S()

        S = worker.call(setup)
        if dev == "cuda" and (not seen or any(sh != (ENGINE_SLOTS,)
                                              for sh in seen)):
            raise AssertionError(f"engine: attn_decode positions {seen}")
        t_setup = time.perf_counter() - t0
        log(f"engine: server up, pool of {ENGINE_SLOTS} slots x {S} rows "
            f"(NaN-poisoned), prefix of {ENGINE_PREFIX} ids registered, "
            f"admissions and the block warmed in {t_setup:.1f} s "
            f"(attn_decode captured with pos of shape {seen[:1]})")
        pendings = []  # every request's _Pending, for its timestamps
        submit, vlm = worker.submit, worker.submit_vlm

        def recorded(fn):
            def wrap(*a, **k):
                p = fn(*a, **k)
                pendings.append(p)
                return p
            return wrap

        worker.submit, worker.submit_vlm = recorded(submit), recorded(vlm)
        occ, stop = [], threading.Event()

        def watch():
            while not stop.wait(0.02):
                occ.append(worker.stats()["active"])

        results = [None] * len(bodies)

        def client(i):
            results[i] = _http(srv.port, *bodies[i])

        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(bodies))]
        mon = threading.Thread(target=watch)
        mon.start()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
            if t.is_alive():
                raise AssertionError("engine: a client did not finish")
        for _ in range(500):  # the hung-up stream's cancellation
            if worker.stats()["inflight"] == 0:
                break
            time.sleep(0.01)
        torch.cuda.synchronize()
        t_burst = time.perf_counter() - t0
        stop.set()
        mon.join(10)
        worker.submit, worker.submit_vlm = submit, vlm
        launches = read_launches("engine", ENGINE_KERNELS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        met = _metrics(srv.port)
        if met["mquant_active"] != 0 or met["mquant_cancelled_total"] != 1:
            raise AssertionError(f"engine: after the burst active "
                                 f"{met['mquant_active']}, cancelled "
                                 f"{met['mquant_cancelled_total']}")
        if met["mquant_prefix_hits"] != 2:
            raise AssertionError(f"engine: prefix hits "
                                 f"{met['mquant_prefix_hits']}")
        done = [p for p in pendings if p.t_done is not None
                and p.error is None and not p.cancelled]
        n_tok = sum(len(p.tokens) for p in done)
        ttft = [p.t_first - p.t_submit for p in done if p.t_first]
        lat = [p.t_done - p.t_submit for p in done]
        # each request again, alone: greedy ones equal, sampled ones replay
        same = 0
        for i, (kind, body) in enumerate(bodies):
            st, toks, _ = results[i]
            if st != 200:
                raise AssertionError(f"engine: request {i}: HTTP {st}")
            if kind == "hangup":
                continue
            check_tokens(f"engine request {i}", [toks], body["max_tokens"],
                         vocab)
            alone = _http(srv.port, kind, {k: v for k, v in body.items()
                                           if k != "stream"})[1]
            if alone != toks:
                d = next(j for j, (a, b) in enumerate(zip(alone, toks))
                         if a != b)
                t = body.get("temperature", 0)
                raise AssertionError(f"engine: request {i} ({kind}, "
                                     f"temperature {t}) differs from itself "
                                     f"alone at token {d}")
            same += 1
        log(f"engine: {same} requests equal to themselves sent alone "
            f"(greedy tokens; sampled ones replayed by seed; the stream's "
            f"deltas equal to its response); 1 hung-up stream cancelled, "
            f"slots freed; prefix hits 2")
        rng = np.random.default_rng(seed + 15)
        blk = worker.call(lambda e: block_against_plain(
            e, [rng.integers(1, vocab, n) for n in (77, 300, 513, 1000, 40,
                                                    200, 600, 120)]))
        log(f"engine: batched admissions (k, Tb) vs plain qmm: "
            + ", ".join(f"{kt} max |d| {e:.3g}" for kt, e in
                        blk["admissions"]) + "; first tokens equal")
        log(f"engine: one decode block ({ENGINE_STEPS} steps, "
            f"{blk['rows']} live rows) vs plain qmm: last-step logits max "
            f"|d| {blk['logits_max_abs_d']}, tokens equal")
        worker.call(verify_sites)
        sp = spec_pass(srv, bodies, results, prefix, need)
        stats = worker.stats()
        line = {"engine_phase": {
            "requests": len(bodies), "burst_s": t_burst,
            "generated_tokens": n_tok, "tok_per_s": n_tok / t_burst,
            "ttft_p50_s": _pct(ttft, 50), "ttft_p90_s": _pct(ttft, 90),
            "latency_p50_s": _pct(lat, 50), "latency_p90_s": _pct(lat, 90),
            "block_steps": ENGINE_STEPS, "block_wall_ms": blk["wall_ms"],
            "block_stream_ms": blk["stream_ms"],
            "block_busy_ms": blk["busy_ms"],
            "block_idle_share": blk["idle_share"],
            "occupancy_mean": float(np.mean(occ)) / ENGINE_SLOTS,
            "occupancy_max": max(occ) / ENGINE_SLOTS,
            "graphs": stats["graphs"], "peak_gib": peak,
            "setup_s": t_setup, "int8_gemv_block_ms": blk["int8_gemv_ms"],
            "int8_gemv_block_calls": blk["int8_gemv_calls"], **sp,
            "card": card}}
        log(json.dumps(line))
        return launches
    finally:
        srv.shutdown()
        del srv
        gc.collect()
        torch.cuda.empty_cache()


def run_document(m: dict, card: str) -> dict:
    """Phase 4 (a). The document request: an 896² page (64×64 patches, 4096
    ViT rows, 1024 image tokens at positions 2..1025) in a 4096-token prompt
    with M-RoPE positions, then 128 greedy tokens. Returns its launch
    counts; profiles its prefill and a decode step at position ~4100."""
    import torch

    from mquant_tpu_torch.models.qwen2vl import mrope_positions

    gen = m["gen"]
    embeds, toks = image_request(m, DOC_SIDE, DOC_PROMPT)
    g = DOC_SIDE // 14
    pos = torch.from_numpy(mrope_positions(
        toks.cpu().numpy(), m["vcfg"].image_token_id,
        grid_thw=(1, g, g))).to(m["dev"])
    with torch.no_grad():
        gen.generate_on_device(embeds()[0], max_new_tokens=2, positions=pos)
        torch.cuda.synchronize()  # warm-up at the new shapes; not counted
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        held = {}

        def doc():
            held["emb"], held["merged"] = embeds()
            return held["emb"]

        out, t_req, ttft = timed_request(gen, doc, DOC_TOKENS, positions=pos)
        launches = read_launches("document", DOC_KERNELS)
        if launches["flash_attn_causal"] != gen.cfg.n_layers:
            raise AssertionError(f"document: {launches['flash_attn_causal']} "
                                 f"flash launches, not one per layer "
                                 f"({gen.cfg.n_layers})")
        peak = torch.cuda.max_memory_allocated() / 2**30
        check_tokens("document", out, DOC_TOKENS, gen.cfg.vocab)
        emb = held["emb"]
        rows = gen.prefill(emb, positions=pos)[1]["k"].shape[2]
        if rows != 8192:
            raise AssertionError(f"document: cache of {rows} rows, not 8192")
        with plain_kernels():
            merged_p = embeds()[1]
        check_close("document: merger out vs plain kernels", held["merged"],
                    merged_p)
        against_plain("document", gen,
                      lambda: gen.prefill(emb, positions=pos))
        del merged_p
        torch.cuda.empty_cache()
    log(f"document: request (896² image, {DOC_PROMPT}-token prompt, "
        f"{DOC_TOKENS} tokens, M-RoPE) {t_req:.3f} s; TTFT "
        f"{ttft * 1e3:.1f} ms; decode {(DOC_TOKENS - 1) / (t_req - ttft):.1f}"
        f" tok/s; peak {peak:.2f} GiB; card {card}")
    with torch.no_grad():
        profile_phases(
            [("prefill 4096 (document)",
              lambda: gen.prefill(emb, positions=pos), 1),
             ("decode step at pos ~4100",
              decode_steps(gen, gen.prefill(emb, positions=pos)[1]),
              PROFILE_STEPS)], card)
    return launches


def run_batch(m: dict, card: str) -> dict:
    """Phase 4 (b). ``Generator.generate_batch`` on 4 ragged text prompts,
    each row held against itself served alone through
    ``generate_on_device``. Returns its launch counts."""
    import torch

    gen = m["gen"]
    V = gen.cfg.vocab
    texts = [torch.randint(0, V, (n,), generator=m["g"], device=m["dev"])
             for n in BATCH_PROMPTS]
    with torch.no_grad():
        gen.generate_batch(texts, max_new_tokens=2)  # warm-up; not counted
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        outs = gen.generate_batch(texts, max_new_tokens=BATCH_TOKENS)
        torch.cuda.synchronize()
        t_b = time.perf_counter() - t0
        launches = read_launches("batch", BATCH_KERNELS)
        check_tokens("batch", outs, BATCH_TOKENS, V)
        cut = depth_cut(gen, CMP_LAYERS)
        outs_c = cut.generate_batch(texts, max_new_tokens=N_CMP)
        hb = []  # the cut's layer outputs, to show why it goes no deeper
        with layer_outputs(hb):
            logits_c, _, starts = cut.prefill_batch(texts)
        for i, t in enumerate(texts):
            n, st = len(t), int(starts[i])
            # the row alone at the batch row's positions (start + arange):
            # the same RoPE angles, so only the masked pad columns and the
            # batch shape tell the two apart (at positions from 0 the bf16
            # RoPE products round otherwise)
            at_pos = (torch.arange(n, device=m["dev"]) + st)[None]
            ha = []
            with layer_outputs(ha):
                logits_1 = cut.prefill(t[None], positions=at_pos)[0]
            h_b, h_1 = hb[-1][i, st:].float(), ha[-1][0, :n].float()
            what = f"batch, depth {CMP_LAYERS}: row {i} ({n} tokens)"
            check_close(f"{what} prefill logits vs alone (layer "
                        f"{CMP_LAYERS} out, all {n} positions: max |d| "
                        f"{float((h_b - h_1).abs().max()):.3g} of max |h| "
                        f"{float(h_1.abs().max()):.3g})", logits_c[i],
                        logits_1[0])
            alone = cut.generate_on_device(t[None], max_new_tokens=N_CMP,
                                           positions=at_pos)[0].tolist()
            if outs_c[i] != alone:
                raise AssertionError(f"{what}: tokens {outs_c[i]} vs alone "
                                     f"{alone}")
        log(f"batch, depth {CMP_LAYERS}: every row's first {N_CMP} tokens "
            "equal to the row served alone")
        del hb, ha
        against_plain("batch", gen, lambda: gen.prefill_batch(texts)[:2],
                      attn_start=starts)
    log(f"batch: generate_batch {len(texts)} prompts {BATCH_PROMPTS} "
        f"(left-padded to 1024, starts {starts.tolist()}), {BATCH_TOKENS} "
        f"tokens each: {t_b:.3f} s, {len(texts) * BATCH_TOKENS / t_b:.1f} "
        f"tok/s; card {card}")
    return launches


# ---------------------------------------------------------------------------
# phase 4 (c): the storage configurations and quantized KV caches
# ---------------------------------------------------------------------------

# the long-context cell (scripts/longctx_bench.py's in the port): one text
# prompt of LONGCTX_T seeded ids in [1, 1000) prefilled in LONGCTX_CHUNK-row
# chunks (seven full chunks and a 1664-row tail), then LONGCTX_TOKENS greedy
# tokens through the graph loop
LONGCTX_T, LONGCTX_CHUNK, LONGCTX_TOKENS = 16000, 2048, 32
LONGCTX_CMP_DEPTH = 2  # chunked against one-piece, held by golden's rule
LONGCTX_EXACT_T = 4096  # the one-piece einsum (f32 T² scores) fits to here
LONGCTX_WIDE_CHUNK = 8192  # the whole prompt in two pieces, held against
# LONGCTX_CHUNK's pieces: every chunk offset on one attention route
LONGCTX_KERNELS = SLICE_KERNELS


@contextlib.contextmanager
def einsum_route():
    """The prefill attention on the einsum route at every length (no flash:
    ``layers.FLASH_MIN_T`` out of reach)."""
    from mquant_tpu_torch.models import layers

    saved = layers.FLASH_MIN_T
    layers.FLASH_MIN_T = 1 << 30
    try:
        yield
    finally:
        layers.FLASH_MIN_T = saved


@contextlib.contextmanager
def chunk_events(gen, store: list):
    """Appends a pair of CUDA events around every ``gen._forward`` call (a
    chunk of ``prefill_chunked``) to ``store``."""
    import torch

    fwd = gen._forward

    def timed_fwd(*a, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = fwd(*a, **kw)
        ev[1].record()
        store.append(ev)
        return out

    gen._forward = timed_fwd
    try:
        yield
    finally:
        del gen._forward


def top16_against(what: str, logits, ref, hold: bool) -> dict:
    """``logits`` (V,) against ``ref`` (V,) by ``golden.hold``'s rule (the
    top-16 ids of ``ref`` within 1e-2 of its largest, the argmax equal
    unless its margin is below that); raises only where ``hold``."""
    from mquant_tpu_torch import golden as G

    ref = ref.float().cpu().numpy()[None]
    got = logits.float().cpu().numpy()[None]
    e = {"path": "chunked", "depth": 0, "digest": "-",
         "tokens": [int(ref[0].argmax())], **G.summarize(ref)}
    try:
        rep = G.hold(e, "-", [int(got[0].argmax())], got)
        res = (f"held (top-16 max |d| {rep['max_d']:.4g} against "
               f"{rep['max_tol']:.4g}; argmax "
               + ("equal)" if rep["parted_at"] is None
                  else "parted at a near tie)"))
    except G.GoldenMismatch as err:
        if hold:
            raise
        rep, res = None, f"not held ({err})"
    log(f"{what}: {res}")
    return rep


def run_longctx(m: dict, card: str) -> dict:
    """Phase 4 (d), the long context (``Generator.prefill_chunked``, A7c)
    on the resident block-path model at depth 28: a LONGCTX_T-token prompt
    prefilled in LONGCTX_CHUNK-row chunks against the cache (the einsum
    route's causal-with-offset mask over the whole cache; the head at one
    row a chunk), written into the graph loop's NaN-poisoned
    buffers, then LONGCTX_TOKENS greedy tokens through the graph loop,
    counted: the prefill's wall (best of 2, synchronized at both ends),
    each chunk's device ms and the attention's share of it (CUDA events),
    its peak allocated memory beside the one-piece prefill's (flash,
    padded to the 16384 bucket, the kernel held against its plain version
    at that shape in phase 3), decode tok/s at position ~16000. Held: (a)
    the chunked prefill and its tokens against the same run with the
    integer products plain (last logits max |d| 0, tokens equal); (b)
    with the LLM cut to LONGCTX_CMP_DEPTH layers, by ``golden.hold``'s
    top-16 rule on the einsum route: the whole prompt in LONGCTX_CHUNK-row
    pieces against LONGCTX_WIDE_CHUNK-row pieces (every offset), and the
    prompt's first LONGCTX_EXACT_T ids in pieces against one piece; against
    the flash route, at depth 28 and at LONGCTX_CMP_DEPTH, compared and
    printed, with flash's one piece against the einsum's at
    LONGCTX_EXACT_T beside them (the random weights' coarse activation
    scales carry flash's other rounding past the rule from the first layer
    on, ROADMAP C-w6); (c) the graph loop against the eager loop from the
    chunked cache (tokens equal, last-step logits max |d| 0). Returns the
    launch counts."""
    import torch

    from mquant_tpu_torch.serve.generate import bucket_len

    gen = m["gen"]
    T, chunk, n = LONGCTX_T, LONGCTX_CHUNK, LONGCTX_TOKENS
    ids = torch.randint(1, 1000, (1, T), generator=m["g"], device=m["dev"])
    n_chunks = -(-T // chunk)
    # the loop's buffers at the final length: the cache grows first
    gen.ensure_capacity(T + n)
    loop = gen._loop(1, None, False)
    poison(gen)
    with torch.no_grad():
        reset_launches()
        base = torch.cuda.memory_allocated()
        walls, chunk_ms, attn_ms, peak_c = [], None, None, 0
        for _ in range(2):
            evs, aevs = [], []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with chunk_events(gen, evs), attention_events(aevs):
                last, cache = gen.prefill_chunked(ids, chunk, n, kv=loop.kv)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            peak_c = max(peak_c, torch.cuda.max_memory_allocated() - base)
            if walls[-1] == min(walls):
                chunk_ms = [a.elapsed_time(b) for a, b in evs]
                attn_ms = [a.elapsed_time(b) for a, b in aevs]
        L_ = gen.cfg.n_layers
        if len(chunk_ms) != n_chunks or len(attn_ms) != n_chunks * L_:
            raise AssertionError(f"longctx: {len(chunk_ms)} chunk forwards "
                                 f"and {len(attn_ms)} attention calls, not "
                                 f"{n_chunks} and {n_chunks * L_}")
        attn_chunk = [sum(attn_ms[i * L_:(i + 1) * L_])
                      for i in range(n_chunks)]
        tok = last.argmax(-1).to(torch.int32)[:, None]
        cache_e = {k: v.clone() if isinstance(v, torch.Tensor) else v
                   for k, v in cache.items()}
        out_g = loop.run(tok, cache, n, pos=T)  # the capture, then replays
        torch.cuda.synchronize()
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        ev[0].record()
        again = loop.run(tok, cache, n, pos=T)
        ev[1].record()
        torch.cuda.synchronize()
        dec_wall = time.perf_counter() - t0
        dec_ms = ev[0].elapsed_time(ev[1]) / (n - 1)
        logits_g = loop.logits.clone()
        launches = read_launches("longctx", LONGCTX_KERNELS)
        check_tokens("longctx", out_g, n, gen.cfg.vocab)
        if not torch.equal(again, out_g):
            raise AssertionError("longctx: the timed graph run's tokens "
                                 "differ from the first's")
        log(f"longctx: {T}-token prompt in {n_chunks} chunks of {chunk} "
            f"(tail {T - (n_chunks - 1) * chunk}): wall "
            f"{min(walls) * 1e3:.1f} ms (best of 2: "
            f"{', '.join(f'{w * 1e3:.1f}' for w in walls)}), chunk device ms "
            f"{', '.join(f'{c:.2f}' for c in chunk_ms)} (sum "
            f"{sum(chunk_ms):.1f}), of which attention (the {L_} layers' "
            f"einsum, mask, softmax and casts) "
            f"{', '.join(f'{c:.2f}' for c in attn_chunk)} (sum "
            f"{sum(attn_chunk):.1f}); peak allocated "
            f"+{peak_c / 2**30:.2f} GiB over the resident {base / 2**30:.2f} GiB; decode at position "
            f"~{T}: {(n - 1) / dec_wall:.1f} tok/s ({dec_ms:.3f} ms a step "
            f"by CUDA events, {n - 1} replays); launches w4a8_gemv "
            f"{launches['w4a8_gemv']}, int8_gemm {launches['int8_gemm']}, "
            f"int8_gemv {launches['int8_gemv']}, attn_decode "
            f"{launches['attn_decode']}; card {card}")

        # (c) the graph loop against the eager loop from the chunked cache
        ref_e, logits_e = gen._decode_loop(tok, cache_e, n, None,
                                           with_logits=True)
        err = float((logits_g.float() - logits_e.float()).abs().max())
        if not torch.equal(out_g, ref_e) or err != 0:
            raise AssertionError(f"longctx: graph decode against eager: "
                                 f"tokens equal {torch.equal(out_g, ref_e)},"
                                 f" last-step logits max |d| {err}")
        del cache_e
        # (a) the integer products plain: the chunked prefill and the eager
        # decode from its own cache
        with plain_kernels(("qmm",)):
            last_p, cache_p = gen.prefill_chunked(ids, chunk, n)
            out_p = gen._decode_loop(last_p.argmax(-1).to(torch.int32)[
                :, None], cache_p, n, None)
        err_a = float((last.float() - last_p.float()).abs().max())
        if err_a != 0 or not torch.equal(out_p, out_g):
            raise AssertionError(f"longctx: against plain qmm: last logits "
                                 f"max |d| {err_a}, tokens equal "
                                 f"{torch.equal(out_p, out_g)}")
        del cache_p
        torch.cuda.empty_cache()
        log(f"longctx: (a) the chunked prefill and its {n} tokens against "
            f"plain qmm: last logits max |d| 0, tokens equal; (c) the graph "
            f"loop against the eager loop: {n} tokens equal, last-step "
            f"logits max |d| 0; the loop's buffers NaN-poisoned before")

        # (b) chunked against one piece (flash at the 16384 bucket, its
        # shape held against the plain version in phase 3): memory first,
        # then time; compared by the top-16 rule at depth 28 and
        # LONGCTX_CMP_DEPTH (printed: the flash route rounds otherwise than
        # the einsum, C-w6), held on the einsum route
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        one, _ = gen.prefill(ids)
        torch.cuda.synchronize()
        peak_o = torch.cuda.max_memory_allocated() - base
        t0 = time.perf_counter()
        one, _ = gen.prefill(ids)
        torch.cuda.synchronize()
        t_one = time.perf_counter() - t0
        log(f"longctx: one-piece prefill (T {T} padded to "
            f"{bucket_len(T)}, flash) "
            f"{t_one * 1e3:.1f} ms, peak allocated +{peak_o / 2**30:.2f} GiB"
            f" against the chunked prefill's +{peak_c / 2**30:.2f} GiB")
        top16_against(f"longctx: chunked against one piece (flash) at depth "
                      f"{gen.cfg.n_layers} (printed, C-w6)", last[0], one[0],
                      hold=False)
        del one
        g2 = depth_cut(gen, LONGCTX_CMP_DEPTH)
        lc, _ = g2.prefill_chunked(ids, chunk, n)
        lo, _ = g2.prefill(ids)
        top16_against(f"longctx: chunked against one piece (flash) at depth "
                      f"{LONGCTX_CMP_DEPTH} (printed, C-w6)", lc[0], lo[0],
                      hold=False)
        # every chunk offset on one route: the whole prompt in
        # LONGCTX_WIDE_CHUNK-row pieces (f32 scores of 8192 × 16384 a head)
        lw, _ = g2.prefill_chunked(ids, LONGCTX_WIDE_CHUNK, n)
        top16_against(f"longctx: {chunk}-row pieces against "
                      f"{LONGCTX_WIDE_CHUNK}-row pieces (einsum) at depth "
                      f"{LONGCTX_CMP_DEPTH}, T {T}", lc[0], lw[0], hold=True)
        d_w = float((lc.float() - lw.float()).abs().max())
        mag_w = float(lw.float().abs().max())
        # the one-piece einsum's f32 scores of T² fit the card up to
        # LONGCTX_EXACT_T rows: the prompt's first LONGCTX_EXACT_T ids, two
        # chunks against one piece on the same attention route, and the
        # flash one piece against the einsum one piece
        ids_e = ids[:, :LONGCTX_EXACT_T]
        lc, _ = g2.prefill_chunked(ids_e, chunk, n)
        with einsum_route():
            lo, _ = g2.prefill(ids_e)
        lf, _ = g2.prefill(ids_e)
        top16_against(f"longctx: chunked against one piece (einsum) at "
                      f"depth {LONGCTX_CMP_DEPTH}, T {ids_e.shape[1]}",
                      lc[0], lo[0], hold=True)
        top16_against(f"longctx: one piece on flash against one piece on "
                      f"the einsum at depth {LONGCTX_CMP_DEPTH}, T "
                      f"{ids_e.shape[1]} (printed, C-w6)", lf[0], lo[0],
                      hold=False)
        d_e = float((lc.float() - lo.float()).abs().max())
        d_f = float((lf.float() - lo.float()).abs().max())
        mag_e = float(lo.float().abs().max())
        log(f"longctx: (b) held at depth {LONGCTX_CMP_DEPTH}: last logits max"
            f" |d| {d_w:.4g} of max {mag_w:.4g} ({chunk}- against "
            f"{LONGCTX_WIDE_CHUNK}-row pieces, T {T}), {d_e:.4g} of "
            f"{mag_e:.4g} (pieces against one piece, T {LONGCTX_EXACT_T}); "
            f"flash against the einsum, one piece at T {LONGCTX_EXACT_T}: "
            f"{d_f:.4g}")
        del lc, lo, lw, lf, g2
        torch.cuda.empty_cache()
    return launches


GROUP = 128  # w_groupsize of path A (the reference's --w_groupsize 128)
# kernels each storage path must launch: path A (asym grouped W4, act_order
# rows, static asym activations) takes the group-blocked epilogue at every
# decoder site and the int8 head; path B (folded per-channel asym
# activations) the W4 GEMV / GEMM and the head; the KV paths the block
# path's integer kernels, and never attn_decode (it reads a float cache)
STORAGE_A_KERNELS = ("int8_gemv", "int8_gemm", "group_epilogue")
STORAGE_B_KERNELS = ("w4a8_gemv", "int8_gemv", "int8_gemm")
KV_KERNELS = ("w4a8_gemv", "int8_gemv", "int8_gemm")
KV_SLOTS, KV_POOL_ROWS, KV_TOKENS = 8, 1280, 16  # the engine pass's pool
KV_BURST = (77, 300, 513, 1000)  # id prompts, and two behind the prefix
KV_PREFIX, KV_SPEC_K = 256, 3
# path A's plain comparison at its full depth takes only the int32 group
# accumulators plain: the plain epilogue is a loop of float64 ops a group
# (316 groups a layer at prefill), and phase 3 holds group_epilogue bit-equal
# to it on its own (the block-diagonal views of _blockdiag_partials too)
STORAGE_A_PLAIN = ("int8_gemv", "int8_gemm")
STORAGE_DEPTH = 4  # the storage paths' decoder layers (28, the block
# path's, until the MiniCPM-V phase took its time; 8 until the long
# context phase and the golden's family entries did)


def storage_model(m: dict, kind: str) -> tuple:
    """Path A or B's (params, specs, state) at the block path's widths and
    depth, built as the pipeline builds them: float bf16 decoder weights
    (N(0, 1/fan_in), zero q/k/v biases) fake-quantized on RTN grids, the
    static activation scales calibrated on the full-VLM request (one
    decoder forward in "calib" mode), then realized by
    ``transform.recipes.realize_decoder_weights`` from the exact grids.
    A: asym W4 grids per 128-row group of each layer's rows in a seeded
    permutation (act_order's permuted layout: ``a_perm``), static asym
    per-tensor int8 activations. B: sym W4 per-channel grids, static asym
    per-channel activations folded into the weights (``a_fold``, the
    ``a_corr`` row). The embedding, final norm and int8 lm_head (with its
    spec and scale) are the block path's."""
    import torch

    from mquant_tpu_torch.calib.calibrate import finalize_state
    from mquant_tpu_torch.core import quant as Q
    from mquant_tpu_torch.core.formats import get_format
    from mquant_tpu_torch.models.layers import SiteSpec, normal_init
    from mquant_tpu_torch.models.llm import LLM_SITES, decoder_forward
    from mquant_tpu_torch.transform.recipes import (realize_decoder_weights,
                                                    rtn_quantize_decoder)

    base = m["gen"]
    cfg, dev = base.cfg, m["dev"]
    g = torch.Generator(device=dev).manual_seed(1000 + ord(kind))
    L, Hd, I = cfg.n_layers, cfg.hidden, cfg.inter_eff
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dims = {"q": (Hd, H * hd), "k": (Hd, KV * hd), "v": (Hd, KV * hd),
            "o": (H * hd, Hd), "gate": (Hd, I), "up": (Hd, I),
            "down": (I, Hd)}
    bf = dict(dtype=torch.bfloat16, device=dev)
    lay = {"ln1": base.params["layers"]["ln1"],
           "ln2": base.params["layers"]["ln2"]}
    for s, (din, dout) in dims.items():
        lay[s] = {"w": normal_init(g, (L, din, dout), None, **bf),
                  "b": (torch.zeros((L, dout), **bf)
                        if s in ("q", "k", "v") else None)}
    spec = (SiteSpec(w_bits=4, a_bits=8, a_static=True, a_symmetric=False)
            if kind == "A" else
            SiteSpec(w_bits=4, a_bits=8, a_static=True, a_per_channel=True,
                     a_symmetric=False))
    specs = {f"llm.{s}": spec for s in LLM_SITES}
    params = {"embed": base.params["embed"], "layers": lay,
              "ln_f": base.params["ln_f"]}
    t0 = time.perf_counter()
    if kind == "A":
        fmt = get_format(4, signed=False)
        qps = {}
        for s, (din, dout) in dims.items():
            w = lay[s]["w"]
            perm = torch.stack([torch.randperm(din, generator=g, device=dev)
                                for _ in range(L)])
            sc, zp = [], []
            for li in range(L):
                wp = w[li].float()[perm[li]].reshape(din // GROUP, GROUP,
                                                     dout)
                qp = Q.weight_qparams(wp, fmt, symmetric=False,
                                      reduce_axes=(-2,))
                w[li][perm[li]] = Q.fake_quantize(wp, qp, fmt).reshape(
                    din, dout).to(w.dtype)
                sc.append(qp.scale.reshape(-1, dout))
                zp.append(qp.zero_point.reshape(-1, dout))
            qps[s] = (torch.stack(sc), torch.stack(zp), perm)
    else:
        params, qps = rtn_quantize_decoder(cfg, params, specs,
                                           return_qparams=True)
    t1 = time.perf_counter()
    embeds, _ = image_request(m, 448, PREFILL)
    with torch.no_grad():
        # the head in float for the calibration forward (the block path's
        # int8 codes dequantized): its spec is left out, so it runs in fp
        head = base.params["lm_head"]
        fhead = {"w": (head["w_q"].float() * head["w_scale"]).to(
            torch.bfloat16)}
        stats = decoder_forward(cfg, {**params, "lm_head": fhead},
                                embeds()[0], specs=specs, mode="calib",
                                collect_stats=True)[2][0]
        del fhead
        state = finalize_state(specs, stats)
        t2 = time.perf_counter()
        params = realize_decoder_weights(params, specs, qps=qps, state=state)
    torch.cuda.synchronize()
    params["lm_head"] = base.params["lm_head"]
    specs["llm.lm_head"] = base.specs["llm.lm_head"]
    state["llm.lm_head"] = base.state["llm.lm_head"]
    torch.cuda.empty_cache()
    log(f"storage {kind}: grids {t1 - t0:.1f} s, calibration "
        f"{t2 - t1:.1f} s, realization {time.perf_counter() - t2:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return params, specs, state


def kv_writes_against_plain(path: str, gen, emb) -> None:
    """The quantized cache's new codes and scales (and int4 zero points) of
    a prefill's first layer bit-equal to the same quantizer on a CPU copy
    of the same K/V (the plain write)."""
    import torch

    from mquant_tpu_torch.models import llm

    seen = []
    write = llm._kv_entries

    def kept(kind, k, v):
        out = write(kind, k, v)
        if not seen:
            seen.append((kind, k.clone(), v.clone(), out))
        return out

    llm._kv_entries = kept
    try:
        gen.prefill(emb)
    finally:
        llm._kv_entries = write
    kind, k, v, out = seen[0]
    ref = write(kind, k.cpu(), v.cpu())
    for n in ref:
        if not torch.equal(out[n].cpu(), ref[n]):
            raise AssertionError(f"{path}: the cache write's {n} differs "
                                 "from the plain write on the same K/V")
    log(f"{path}: first layer's cache write ({', '.join(ref)} of "
        f"{tuple(k.shape)} K/V) bit-equal to the plain write")


def storage_request(path: str, gen, m: dict, card: str, kernels,
                    kv: bool = False, plain=None,
                    eos_batch: bool = True) -> tuple:
    """The full-VLM request through ``gen``, counted (it must launch
    ``kernels``; a quantized cache no attn_decode), its tokens checked, its
    prefill and 7 steps held against plain qmm (only the qmm kernels named
    in ``plain`` where given) with logits equal, its decode loop against
    the eager loop (``graph_decode``:
    NaN-poisoned buffers, the eos batch unless ``eos_batch`` is False, the
    step's times). Returns (launch counts, {request s, TTFT s, decode
    tok/s, graph step ms})."""
    import torch

    t0 = time.perf_counter()

    def mark(what):
        torch.cuda.synchronize()
        log(f"{path}: {what} at {time.perf_counter() - t0:.1f} s")

    embeds, _ = image_request(m, 448, PREFILL)
    with torch.no_grad():
        emb = embeds()[0]
        gen.generate_on_device(emb, max_new_tokens=4)  # warm-up
        mark("warm-up done")
        reset_launches()
        out, t_req, ttft = timed_request(gen, lambda: embeds()[0],
                                         GEN_TOKENS)
        launches = read_launches(path, kernels)
        if kv and launches["attn_decode"]:
            raise AssertionError(f"{path}: attn_decode launched on a "
                                 "quantized cache")
        check_tokens(path, out, GEN_TOKENS, gen.cfg.vocab)
        if kv:
            kv_writes_against_plain(path, gen, emb)
        against_plain(path, gen, lambda: gen.prefill(emb), names=plain,
                      exact=True)
        mark("against plain done")
        loop = graph_matches_eager(path, gen, emb, m, eos_batch=eos_batch)
        ((step, enq, stream),), _, _ = graph_step_runs(gen, emb, loop, 1)
        log(f"profile: decode step, graph ({path}): wall {step:.3f} ms a "
            f"step ({GEN_TOKENS - 1} replays, synchronized at both ends), "
            f"host enqueue {enq:.3f} ms a step, stream {stream:.3f} ms a "
            f"step (CUDA events); card {card}")
        mark("graph decode done")
    return launches, {"request_s": t_req, "ttft_s": ttft,
                      "decode_tok_s": (GEN_TOKENS - 1) / (t_req - ttft),
                      "graph_step_ms": step}


def pool_bytes(cfg, kvq, rows: int = KV_POOL_ROWS) -> int:
    """Bytes of an engine pool of KV_SLOTS slots and ``rows`` rows."""
    from mquant_tpu_torch.models.llm import init_cache

    c = init_cache(cfg, KV_SLOTS, rows, device="meta", quantized=kvq)
    return sum(t.numel() * t.element_size() for n, t in c.items()
               if n != "pos")


def kv_engine_pass(path: str, gen, kvq, m: dict, card: str) -> tuple:
    """An 8-slot engine pool of int8 / int4 KV over the block path's weights
    (grown to KV_POOL_ROWS rows, every pool tensor poisoned: NaN scales,
    the largest codes), a KV_PREFIX-id prefix registered: a mixed burst of
    KV_BURST id prompts and two behind the prefix, KV_TOKENS tokens each,
    counted; each request equal to itself sent alone afterwards, 2 prefix
    hits; then the same burst on a ``spec_k`` KV_SPEC_K engine of the same
    pool shape: every token equal. Returns (launch counts, numbers)."""
    import numpy as np
    import torch

    from mquant_tpu_torch.serve.engine import ServingEngine

    cfg = gen.cfg
    V = cfg.vocab

    def ids(n):
        return torch.randint(0, V, (n,), generator=m["g"],
                             device=m["dev"]).cpu().numpy()

    prefix = ids(KV_PREFIX)
    prompts = [ids(n) for n in KV_BURST] + [
        np.concatenate([prefix, ids(n)]) for n in (40, 90)]

    def engine(spec_k):
        eng = ServingEngine(cfg, gen.params, specs=gen.specs,
                            state=gen.state, mode="real", slots=KV_SLOTS,
                            max_len=2048, steps_per_block=8, kv_quant=kvq,
                            spec_k=spec_k)
        eng._grow(KV_POOL_ROWS)
        for n, t in eng.cache.items():
            if n not in ("pos", "rope_delta"):
                t.fill_(float("nan") if t.is_floating_point() else 127)
        eng.register_prefix(prefix)
        return eng

    def burst(eng, n=KV_TOKENS):
        rids = [eng.submit(p, max_new_tokens=n) for p in prompts]
        outs = eng.run()
        return [outs[r] for r in rids]

    with torch.no_grad():
        eng = engine(0)
        burst(eng, 2)  # warm-up: admissions and the decode block captured
        eng.prefix_hits = 0
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        outs = burst(eng)
        torch.cuda.synchronize()
        t_b = time.perf_counter() - t0
        launches = read_launches(f"{path} engine", KV_KERNELS)
        if launches["attn_decode"]:
            raise AssertionError(f"{path} engine: attn_decode launched on "
                                 "a quantized pool")
        if eng.prefix_hits != 2:
            raise AssertionError(f"{path} engine: {eng.prefix_hits} prefix "
                                 "hits, not 2")
        for i, p in enumerate(prompts):
            rid = eng.submit(p, max_new_tokens=KV_TOKENS)
            alone = eng.run()[rid]
            if alone != outs[i]:
                raise AssertionError(f"{path} engine: request {i} "
                                     f"{outs[i]} vs alone {alone}")
        spec = engine(KV_SPEC_K)
        burst(spec, 2)  # warm-up
        t0 = time.perf_counter()
        outs_s = burst(spec)
        torch.cuda.synchronize()
        t_s = time.perf_counter() - t0
        if outs_s != outs:
            raise AssertionError(f"{path} engine: spec_k {KV_SPEC_K} tokens "
                                 "differ from the greedy burst's")
        acc = spec.stats()["spec_accept_per_round"]
    n_tok = sum(len(o) for o in outs)
    log(f"{path} engine: {len(prompts)} requests ({KV_BURST} ids and 2 "
        f"behind a {KV_PREFIX}-id prefix), {KV_TOKENS} tokens each, on "
        f"{KV_SLOTS} slots x {KV_POOL_ROWS} rows: {t_b:.3f} s, "
        f"{n_tok / t_b:.1f} tok/s; each equal to itself alone, 2 prefix "
        f"hits; spec_k {KV_SPEC_K}: {t_s:.3f} s, tokens equal, acceptance "
        f"{acc:.2f} per row-round; card {card}")
    return launches, {"engine_burst_s": t_b, "engine_tok_s": n_tok / t_b,
                      "spec_burst_s": t_s}


def run_storage_phase(m: dict, card: str) -> list:
    """Phase 4 (c): paths A and B (``storage_model``) and the block path
    with int8 (path K8) and int4 (path K4) KV, each serving the full-VLM
    request (``storage_request``); K8 and K4 also through the engine
    (``kv_engine_pass``). One line of each path's request s, TTFT, decode
    tok/s and graph step ms beside path block's, and the pool bytes of
    bf16, int8 and int4 KV. Returns the launch counts of its paths."""
    import torch

    from mquant_tpu_torch.serve.generate import Generator

    base = depth_cut(m["gen"], STORAGE_DEPTH)
    m = {**m, "gen": base}
    t0 = time.perf_counter()
    counts, rows = [], {}
    rows["block"] = m["block_row"]  # run_slice's at depth 28, in this run
    for kind, kernels in (("A", STORAGE_A_KERNELS),
                          ("B", STORAGE_B_KERNELS)):
        params, specs, state = storage_model(m, kind)
        gen = Generator(base.cfg, params, specs=specs, state=state,
                        mode="real", max_len=PREFILL + GEN_TOKENS)
        del params
        c, rows[kind] = storage_request(
            f"storage {kind}", gen, m, card, kernels,
            plain=STORAGE_A_PLAIN if kind == "A" else None,
            eos_batch=False)  # the cache is the block path's (bf16)
        counts.append(c)
        log(f"storage phase: path {kind} done at {time.perf_counter() - t0:.1f}"
            " s")
        del gen
        gc.collect()
        torch.cuda.empty_cache()
    for kvq in (8, 4):
        path = f"kv int{kvq}"
        gen = Generator(base.cfg, base.params, specs=base.specs,
                        state=base.state, mode="real",
                        max_len=PREFILL + GEN_TOKENS, kv_quant=kvq)
        c, rows[f"K{kvq}"] = storage_request(path, gen, m, card, KV_KERNELS,
                                             kv=True)
        counts.append(c)
        log(f"storage phase: path K{kvq} done at "
            f"{time.perf_counter() - t0:.1f} s")
        c, eng_row = kv_engine_pass(path, gen, kvq, m, card)
        rows[f"K{kvq}"].update(eng_row)
        counts.append(c)
        log(f"storage phase: K{kvq} engine done at "
            f"{time.perf_counter() - t0:.1f} s")
        del gen
        gc.collect()
        torch.cuda.empty_cache()
    cfg = base.cfg
    for name, r in rows.items():
        at = 28 if name == "block" else STORAGE_DEPTH
        log(f"storage phase, path {name} at depth {at}: request "
            f"{r['request_s']:.3f} s, TTFT {r['ttft_s'] * 1e3:.1f} ms, decode "
            f"{r['decode_tok_s']:.1f} tok/s, graph step "
            f"{r['graph_step_ms']:.3f} ms; card {card}")
    log(f"storage phase: pool of {KV_SLOTS} slots x {KV_POOL_ROWS} rows at "
        f"depth {cfg.n_layers}: bf16 {pool_bytes(cfg, False) / 2**30:.3f} "
        f"GiB, int8 {pool_bytes(cfg, 8) / 2**30:.3f} GiB, int4 "
        f"{pool_bytes(cfg, 4) / 2**30:.3f} GiB")
    log(json.dumps({"storage_phase": rows, "seconds":
                    time.perf_counter() - t0, "card": card}))
    return counts


PIPE_BATCHES = 32  # calibration batches (the reference calibrates on 128)
PIPE_IMAGE = 448  # their images: 1024 patches, 256 image tokens, + 32 text
PIPE_KERNELS = SLICE_KERNELS
PIPE_DEPTH = 2  # the synthetic pipeline phase's LLM layers (4 until the
# MiniCPM-V phase took its time; the checkpoint phase runs the pipeline
# at CKPT_DEPTH)


@contextlib.contextmanager
def gptq_proxies(store: list):
    """Wraps the GPTQ driver's ``gptq_quantize_matrix``: for every site it
    quantizes, appends (site, the proxy loss tr(ΔWᵀ H ΔW) of GPTQ's weight,
    that of round-to-nearest on the same grid rule, the fallback flag) and
    adds the check's own device seconds to ``store``'s first entry."""
    import torch

    from mquant_tpu_torch.core import quant as Q
    from mquant_tpu_torch.core.formats import get_format
    from mquant_tpu_torch.gptq import core
    from mquant_tpu_torch.models.llm import LLM_SITES

    saved = core.gptq_quantize_matrix
    store.append({"seconds": 0.0})

    def proxy(Wq, W, H):
        d = Wq.float() - W
        return float((d * (H @ d)).sum())

    def wrapped(W, H, bits, **kw):
        res = saved(W, H, bits, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fmt = get_format(bits, signed=kw.get("sym", True))
        Wf = W.float()
        qp = Q.weight_qparams(Wf, fmt, per_channel=True,
                              symmetric=kw.get("sym", True), recip=True)
        site = LLM_SITES[(len(store) - 1) % len(LLM_SITES)]
        store.append((site, proxy(res.w, Wf, H),
                      proxy(Q.fake_quantize(Wf, qp, fmt), Wf, H),
                      bool(res.used_fallback)))
        torch.cuda.synchronize()
        store[0]["seconds"] += time.perf_counter() - t0
        return res

    core.gptq_quantize_matrix = wrapped
    try:
        yield
    finally:
        core.gptq_quantize_matrix = saved


@contextlib.contextmanager
def realize_lossless(store: list):
    """Wraps ``realize_decoder_weights``: every realized site's codes must
    equal round(w / scale) of the GPTQ weight w on its grid, and code ·
    scale rounded to w's dtype must give w back (lossless); appends the
    sites' layer counts to ``store``."""
    import torch

    from mquant_tpu_torch.models.llm import LLM_SITES
    from mquant_tpu_torch.transform import recipes

    saved = recipes.realize_decoder_weights

    def wrapped(params, specs, pack_int4=False, qps=None, state=None):
        out = saved(params, specs, pack_int4=pack_int4, qps=qps, state=state)
        for s in LLM_SITES:
            w, codes = params["layers"][s]["w"], out["layers"][s]["w_q"]
            for li in range(w.shape[0]):
                scale = qps[s][0][li]
                ref = torch.clamp(torch.round(w[li].float() / scale), -8, 7)
                if not (torch.equal(codes[li], ref.to(torch.int8))
                        and torch.equal((codes[li].float() * scale).to(
                            w.dtype), w[li])):
                    raise AssertionError(f"pipeline: llm.{s} layer {li}: "
                                         "realized codes are not the GPTQ "
                                         "weight's")
            store.append((s, w.shape[0]))
        return out

    recipes.realize_decoder_weights = wrapped
    try:
        yield
    finally:
        recipes.realize_decoder_weights = saved


def check_graph_walk(seed: int, dev: str = "cuda") -> None:
    """The GPTQ walk with its full blocks replayed from one CUDA graph
    (``gptq.core._BlockGraph``, the card's route) against the same walk
    eager: weights and scales bit-equal, at q's (3584, 3584) with
    act_order and at an 18943-row ``down`` slice of 1024 columns."""
    import torch

    from mquant_tpu_torch.gptq import core

    g = torch.Generator(device=dev).manual_seed(seed)
    for n, out in ((3584, 3584), (18943, 1024)):
        x = torch.randn((2048, n), generator=g, device=dev)
        W = torch.randn((n, out), generator=g, device=dev) * 0.02
        H = core.accumulate_hessian(None, x)
        perm = torch.argsort(-torch.diagonal(H), stable=True)
        Hp = H[perm][:, perm]
        U = core._hinv_cholesky(Hp, 0.01)
        args = (W, torch.diagonal(Hp), U, perm)
        kw = dict(bits=4, group_size=None, mse_clip=False, sym=True)
        a = core._gptq_walk(*args, graph=True, **kw)
        b = core._gptq_walk(*args, graph=False, **kw)
        if not (torch.equal(a.w, b.w) and torch.equal(a.scale, b.scale)):
            raise AssertionError(f"GPTQ walk ({n}, {out}): the CUDA graph's "
                                 "result differs from the eager walk's")
    log("pipeline: the GPTQ walk's CUDA-graph blocks bit-equal to the eager "
        "walk at (3584, 3584) and (18943, 1024), act_order")


def run_pipeline_phase(card: str, seed: int, depth: int = PIPE_DEPTH,
                       dev: str = "cuda", gen_tokens: int = GEN_TOKENS) -> list:
    """Phase 4, the pipeline: the port's ``run_pipeline`` quantizes
    Qwen2-VL-7B (published widths, ``depth`` LLM layers, seeded random
    weights) in the reference's headline W4A8 configuration (full online
    Hadamard before ``down``, RMS split, GPTQ with act_order on PIPE_BATCHES
    synthetic batches of a PIPE_IMAGE² image and 32 text tokens, RTN W8
    vision tower and merger, static per-tensor int8 activations, realized
    int storage) and writes its artifact to a temporary directory. Prints
    each stage's seconds and peak memory and the GPTQ time split; checks no
    RTN fallback, GPTQ's proxy loss no worse than round-to-nearest's on
    every site, lossless realization; then ``build_runner_from_artifact``
    serves one request (a 448² image in a PREFILL-token prompt,
    ``gen_tokens`` tokens), counted, its GEMMs at K = 18943 (``down``) on
    the TMA ``int8_gemm`` and ``int8_gemv``, its prefill and first steps
    held against the plain integer products (:func:`against_plain`).
    Returns the launch counts of the request."""
    import tempfile

    import torch

    from mquant_tpu_torch.models.qwen2vl import Qwen2VLConfig
    from mquant_tpu_torch.pipeline import QuantizeConfig

    base = Qwen2VLConfig.qwen2vl_7b()
    cfg = dataclasses.replace(base, llm=dataclasses.replace(
        base.llm, n_layers=depth))
    q = QuantizeConfig(rotate=True, online_llm_hadamard=True,
                       online_had_mode="full", llm_split=True, llm_w_bits=4,
                       act_order=True, visual_w_bits=8, llm_a_bits=8,
                       visual_a_bits=8, calib_num=PIPE_BATCHES * 16,
                       nsamples=PIPE_BATCHES, realize_int=True, seed=seed)
    with torch.no_grad():
        check_graph_walk(seed, dev)
    art = tempfile.mkdtemp(prefix="mquant_pipeline_")
    try:
        return _pipeline_phase(card, seed, depth, dev, gen_tokens, cfg, q,
                               art)
    finally:
        shutil.rmtree(art)


def _pipeline_phase(card, seed, depth, dev, gen_tokens, cfg, q, art):
    import torch

    from mquant_tpu_torch.pipeline import run_pipeline
    from mquant_tpu_torch.serve.server import build_runner_from_artifact

    proxies, realized = [], []
    with torch.no_grad(), gptq_proxies(proxies), realize_lossless(realized):
        _, params, _, _, info = run_pipeline(
            "Qwen2-VL-7B", q, cfg=cfg, artifact_dir=art,
            image_size=PIPE_IMAGE, device=dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner = build_runner_from_artifact(
        art, device=dev, image_size=ART_IMAGE_SIZE,
        tokenizer=id_tokenizer(), max_len=PREFILL + gen_tokens)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0

    stages = info["stages"]
    for name, st in stages.items():
        peak = ("not measured" if st["peak_bytes"] is None
                else f"{st['peak_bytes'] / 2**30:.2f} GiB")
        log(f"pipeline: stage {name}: {st['seconds']:.2f} s, peak {peak}; "
            f"card {card}")
    rep = info["gptq"]
    sec = rep["seconds"]
    log(f"pipeline: GPTQ {rep['sites']} sites at depth {depth}: stage "
        f"replays + Hessians {sec['hessian']:.2f} s, factorizations "
        f"{sec['factor']:.2f} s, walks {sec['walk']:.2f} s (the proxy "
        f"check beside them {proxies[0]['seconds']:.2f} s); RTN fallbacks "
        f"{len(rep['fallbacks'])}; artifact {info['artifact_bytes']} bytes "
        f"({info['artifact_bytes'] / 2**30:.2f} GiB); "
        f"build_runner_from_artifact {t_load:.1f} s; card {card}")
    if rep["fallbacks"] or any(fb for *_, fb in proxies[1:]):
        raise AssertionError(f"pipeline: RTN fallbacks {rep['fallbacks']}")
    sums = {}
    for site, pg, pr, _ in proxies[1:]:
        g, r = sums.get(site, (0.0, 0.0))
        sums[site] = (g + pg, r + pr)
    worse = [(i, p) for i, p in enumerate(proxies[1:]) if p[1] > p[2]]
    log("pipeline: GPTQ proxy loss tr(dW^T H dW) summed over layers, GPTQ "
        "vs round-to-nearest: " + ", ".join(
            f"{s} {g:.4g} vs {r:.4g} ({g / r:.3f})"
            for s, (g, r) in sums.items()))
    if worse or len(proxies) - 1 != rep["sites"]:
        raise AssertionError(f"pipeline: GPTQ worse than RTN at {worse}")
    if sum(n for _, n in realized) != rep["sites"]:
        raise AssertionError(f"pipeline: realized {realized}, GPTQ sites "
                             f"{rep['sites']}")
    log(f"pipeline: realization lossless on {rep['sites']} sites (codes = "
        "round(w / scale), codes x scale = w)")

    K = cfg.llm.intermediate - 1
    single, _ = artifact_prompts(runner, seed)
    gen = runner.gen
    with torch.no_grad():
        runner.generate(single, max_new_tokens=4)  # warm-up; not counted
        torch.cuda.synchronize()
        reset_launches()
        depths = []
        with gemm_depths(depths):
            out, t_req, ttft = timed(lambda mark: runner.generate(
                single, max_new_tokens=gen_tokens, on_first_token=mark))
        launches = read_launches("pipeline", PIPE_KERNELS)
        check_tokens("pipeline", [out], gen_tokens, cfg.llm.vocab)
        down = sum(1 for n, d, moved in depths
                   if n == "int8_gemm" and d == K and moved == (n,))
        if down != depth or launches["int8_gemm_ragged"]:
            raise AssertionError(f"pipeline: {down} int8_gemm calls at K = "
                                 f"{K}, expected {depth}; int8_gemm_ragged "
                                 f"{launches['int8_gemm_ragged']}")
        (emb,), (pos,) = runner_inputs(runner, [single])
        pos = torch.from_numpy(pos).to(dev)
        against_plain("pipeline", gen,
                      lambda: gen.prefill(emb[None], positions=pos))
    n_prompt = runner.build_inputs(single)[0].shape[1]
    log(f"pipeline: the artifact's request ({n_prompt}-token prompt with a "
        f"448² image, {gen_tokens} tokens) {t_req:.3f} s; TTFT "
        f"{ttft * 1e3:.1f} ms; decode {(gen_tokens - 1) / (t_req - ttft):.1f}"
        f" tok/s; launches w4a8_gemv {launches['w4a8_gemv']}, int8_gemm "
        f"{launches['int8_gemm']} ({down} at K = {K}), int8_gemv "
        f"{launches['int8_gemv']}, attn_decode {launches['attn_decode']}; "
        f"card {card}")
    del gen, runner
    gc.collect()
    torch.cuda.empty_cache()
    return [launches]


CKPT_SHARD_BYTES = 5 * 2**30  # the HF checkpoint's shards (HF's 5 GB)
CKPT_DEPTH = 2  # the checkpoint phase's LLM layers: 28 until the InternVL
# phase took its time, 14 until the GLM-4V phase did, 4 until the long
# context phase and the other families' golden entries did (the evaluation
# phase runs on its runner)
CKPT_BATCHES = 8  # the checkpoint pipeline's calibration batches (a 448²
# image each; 1/16 of the reference's 128 (16 until the long context phase
# came), a quarter of the synthetic phase's, to keep the script within its
# time: its stage seconds are at this size)
STREAM_DEPTH = 2  # the host-streaming GPTQ check's decoder layers (4 until
# the long context phase came)
STREAM_BATCHES = 8  # its decoder-input batches of STREAM_TOKENS tokens
STREAM_TOKENS = 512


def tree_digest(tree) -> str:
    """A digest of a params tree, position- and bit-sensitive: per leaf (in
    sorted path order) the int64 sum of its 16-/32-bit patterns times
    their positions mod 8191 plus one, hashed with the paths, shapes and
    dtypes. None leaves and absent keys count alike."""
    import hashlib

    import torch

    h = hashlib.sha256()

    def walk(t, path):
        if t is None:
            return
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}/{k}")
            return
        bits = {2: torch.int16, 4: torch.int32, 1: torch.int8}[
            t.element_size()]
        flat = t.detach().reshape(-1).view(bits)
        acc = torch.zeros((), dtype=torch.int64, device=t.device)
        for i in range(0, flat.numel(), 1 << 26):
            c = flat[i:i + (1 << 26)].long()
            w = torch.arange(i, i + c.numel(), device=t.device) % 8191 + 1
            acc += (c * w).sum()
        h.update(f"{path}:{tuple(t.shape)}:{t.dtype}:{int(acc)};".encode())

    walk(tree, "")
    return h.hexdigest()[:16]


def same_tree(what: str, a, b, path: str = "") -> int:
    """Leaf-for-leaf torch.equal of two trees (a None leaf and an absent
    key alike); returns the leaves compared."""
    import torch

    if isinstance(a, dict) or isinstance(b, dict):
        a, b = a or {}, b or {}
        return sum(same_tree(what, a.get(k), b.get(k), f"{path}/{k}")
                   for k in sorted(set(a) | set(b)))
    if isinstance(a, tuple) or isinstance(b, tuple):
        if type(a) is not type(b):
            raise AssertionError(f"{what}: {path}: {type(a)} vs {type(b)}")
        return sum(same_tree(what, x, y, f"{path}.{f}")
                   for x, y, f in zip(a, b, a._fields))
    if a is None or b is None:
        if a is not b:
            raise AssertionError(f"{what}: {path}: one side is None")
        return 0
    if a.dtype != b.dtype or not torch.equal(a, b.to(a.device)):
        raise AssertionError(f"{what}: {path} differs")
    return 1


def free_gib(path: str) -> str:
    return f"{shutil.disk_usage(path).free / 2**30:.1f} GiB free"


def run_checkpoint_phase(card: str, seed: int, depth: int = CKPT_DEPTH,
                         dev: str = "cuda", gen_tokens: int = GEN_TOKENS
                         ) -> list:
    """Phase 4, the offline pipeline from an HF checkpoint: Qwen2-VL-7B's
    published widths at ``depth`` LLM layers, seeded random bf16 weights
    written by ``models.loader.save_qwen2vl_hf`` as a sharded HF checkpoint
    (HF names, the fused visual qkv, the (out, C, T, ph, pw) conv, an
    index) with the port's safetensors writer; ``run_pipeline(model_dir=)``
    with SmoothQuant (alpha 0.5), the online-Hadamard gate, the head gate,
    auto bits (5.0 average), visual GPTQ and the LLM's GPTQ W4 with
    act_order on CKPT_BATCHES synthetic batches of a PIPE_IMAGE² image,
    realized, with an artifact. Checks: the loaded tree equal leaf for leaf
    to the drawn one (their digests printed), no RTN fallback in either
    GPTQ; prints each stage's seconds and peak memory, the gates' picks
    and numbers, the allocation report. Then the export
    (``export_safetensors`` of params and state) read back with
    ``import_safetensors``, every leaf equal; one request (a 448² image in
    a PREFILL-token prompt, ``gen_tokens`` tokens) served from the artifact
    through ``build_runner_from_artifact``, counted per kernel and held
    against the plain integer products; the evaluation phase on the same
    runner (:func:`run_eval_phase`); and at STREAM_DEPTH layers GPTQ with
    ``stream_from_host`` and with ``realize_on_device`` too against the
    resident run: codes bit-equal, a lower device peak. Each directory is
    deleted as soon as it has been read. Returns the launch counts of the
    request and of the evaluation."""
    import tempfile

    import torch

    from mquant_tpu_torch.models.loader import save_qwen2vl_hf
    from mquant_tpu_torch.models.qwen2vl import (Qwen2VLConfig,
                                                 init_qwen2vl_params)
    from mquant_tpu_torch.pipeline import QuantizeConfig

    base = Qwen2VLConfig.qwen2vl_7b()
    cfg = dataclasses.replace(base, llm=dataclasses.replace(
        base.llm, n_layers=depth))
    root = tempfile.mkdtemp(prefix="mquant_ckpt_")
    try:
        ckpt = os.path.join(root, "hf")
        g = torch.Generator(device=dev).manual_seed(seed + 101)
        with torch.no_grad():
            drawn = init_qwen2vl_params(cfg, g, device=dev)
        drawn["vit"]["patch_embed"]["b"] = None  # HF's conv has no bias
        torch.cuda.synchronize()
        log(f"checkpoint: {root}: {free_gib(root)} before the write")
        t0 = time.perf_counter()
        n = save_qwen2vl_hf(cfg, drawn, ckpt, max_shard_bytes=CKPT_SHARD_BYTES)
        dt = time.perf_counter() - t0
        shards = len([f for f in os.listdir(ckpt) if f.endswith(".safetensors")])
        log(f"checkpoint: Qwen2-VL-7B widths, depth {depth}, bf16: {n} bytes "
            f"in {shards} shards written in {dt:.2f} s ({n / dt / 1e9:.2f} "
            f"GB/s, from the card through the host; page cache warm); "
            f"{free_gib(root)}; card {card}")
        digest = tree_digest(drawn)
        q = QuantizeConfig(rotate=True, online_llm_hadamard=True,
                           online_had_mode="auto", llm_split=True,
                           smooth_alpha=0.5, lm_head_bits="auto",
                           auto_bits=5.0, visual_w_rtn=False, llm_w_bits=4,
                           act_order=True, visual_w_bits=8, llm_a_bits=8,
                           visual_a_bits=8, calib_num=CKPT_BATCHES * 16,
                           nsamples=CKPT_BATCHES, realize_int=True,
                           seed=seed)
        return _checkpoint_phase(card, seed, cfg, q, root, ckpt, drawn,
                                 digest, dev, gen_tokens)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _checkpoint_phase(card, seed, cfg, q, root, ckpt, drawn, digest, dev,
                      gen_tokens):
    import torch

    from mquant_tpu_torch.models import loader
    from mquant_tpu_torch.pipeline import run_pipeline
    from mquant_tpu_torch.serve.server import build_runner_from_artifact
    from mquant_tpu_torch.utils.autobits import (allocation_report,
                                                 site_weight_elems)

    saved_load = loader.load_model
    seen = {}

    def load_and_check(*a, **kw):
        # the loaded tree against the drawn one before the pipeline moves on
        tree = saved_load(*a, **kw)
        torch.cuda.synchronize()
        seen["digest"] = tree_digest(tree)
        seen["leaves"] = same_tree("checkpoint: loaded vs drawn", drawn,
                                   tree)
        drawn.clear()
        gc.collect()
        torch.cuda.empty_cache()
        return tree

    art = os.path.join(root, "artifact")
    loader.load_model = load_and_check
    try:
        with torch.no_grad():
            _, params, state, specs, info = run_pipeline(
                "Qwen2-VL-7B", q, cfg=cfg, model_dir=ckpt, artifact_dir=art,
                image_size=PIPE_IMAGE, device=dev)
    finally:
        loader.load_model = saved_load
    shutil.rmtree(ckpt)
    if seen.get("digest") != digest:
        raise AssertionError(f"checkpoint: loaded digest {seen.get('digest')}"
                             f" vs drawn {digest}")
    log(f"checkpoint: the loaded tree equal to the drawn weights after the "
        f"surgery: {seen['leaves']} leaves torch.equal, digest {digest} both;"
        f" card {card}")
    for name, st in info["stages"].items():
        peak = ("not measured" if st["peak_bytes"] is None
                else f"{st['peak_bytes'] / 2**30:.2f} GiB")
        log(f"checkpoint pipeline: stage {name}: {st['seconds']:.2f} s, peak "
            f"{peak} (calibration {q.nsamples} of the reference's 128 "
            f"batches); card {card}")
    had = info["online_had_auto"]
    log(f"checkpoint pipeline: online-Hadamard gate picked {had['picked']}: "
        "relative down-output errors " + ", ".join(
            f"{k} {v:.6g}" for k, v in had.items() if k != "picked")
        + f"; card {card}")
    r = info["lm_head_ratios"]
    log(f"checkpoint pipeline: head gate picked W{info['lm_head_bits']}: "
        f"head-only perplexity ratios W4 {r[4]:.6f}, W8 {r[8]:.6f} (gate "
        f"{q.lm_head_gate}); card {card}")
    log(f"checkpoint pipeline: auto-bits allocation (target 5.0; card "
        f"{card}):\n" +
        allocation_report(info["autobits_sens"],
                          site_weight_elems(params, specs), info["autobits"]))
    rep, vrep = info["gptq"], info["vis_gptq"]
    sec = rep["seconds"]
    log(f"checkpoint pipeline: visual GPTQ {vrep['sites']} sites (patch "
        f"embed, {cfg.vit.n_layers} blocks, merger) on {q.nsamples} of the "
        f"reference's 128 calibration batches, RTN fallbacks "
        f"{len(vrep['fallbacks'])}; LLM GPTQ {rep['sites']} sites: stage "
        f"replays + Hessians {sec['hessian']:.2f} s, factorizations "
        f"{sec['factor']:.2f} s, walks {sec['walk']:.2f} s, RTN fallbacks "
        f"{len(rep['fallbacks'])}; artifact {info['artifact_bytes']} bytes; "
        f"card {card}")
    want_vis = 1 + 6 * cfg.vit.n_layers + 2
    if (rep["fallbacks"] or vrep["fallbacks"] or vrep["sites"] != want_vis
            or rep["sites"] != 7 * cfg.llm.n_layers):
        raise AssertionError(f"checkpoint pipeline: GPTQ sites {rep['sites']}"
                             f" / {vrep['sites']}, RTN fallbacks "
                             f"{rep['fallbacks']} / {vrep['fallbacks']}")
    run_export(card, root, cfg, params, state, dev)
    del params, state
    gc.collect()
    torch.cuda.empty_cache()

    runner = build_runner_from_artifact(
        art, device=dev, image_size=ART_IMAGE_SIZE, tokenizer=id_tokenizer(),
        max_len=PREFILL + gen_tokens)
    shutil.rmtree(art)
    bits = {s: specs[f"llm.{s}"].w_bits for s in ("q", "k", "v", "o", "gate",
                                                   "up", "down", "lm_head")}
    # decode: packed W4 layer sites on w4a8_gemv; W8 sites, the split
    # (odd-row) down and the head (its codes one a byte) on int8_gemv
    needed = {"int8_gemm", "int8_gemv", "attn_decode"}
    if any(bits[s] == 4 for s in ("q", "k", "v", "o", "gate", "up")):
        needed.add("w4a8_gemv")
    single, _ = artifact_prompts(runner, seed)
    gen = runner.gen
    with torch.no_grad():
        runner.generate(single, max_new_tokens=4)  # warm-up; not counted
        torch.cuda.synchronize()
        reset_launches()
        out, t_req, ttft = timed(lambda mark: runner.generate(
            single, max_new_tokens=gen_tokens, on_first_token=mark))
        launches = read_launches("checkpoint request", sorted(needed))
        check_tokens("checkpoint request", [out], gen_tokens, cfg.llm.vocab)
        (emb,), (pos,) = runner_inputs(runner, [single])
        pos = torch.from_numpy(pos).to(dev)
        against_plain("checkpoint request", gen,
                      lambda: gen.prefill(emb[None], positions=pos))
    log(f"checkpoint request: the artifact's request (448² image, "
        f"{runner.build_inputs(single)[0].shape[1]}-token prompt, "
        f"{gen_tokens} tokens; LLM weight bits {bits}) {t_req:.3f} s; TTFT "
        f"{ttft * 1e3:.1f} ms; decode {(gen_tokens - 1) / (t_req - ttft):.1f}"
        f" tok/s; launches " + ", ".join(
            f"{k} {launches[k]}" for k in sorted(needed)) + f"; card {card}")
    del gen
    with cli_check(root, dev) as cli:
        t0 = time.perf_counter()
        eval_launches = run_eval_phase(runner, card, seed, info, dev)
        log(f"eval phase: {time.perf_counter() - t0:.1f} s; card {card}")
        del runner
        gc.collect()
        torch.cuda.empty_cache()
        run_stream_check(card, seed, dev)
        cli_check_result(cli, card, root, dev)
    return [launches, eval_launches]


CLI_FLAGS = ("--rotate", "--online_llm_hadamard", "--llm_split",
             "--act_order", "--calib_num", "32", "--nsamples", "8",
             "--smooth_alpha", "0.5", "--fp32_had", "--online_had_mode",
             "auto", "--lm_head_bits", "auto", "--lm_head_gate", "1.002",
             "--auto_bits", "5", "--auto_bits_low", "4", "--auto_bits_high",
             "8", "--visual_w_gptq", "--visual_static", "--llm_static",
             "--realize_int")


def cli_check(root: str, dev: str = "cuda") -> Child:
    """``python -m mquant_tpu_torch.quant_vlm`` on ``dev`` with every flag
    of the pipeline's options (CLI_FLAGS), ``--model_dir`` a tiny HF
    checkpoint written by ``save_qwen2vl_hf``, ``--tiny``, an artifact,
    ``--export_safetensors`` and ``--log_file``, started beside the
    evaluation phase (:func:`cli_check_result` collects it)."""
    import torch

    from mquant_tpu_torch.models.loader import save_qwen2vl_hf
    from mquant_tpu_torch.models.qwen2vl import (Qwen2VLConfig,
                                                 init_qwen2vl_params)

    cfg = Qwen2VLConfig.tiny()
    ckpt, exp = os.path.join(root, "tiny_hf"), os.path.join(root, "tiny_exp")
    save_qwen2vl_hf(cfg, init_qwen2vl_params(
        cfg, torch.Generator().manual_seed(7), device="cpu"), ckpt)
    log_file = os.path.join(root, "tiny_log", "quant_vlm.log")
    cmd = [sys.executable, "-m", "mquant_tpu_torch.quant_vlm", "--tiny",
           "--device", dev, "--model_dir", ckpt, *CLI_FLAGS, "--artifact",
           os.path.join(root, "tiny_art"), "--export_safetensors", exp,
           "--log_file", log_file]
    return Child(cmd, root, "tiny_cli")


def cli_check_result(cli: Child, card: str, root: str, dev: str = "cuda"
                     ) -> None:
    """:func:`cli_check`'s run: exit 0, no RTN fallback, the gates' picks in
    the summary, the export read back onto the card by
    ``import_safetensors``."""
    from mquant_tpu_torch.utils.checkpoint import import_safetensors

    exp = os.path.join(root, "tiny_exp")
    log_file = os.path.join(root, "tiny_log", "quant_vlm.log")
    rc, stdout, stderr, dt = cli.result()
    if rc != 0:
        raise AssertionError(f"quant_vlm CLI: exit {rc}: {stderr[-3000:]}")
    summary = json.loads(stdout.strip().splitlines()[-1])
    params, md = import_safetensors(os.path.join(exp, "params.safetensors"),
                                    device=dev)
    if (summary["gptq_fallbacks"] or summary["visual_gptq_fallbacks"]
            or summary["visual_gptq_sites"] != 15 or md["model"] != (
                "Qwen2-VL-7B") or "load" not in summary["stages"]
            or "pipeline done" not in open(log_file).read()):
        raise AssertionError(f"quant_vlm CLI: summary {summary}, metadata "
                             f"{md}")
    log(f"quant_vlm CLI on {summary['device']}: --tiny --model_dir (an HF "
        f"checkpoint of save_qwen2vl_hf) with {' '.join(CLI_FLAGS)} "
        f"--export_safetensors: exit 0 in {dt:.1f} s (the process's start "
        f"included; beside the evaluation phase); Hadamard pick {summary['online_had_auto']['picked']}, "
        f"head W{summary['lm_head_bits']}, {len(summary['autobits'])} sites "
        f"allocated, GPTQ {summary['gptq_sites']} + visual "
        f"{summary['visual_gptq_sites']} sites, no RTN fallback; the export "
        f"({summary['export_bytes']} bytes) read back onto the card, "
        f"{len(params['llm']['layers'])} layer sites; card {card}")


def run_export(card: str, root: str, cfg, params, state, dev: str) -> None:
    """``export_safetensors`` of the pipeline's params and state (the CLI's
    ``--export_safetensors`` files), then ``import_safetensors`` back onto
    the card: every leaf equal. Prints bytes and seconds; deletes the
    files."""
    import torch

    from mquant_tpu_torch.utils import checkpoint as CK

    exp = os.path.join(root, "export")
    os.makedirs(exp)
    meta = {"model": "Qwen2-VL-7B",
            "config": json.dumps(CK.config_to_dict(cfg))}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = CK.export_safetensors(params, os.path.join(exp, "params.safetensors"),
                              extra_meta=meta)
    n += CK.export_safetensors(state, os.path.join(exp, "state.safetensors"))
    t_w = time.perf_counter() - t0
    log(f"export: {free_gib(root)} after the write")
    t0 = time.perf_counter()
    back, md = CK.import_safetensors(os.path.join(exp, "params.safetensors"),
                                     device=dev)
    back_st, _ = CK.import_safetensors(os.path.join(exp, "state.safetensors"),
                                       device=dev)
    torch.cuda.synchronize()
    t_r = time.perf_counter() - t0
    shutil.rmtree(exp)
    leaves = same_tree("export: params read back", params, back)
    leaves += same_tree("export: state read back", state, back_st)
    if md != meta:
        raise AssertionError(f"export: metadata {md}")
    log(f"export: params + state {n} bytes written in {t_w:.2f} s "
        f"({n / t_w / 1e9:.2f} GB/s) and read back onto the card in "
        f"{t_r:.2f} s ({n / t_r / 1e9:.2f} GB/s; page cache warm): "
        f"{leaves} leaves equal; card {card}")
    del back, back_st


def run_stream_check(card: str, seed: int, dev: str = "cuda") -> None:
    """``gptq_quantize_decoder`` at Qwen2-VL-7B widths and STREAM_DEPTH
    layers (seeded bf16 weights, the headline W4 specs with the full online
    Hadamard before ``down``, act_order) on STREAM_BATCHES random decoder
    inputs: resident on the card, then with the layers in pinned host
    memory (``stream_from_host``), then with ``realize_on_device`` too.
    The streamed weights bit-equal to the resident ones, the realized codes
    and scales equal to ``realize_decoder_weights`` on the resident run's
    grids, each streamed peak of device memory below the resident one."""
    import torch

    from mquant_tpu_torch.gptq.driver import GPTQConfig, gptq_quantize_decoder
    from mquant_tpu_torch.models.llm import LLM_SITES, init_decoder_params
    from mquant_tpu_torch.models.qwen2vl import Qwen2VLConfig
    from mquant_tpu_torch.pipeline import QuantizeConfig, build_specs
    from mquant_tpu_torch.transform.recipes import realize_decoder_weights

    lcfg = dataclasses.replace(Qwen2VLConfig.qwen2vl_7b().llm,
                               n_layers=STREAM_DEPTH)
    g = torch.Generator(device=dev).manual_seed(seed + 202)
    with torch.no_grad():
        params = init_decoder_params(lcfg, g, device=dev)
        embeds = [torch.randn((1, STREAM_TOKENS, lcfg.hidden), generator=g,
                              device=dev).to(lcfg.dtype)
                  for _ in range(STREAM_BATCHES)]
    specs = build_specs(QuantizeConfig(online_had_mode="full",
                                       llm_split=False))
    gcfg = GPTQConfig(act_order=True)

    def host(tree):
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        return None if tree is None else tree.cpu().pin_memory()

    def run(p, **kw):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = gptq_quantize_decoder(lcfg, p, embeds, specs, gcfg=gcfg,
                                        **kw)
        torch.cuda.synchronize()
        return (out, time.perf_counter() - t0,
                torch.cuda.max_memory_allocated())

    (res, rep), t_res, pk_res = run(params)
    host_params = {**params, "layers": host(params["layers"])}
    del params
    (st, _), t_st, pk_st = run(host_params, stream_from_host=True)
    for s in LLM_SITES:
        if not torch.equal(st["layers"][s]["w"], res["layers"][s]["w"].cpu()):
            raise AssertionError(f"stream check: streamed llm.{s} differs "
                                 "from the resident run")
    del st
    (rt, _), t_rt, pk_rt = run(host_params, stream_from_host=True,
                               realize_on_device=True)
    ref = realize_decoder_weights(res, specs, qps=rep["qparams"])
    for s in LLM_SITES:
        for k in ("w_q", "w_scale"):
            if not torch.equal(rt["layers"][s][k], ref["layers"][s][k]):
                raise AssertionError(f"stream check: realized llm.{s}.{k} "
                                     "differs from the post-hoc realization")
    if not (pk_st < pk_res and pk_rt < pk_res):
        raise AssertionError(f"stream check: device peaks resident {pk_res}, "
                             f"streamed {pk_st}, realized {pk_rt}")
    log(f"stream check: GPTQ at 7B widths, depth {STREAM_DEPTH}, "
        f"{STREAM_BATCHES} x {STREAM_TOKENS} tokens, act_order (the "
        f"embedding and head on the card in every run): resident "
        f"{t_res:.2f} s, device peak {pk_res / 2**30:.2f} GiB; "
        f"stream_from_host {t_st:.2f} s, peak {pk_st / 2**30:.2f} GiB, "
        f"weights bit-equal; + realize_on_device {t_rt:.2f} s, peak "
        f"{pk_rt / 2**30:.2f} GiB, codes and scales equal to the post-hoc "
        f"realization; card {card}")


GOLDEN_KERNELS = SLICE_KERNELS


def _golden_entry(card, dev, doc, cfg, e, trees, dg, t0, what=""):
    import torch

    from mquant_tpu_torch import golden as G

    t1 = time.perf_counter()
    with torch.no_grad():
        rep = G.run_port(cfg, doc, e, trees, dg, device=dev)
    torch.cuda.synchronize()
    cpu = doc["port_cpu"]["held"].get(f"{e['path']}/{e['depth']}", {})
    log(f"golden: {what}path {e['path']} depth {e['depth']}: digest equal; "
        f"held {rep['held']} of {rep['steps']} steps (parted at "
        f"{rep['parted_at']}; the CPU port held {cpu.get('held')}); "
        f"top-16 max |d| {rep['max_d']:.4g} against a tolerance of "
        f"{rep['max_tol']:.4g} at most; {time.perf_counter() - t1:.1f} s"
        f" (the host draw and digests before it "
        f"{t1 - t0:.1f} s); card {card}")
    del trees
    gc.collect()
    torch.cuda.empty_cache()


def run_golden(card: str, dev: str = "cuda") -> dict:
    """Phase 4, the golden (``mquant_tpu_torch/golden/*.json``, the JAX
    package's greedy decode on the CPU): its weights drawn on the host
    with numpy (``golden.entry_trees``: one draw at the deepest depth, each
    entry cut from it) and moved to the card. Qwen2-VL-7B's file: each path
    (block, F, S) at each depth of the file, and the storage paths (K8:
    block over int8 KV; A: grouped asymmetric W4 in act_order's layout with
    static asymmetric activations) at depth 1, serves the full-VLM request;
    then the files of InternVL2-8B, GLM-4V-9B, Qwen-VL-Chat and
    MiniCPM-V-2.6 (published widths, the LLM at depth 1, the float tower
    cut to 2 blocks and the projector, the block path's W4A8 decoder with
    the int8 head), each serving a 448² image request (their trees drawn
    two at a time on host threads, from the phase's start).
    Every entry goes through ``Generator.generate_on_device`` (the
    prefill, then the graph decode loop replayed a step at a time, each
    step's logits kept) and is held to its file by ``golden.hold``:
    digests equal, the top-16 logits within the file's tolerance, tokens
    equal up to a low-margin step where the runs may part. A mismatch
    raises. Counted as one path; returns the launch counts."""
    from concurrent.futures import ThreadPoolExecutor

    from mquant_tpu_torch import golden as G
    from mquant_tpu_torch.models.qwen2vl import Qwen2VLConfig
    from mquant_tpu_torch.models.registry import get_family

    doc = G.read()
    cfg = Qwen2VLConfig.qwen2vl_7b()
    log(f"golden: {len(doc['entries'])} entries ({doc['vit_cut']}, "
        f"{doc['prefill']}-token prompt with a {doc['image_side']}² image, "
        f"{doc['gen_tokens']} tokens, logit tolerance {doc['logit_rtol']} of "
        f"each step's largest top-{doc['top_k']} value); the CPU port held "
        f"at depths {doc['port_cpu']['agrees_depths']}")

    def family_draw(fam):
        fdoc = G.read(G.golden_file(fam))
        fcfg = get_family(fam).config_fn()
        return fdoc, fcfg, list(G.entry_trees(fcfg, fdoc))

    reset_launches()
    fams = G.OTHER_FAMILIES
    with ThreadPoolExecutor(2) as ex:
        # the first two families' draws run on the host beside Qwen2-VL's
        # draw and entries, each later one while the card serves the one
        # two before it
        ahead = [ex.submit(family_draw, f) for f in fams[:2]]
        t0 = time.perf_counter()
        for e, trees, dg in G.entry_trees(cfg, doc):
            _golden_entry(card, dev, doc, cfg, e, trees, dg, t0)
            t0 = time.perf_counter()
        for i in range(len(fams)):
            fdoc, fcfg, entries = ahead[i].result()
            ahead[i] = None
            if i + 2 < len(fams):
                ahead.append(ex.submit(family_draw, fams[i + 2]))
            for e, trees, dg in entries:
                _golden_entry(card, dev, fdoc, fcfg, e, trees, dg, t0,
                              f"{fcfg.name} ({fdoc['vit_cut']}, "
                              f"{fdoc['prefill']}-token prompt) ")
            del entries
            t0 = time.perf_counter()
    return read_launches("golden", GOLDEN_KERNELS)


FAMILY_BATCHES = 8  # calibration batches of a 448² image (1024 patches →
# 256 image tokens, GLM-4V's boi and eoi too, + 32 text): 1/16 of the
# reference's 128, to keep the script within its time; the phases' stage
# seconds are at this size
FAMILY_IMAGE = 448
FAMILY_KERNELS = SLICE_KERNELS
FAMILY_BURST = (77, 300, 513, 1000)  # the engine burst's id prompts
FAMILY_BURST_TOKENS = 16
IVL_DEPTH = 2  # InternVL2-8B's LLM layers: 32 (uncut) until the GLM-4V
# phase took its time, 8 until the MiniCPM-V phase did
GLM_DEPTH = 2  # GLM-4V-9B's ChatGLM layers: 40 (uncut) until the Qwen-VL
# phase took its time, 8 until the MiniCPM-V phase did
QVL_DEPTH = 2  # Qwen-VL-Chat's LLM layers in the whole script (32 uncut;
# 8 until the MiniCPM-V phase took its time)
MCPM_DEPTH = 4  # MiniCPM-V-2.6's Qwen2 layers in the whole script (28
# uncut; 8 until the long context phase came); each family phase's default
# depth is its uncut one (--phase)
# A6 on the card: a non-square image through a runner that pads every
# patch sequence to its largest bucket (image_size 448: the 448 × 896
# bucket's 2048 patches padded to 4096) against the same image unpadded
PAD_IMAGE = (300, 600)


def headline_w4a8(seed: int):
    """The reference's headline W4A8 flags (``exam/quant_vlm.py``'s
    docstring: rotations, full online Hadamard before ``down``, RMS split,
    GPTQ W4 with act_order, RTN W8 vision tower and projector, static
    per-tensor int8 activations, ``realize_int``) with an int8 lm_head, on
    FAMILY_BATCHES calibration batches."""
    from mquant_tpu_torch.pipeline import QuantizeConfig

    return QuantizeConfig(rotate=True, online_llm_hadamard=True,
                          online_had_mode="full", llm_split=True,
                          llm_w_bits=4, act_order=True, visual_w_bits=8,
                          llm_a_bits=8, visual_a_bits=8, lm_head_bits=8,
                          calib_num=FAMILY_BATCHES * 16,
                          nsamples=FAMILY_BATCHES, realize_int=True,
                          seed=seed)


def run_internvl_phase(card: str, seed: int, dev: str = "cuda",
                       gen_tokens: int = GEN_TOKENS, cfg=None,
                       depth: int = 32) -> list:
    """Phase 4, InternVL2-8B: the port's ``run_pipeline("InternVL2-8B")``
    at the published widths (LLM depth ``depth`` of 32, IVL_DEPTH in the
    whole script, and ViT depth 24)
    in :func:`headline_w4a8`'s configuration (the full
    online Hadamard hadK₂₈ ⊗ H₅₁₂; the head at N = 92553 on
    ``int8_gemv``'s word producer), served and checked by
    :func:`family_phase`; last, ``quant_vlm --model InternVL2-8B --tiny``
    on the card (:func:`family_cli`). Returns the launch counts of the
    request and of the burst. ``cfg`` replaces the published
    configuration (a CPU rehearsal at small widths)."""
    import tempfile

    import torch

    from mquant_tpu_torch.models.internvl import InternVLConfig

    if cfg is None:
        cfg = InternVLConfig.internvl2_8b()
        cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
            cfg.llm, n_layers=depth))
    gc.collect()
    torch.cuda.empty_cache()
    art = tempfile.mkdtemp(prefix="mquant_internvl_")
    try:
        with family_cli("InternVL2-8B", art, dev) as cli:
            counts = family_phase("internvl", "InternVL2-8B", card, seed, dev,
                                  gen_tokens, cfg, headline_w4a8(seed), art)
            family_cli_check(cli, "InternVL2-8B", card, visual_sites=15)
        return counts
    finally:
        shutil.rmtree(art)


def run_glm4v_phase(card: str, seed: int, dev: str = "cuda",
                    gen_tokens: int = GEN_TOKENS, cfg=None,
                    depth: int = 40) -> list:
    """Phase 4, GLM-4V-9B: the port's ``run_pipeline("GLM-4V-9B")`` at the
    published widths (the EVA2CLIP tower, 63 layers × 1792, neither fused
    nor rotated; the GLU projector; ChatGLM at ``depth`` of 40 (GLM_DEPTH
    in the whole script), MQA
    32 / 2 heads,
    half-width interleaved rotary, intermediate 13696 padded to 13824 =
    108 · 128 by the full online Hadamard, vocabulary 151552) in
    :func:`headline_w4a8`'s
    configuration (``down`` split at K = 13823; the head at N = 151552),
    served and checked by :func:`family_phase`, whose decode steps must
    run ``attn_decode`` at G = 16, a call a layer; last, ``quant_vlm
    --model GLM-4V-9B --tiny`` on the card. Returns the launch counts of
    the request and of the burst. ``cfg`` replaces the published
    configuration (a CPU rehearsal at small widths)."""
    import tempfile

    import torch

    from mquant_tpu_torch.models.glm4v import GLM4VConfig

    if cfg is None:
        cfg = GLM4VConfig.glm4v_9b()
        cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
            cfg.llm, n_layers=depth))
    gc.collect()
    torch.cuda.empty_cache()
    art = tempfile.mkdtemp(prefix="mquant_glm4v_")
    try:
        with family_cli("GLM-4V-9B", art, dev) as cli:
            counts = family_phase("glm4v", "GLM-4V-9B", card, seed, dev,
                                  gen_tokens, cfg, headline_w4a8(seed), art)
            family_cli_check(cli, "GLM-4V-9B", card, visual_sites=18)
        return counts
    finally:
        shutil.rmtree(art)


def run_qwenvl_phase(card: str, seed: int, dev: str = "cuda",
                     gen_tokens: int = GEN_TOKENS, cfg=None,
                     depth: int = 32) -> list:
    """Phase 4, Qwen-VL-Chat: the port's ``run_pipeline("Qwen-VL-Chat")``
    at the published widths (the CLIP-style tower, 48 layers × 1664 with
    ln_pre, ``fc_sub_mean`` and ln_post; the attn_pool resampler, 256
    queries over 1024 keys, width 4096; the Qwen decoder at ``depth`` of
    32 layers, 32 / 32 heads (G = 1), intermediate 11008 = 172 · 64, whose
    full online Hadamard is the seeded order-172 block ⊗ H₆₄, vocabulary
    151936, dynamic NTK over 2048) in :func:`headline_w4a8`'s
    configuration (``down`` split at K = 11007; the head at N = 151936),
    served and checked by :func:`family_phase`, whose decode steps must
    run ``attn_decode`` at G = 1, a call a layer; last, ``quant_vlm
    --model Qwen-VL-Chat --tiny`` on the card with visual GPTQ (the
    resampler's six sites included). Returns the launch counts of the
    request and of the burst. ``cfg`` replaces the published
    configuration (a CPU rehearsal at small widths)."""
    import tempfile

    import torch

    from mquant_tpu_torch.models.qwenvl import QwenVLConfig

    if cfg is None:
        cfg = QwenVLConfig.qwenvl_chat()
        cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
            cfg.llm, n_layers=depth))
    gc.collect()
    torch.cuda.empty_cache()
    art = tempfile.mkdtemp(prefix="mquant_qwenvl_")
    try:
        with family_cli("Qwen-VL-Chat", art, dev) as cli:
            counts = family_phase("qwenvl", "Qwen-VL-Chat", card, seed, dev,
                                  gen_tokens, cfg, headline_w4a8(seed), art)
            family_cli_check(cli, "Qwen-VL-Chat", card, visual_sites=19)
        return counts
    finally:
        shutil.rmtree(art)


def run_minicpmv_phase(card: str, seed: int, dev: str = "cuda",
                       gen_tokens: int = GEN_TOKENS, cfg=None,
                       depth: int = 28) -> list:
    """Phase 4, MiniCPM-V-2.6: the port's ``run_pipeline("MiniCPM-V-2_6")``
    at the published widths (the SigLIP tower, 27 layers × 1152, 16 heads
    of 72, mlp 4304, the tanh GELU, 4900 learned positions and
    post_layernorm; the resampler, 64 queries over the tower's 1024 rows,
    width 3584 from kv 1152, 28 heads; the Qwen2 decoder at ``depth`` of
    28 layers (MCPM_DEPTH in the whole script), 28 / 4 heads (G = 7),
    intermediate 18944, vocabulary 151666) in :func:`headline_w4a8`'s
    configuration (``down`` split at K = 18943; the head at N = 151666 on
    ``int8_gemv``'s word producer), served and checked by
    :func:`family_phase`, whose decode steps must run ``attn_decode`` at
    G = 7, a call a layer; then the padded request of
    :func:`run_pad_check` on the same artifact; last, ``quant_vlm --model
    MiniCPM-V-2_6 --tiny`` on the card with visual GPTQ (the resampler's
    six sites included). Returns the launch counts of the request, of the
    burst and of the padded requests. ``cfg`` replaces the published
    configuration (a CPU rehearsal at small widths)."""
    import tempfile

    import torch

    from mquant_tpu_torch.models.minicpmv import MiniCPMVConfig

    if cfg is None:
        cfg = MiniCPMVConfig.minicpmv_2_6()
        cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
            cfg.llm, n_layers=depth))
    gc.collect()
    torch.cuda.empty_cache()
    art = tempfile.mkdtemp(prefix="mquant_minicpmv_")
    try:
        with family_cli("MiniCPM-V-2_6", art, dev) as cli:
            counts = family_phase("minicpmv", "MiniCPM-V-2_6", card, seed, dev,
                                  gen_tokens, cfg, headline_w4a8(seed), art)
            counts.append(run_pad_check("minicpmv", art, card, seed, dev))
            family_cli_check(cli, "MiniCPM-V-2_6", card, visual_sites=19)
        return counts
    finally:
        shutil.rmtree(art)


def run_pad_check(tag: str, art: str, card: str, seed: int,
                  dev: str = "cuda", image_size: int = FAMILY_IMAGE) -> dict:
    """A6 on the card: one PAD_IMAGE request (a non-square image) served
    from the artifact ``art`` by two runners, the second with
    ``pad_to_max`` (its patch sequence zero-padded to the largest bucket's
    patch count, the validity mask through the tower's and the resampler's
    attention: the einsum route). Held:

    - the mask, exactly: the padded request's image features and greedy
      tokens at full depth are bit-equal to those of the same request
      whose padded patches hold noise instead of zeros (the same shapes,
      so the same kernels and reduction orders: what the padding holds
      may not reach the valid rows);
    - against the unpadded request, where the two differ by rounding
      (other reduction lengths, the masked key columns): the vision path
      in float (no activation quantizer) with the tower cut to CMP_LAYERS
      blocks gives image features within LOGIT_RTOL.

    Compared, not held: the decoder cut to CMP_LAYERS layers on those
    features (prefill logits, N_CMP greedy tokens), the served (quantized)
    and float features through the whole tower, and the full-depth
    tokens, with the two vision passes' times. The random weights' static
    int8 activation codes turn a one-ulp difference of the inputs into
    flipped codes, which grow through the layers (C-w6): one decoder
    layer already moves the logits beyond LOGIT_RTOL. Returns the launch
    counts of the requests."""
    import numpy as np
    import torch

    from mquant_tpu_torch.evaluation.adapter import (_embed_with_quant,
                                                     _image_features)
    from mquant_tpu_torch.serve.server import build_runner_from_artifact

    rng = np.random.default_rng(seed + 31)
    img = rng.integers(0, 256, (*PAD_IMAGE, 3), dtype=np.uint8)
    prompt = {"text": "describe the picture", "image": img}
    got = {}
    reset_launches()
    for pad in (False, True):
        runner = build_runner_from_artifact(
            art, device=dev, image_size=image_size, tokenizer=id_tokenizer(),
            max_len=PREFILL, pad_to_max=pad)
        cfg, params, fam = runner.cfg, runner.params, runner.fam
        sp, st = runner.specs, runner.state
        # the tower cut to CMP_LAYERS blocks (views of the same tensors)
        cut_cfg = dataclasses.replace(cfg, vit=dataclasses.replace(
            cfg.vit, n_layers=CMP_LAYERS))
        cut_params = {**params, "vit": {**params["vit"], "blocks": {
            k: {n: None if t is None else t[:CMP_LAYERS]
                for n, t in v.items()}
            for k, v in params["vit"]["blocks"].items()}}}
        r = {}
        with torch.no_grad():
            toks, enc = runner.build_inputs(prompt)
            patches, extra, n_img = enc[0]
            mask = extra.get("vis_token_mask")

            def feats(p, mode=runner.mode, c=cfg, pr=params):
                return _image_features(fam, c, pr, p, extra, sp, st, mode,
                                       n_img=n_img)

            feats(patches)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r["feats"] = feats(patches)
            torch.cuda.synchronize()
            r["t_vis"] = time.perf_counter() - t0
            r["fp"] = feats(patches, "fp")
            r["cut_fp"] = feats(patches, "fp", cut_cfg, cut_params)
            emb = _embed_with_quant(fam, cut_cfg, cut_params,
                                    {"tokens": toks, "images": enc}, sp, st,
                                    "fp")
            cut = depth_cut(runner.gen, CMP_LAYERS)
            r["logits"] = cut.prefill(emb)[0]
            r["cut"] = cut.generate_on_device(emb, N_CMP)[0].tolist()
            emb, _ = runner._embeds(toks, enc)
            r["full"] = runner.gen.generate_on_device(emb, N_CMP)[0].tolist()
            if pad:  # noise where the zero padding was
                n = int(mask.sum())
                g = torch.Generator(device=dev).manual_seed(seed + 37)
                noisy = patches.clone()
                noisy[:, n:] = torch.randn(noisy[:, n:].shape, generator=g,
                                           device=dev).to(noisy.dtype)
                r["noisy"] = feats(noisy)
                enc2 = [(noisy, extra, n_img)]
                emb2, _ = runner._embeds(toks, enc2)
                r["noisy_full"] = runner.gen.generate_on_device(
                    emb2, N_CMP)[0].tolist()
        got[pad] = dict(r, T=patches.shape[1], prompt=toks.shape[1],
                        valid=None if mask is None else int(mask.sum()))
        del runner, cut, emb, params, cut_params
        gc.collect()
        torch.cuda.empty_cache()
    launches = read_launches(f"{tag} padded", ("int8_gemv", "attn_decode"))
    a, b = got[False], got[True]
    if a["valid"] is not None or b["valid"] != a["T"] or b["T"] <= a["T"]:
        raise AssertionError(f"{tag} padded: {a['T']} patches unpadded, "
                             f"{b['T']} padded with {b['valid']} valid")
    if a["prompt"] != b["prompt"]:
        raise AssertionError(f"{tag} padded: prompts of {a['prompt']} and "
                             f"{b['prompt']} tokens")
    if not torch.equal(b["noisy"], b["feats"]) or b["noisy_full"] != b[
            "full"]:
        raise AssertionError(f"{tag} padded: the padding's content reached "
                             "the valid rows (features or tokens differ)")
    check_close(f"{tag} padded, float vision, tower depth {CMP_LAYERS}: "
                f"image features ({b['T']} patches, {b['valid']} valid) vs "
                f"unpadded ({a['T']})", b["cut_fp"], a["cut_fp"])

    def rel(k):
        x, y = b[k].float(), a[k].float()
        if x.shape != y.shape or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{tag} padded: {k} "
                                 f"{tuple(x.shape)} vs {tuple(y.shape)} or "
                                 "non-finite")
        err, mag = float((x - y).abs().max()), float(y.abs().max())
        return (f"max |d| {err:.3g} (max |ref| {mag:.3g}, "
                f"{err / mag:.3g} of it)")

    def same(k):
        return next((i for i, (x, y) in enumerate(zip(a[k], b[k]))
                     if x != y), len(a[k]))

    log(f"{tag} padded: a {PAD_IMAGE[0]} x {PAD_IMAGE[1]} image ({a['T']} "
        f"patches) padded to {b['T']} with the mask: its features and "
        f"{N_CMP} full-depth tokens bit-equal with noise in the padding; "
        f"against the unpadded request, float vision through {CMP_LAYERS} "
        f"block(s) within the bound; compared: the decoder through "
        f"{CMP_LAYERS} layer(s) on them, prefill logits {rel('logits')}, "
        f"the first {same('cut')} of {N_CMP} tokens equal; through the whole "
        f"tower, served features {rel('feats')}, float {rel('fp')}; at the "
        f"model's full depth the first {same('full')} of {N_CMP} tokens "
        f"equal; the served vision pass {b['t_vis'] * 1e3:.1f} ms padded vs "
        f"{a['t_vis'] * 1e3:.1f} ms; card {card}")
    return launches


def _leaves_of(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves_of(v)
    elif tree is not None:
        yield tree


def _draw_on_card(tag, model, cfg, seed, dev, card) -> dict:
    """The family's seeded random bf16 params drawn on the card. Call it
    in ``run_pipeline``'s argument list: the pipeline then holds the only
    reference, and fuse + rotate frees the drawn tree."""
    import torch

    from mquant_tpu_torch.models.registry import get_family

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed + 29)
    params = get_family(model).init_fn(cfg, gen, device=dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves_of(params))
    log(f"{tag}: seeded random weights drawn on the card: {n} values "
        f"({n * 2 / 1e9:.2f} GB in bf16) in {time.perf_counter() - t0:.2f} "
        f"s; card {card}")
    return params


def family_phase(tag, model, card, seed, dev, gen_tokens, cfg, q, art):
    """A model family quantized at ``cfg``'s widths by ``run_pipeline`` on
    seeded random bf16 weights drawn on the card (:func:`_draw_on_card`),
    into the temporary artifact ``art``: stage seconds and peaks, no RTN
    fallback, GPTQ's proxy loss no worse than
    round-to-nearest's, lossless realization. The artifact served by
    ``build_runner_from_artifact``: one request (a 448² image in a
    PREFILL-token prompt, ``gen_tokens`` greedy tokens), counted (``down``
    at K = inter_eff − 1 on the TMA ``int8_gemm``, a call a layer;
    ``int8_gemv`` for ``down`` and the head, and ``attn_decode``, a call a
    layer, every decode step; the launches a decode step printed), held
    against the plain integer products (logits max |d| 0, tokens equal),
    its graph decode loop against the eager loop; then a ServingEngine
    burst (:func:`family_burst`). Returns the launch counts of the request
    and of the burst."""
    import torch

    from mquant_tpu_torch.pipeline import run_pipeline
    from mquant_tpu_torch.serve.server import build_runner_from_artifact

    calib = (f"{FAMILY_BATCHES} calibration batches of a {FAMILY_IMAGE}² "
             "image, 1/16 of the reference's 128")
    depth = cfg.llm.n_layers
    proxies, realized = [], []
    with torch.no_grad(), gptq_proxies(proxies), realize_lossless(realized):
        cfg, params, _, specs, info = run_pipeline(
            model, q, cfg=cfg,
            params=_draw_on_card(tag, model, cfg, seed, dev, card),
            artifact_dir=art, image_size=FAMILY_IMAGE, device=dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if specs["llm.down"].online_had != "full" or not specs["llm.down"].split:
        raise AssertionError(f"{tag}: llm.down {specs['llm.down']}")
    pad = info["llm"].down_pad
    if pad != cfg.llm.intermediate_pad or cfg.llm.inter_eff != (
            pad or cfg.llm.intermediate):
        raise AssertionError(f"{tag}: down_pad {pad}, config {cfg.llm}")
    for name, st in info["stages"].items():
        peak = ("not measured" if st["peak_bytes"] is None
                else f"{st['peak_bytes'] / 2**30:.2f} GiB")
        log(f"{tag}: stage {name}: {st['seconds']:.2f} s, peak {peak} "
            f"({calib}); card {card}")
    rep = info["gptq"]
    sec = rep["seconds"]
    log(f"{tag}: GPTQ {rep['sites']} sites at depth {depth}: stage "
        f"replays + Hessians {sec['hessian']:.2f} s, factorizations "
        f"{sec['factor']:.2f} s, walks {sec['walk']:.2f} s ({calib}); RTN "
        f"fallbacks {len(rep['fallbacks'])}; full online Hadamard over "
        f"{cfg.llm.intermediate} (padded to {cfg.llm.inter_eff}); artifact "
        f"{info['artifact_bytes']} bytes "
        f"({info['artifact_bytes'] / 2**30:.2f} GiB); card {card}")
    if rep["fallbacks"] or any(fb for *_, fb in proxies[1:]):
        raise AssertionError(f"{tag}: RTN fallbacks {rep['fallbacks']}")
    if rep["sites"] != 7 * depth or len(proxies) - 1 != rep["sites"]:
        raise AssertionError(f"{tag}: {rep['sites']} GPTQ sites, "
                             f"{len(proxies) - 1} proxies, depth {depth}")
    worse = [(i, p) for i, p in enumerate(proxies[1:]) if p[1] > p[2]]
    if worse:
        raise AssertionError(f"{tag}: GPTQ worse than RTN at {worse}")
    if sum(n for _, n in realized) != rep["sites"]:
        raise AssertionError(f"{tag}: realized {realized}, GPTQ sites "
                             f"{rep['sites']}")
    sums = {}
    for site, pg, pr, _ in proxies[1:]:
        g, r = sums.get(site, (0.0, 0.0))
        sums[site] = (g + pg, r + pr)
    log(f"{tag}: GPTQ proxy loss tr(dW^T H dW) summed over layers, GPTQ "
        "vs round-to-nearest: " + ", ".join(
            f"{s} {g:.4g} vs {r:.4g} ({g / r:.3f})"
            for s, (g, r) in sums.items()) + f"; realization lossless on "
        f"{rep['sites']} sites")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner = build_runner_from_artifact(
        art, device=dev, image_size=ART_IMAGE_SIZE,
        tokenizer=id_tokenizer(), max_len=PREFILL + gen_tokens)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    if runner.fam.name != tag or runner.mode != "real":
        raise AssertionError(f"{tag}: runner {runner.fam.name}, "
                             f"{runner.mode}")
    gen = runner.gen
    K = cfg.llm.inter_eff - 1
    single, _ = artifact_prompts(runner, seed)
    n_prompt = runner.build_inputs(single)[0].shape[1]
    steps = gen_tokens - 1
    with torch.no_grad():
        runner.generate(single, max_new_tokens=4)  # warm-up; not counted
        torch.cuda.synchronize()
        reset_launches()
        depths = []
        with gemm_depths(depths):
            out, t_req, ttft = timed(lambda mark: runner.generate(
                single, max_new_tokens=gen_tokens, on_first_token=mark))
        launches = read_launches(tag, FAMILY_KERNELS)
        check_tokens(tag, [out], gen_tokens, cfg.llm.vocab)
        # the prefill's `down` on the TMA GEMM, a call a layer
        down = sum(1 for n, d, moved in depths
                   if n == "int8_gemm" and d == K and moved == (n,))
        if down != depth or launches["int8_gemm_ragged"]:
            raise AssertionError(f"{tag}: {down} int8_gemm calls at K = "
                                 f"{K}, expected {depth}; int8_gemm_ragged "
                                 f"{launches['int8_gemm_ragged']}")
        # a decode step: `down` a layer and the head on the int8 GEMV (and
        # the head of the prefill's last row), attention a layer on
        # attn_decode (none on the einsum)
        want = {"int8_gemv": (depth + 1) * steps + 1,
                "attn_decode": depth * steps}
        for k, n in want.items():
            if launches[k] != n:
                raise AssertionError(f"{tag}: {k} launched {launches[k]} "
                                     f"times, expected {n}")
        per_step = {k: launches[k] / steps for k in ("w4a8_gemv",
                                                     "int8_gemv",
                                                     "attn_decode")}
        G = cfg.llm.n_heads // cfg.llm.n_kv_heads
        log(f"{tag}: the artifact's request ({n_prompt}-token prompt "
            f"with a 448² image, {gen_tokens} tokens) {t_req:.3f} s; TTFT "
            f"{ttft * 1e3:.1f} ms; decode {steps / (t_req - ttft):.1f} "
            f"tok/s; build_runner_from_artifact {t_load:.1f} s; launches "
            + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
            + f" ({down} int8_gemm at K = {K}); a decode step: "
            + ", ".join(f"{k} {v:g}" for k, v in per_step.items())
            + f" (int8_gemv: `down` at K = {K} and the head at N = "
            f"{cfg.llm.vocab}; attn_decode at G = {G}); card {card}")
        (emb,), (pos,) = runner_inputs(runner, [single])
        if pos is not None:
            raise AssertionError(f"{tag}: M-RoPE positions on a 1-D RoPE "
                                 "family")
        against_plain(tag, gen, lambda: gen.prefill(emb[None]), exact=True)
        gen.ensure_capacity(n_prompt + GEN_TOKENS)
        g = torch.Generator(device=dev).manual_seed(seed + 19)
        step_ms = graph_decode(tag, gen, emb[None], {"g": g, "dev": dev},
                               card)
        burst = family_burst(tag, runner, card, seed)
    log(f"{tag}: graph step {step_ms:.3f} ms; card {card}")
    del gen, runner
    gc.collect()
    torch.cuda.empty_cache()
    return [launches, burst]


class Child:
    """A command started now and collected later (:meth:`result`), beside
    the parent's own work; its output goes to files under ``root``. Leaving
    the ``with`` block stops it if it still runs. Every line :func:`log`
    prints inside the block says that the card was shared: a time taken
    there is not one of the card alone."""

    def __init__(self, cmd: list, root: str, name: str):
        self.cmd = cmd
        self.files = [open(os.path.join(root, f"{name}.{k}"), "w+")
                      for k in ("out", "err")]
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(cmd, stdout=self.files[0],
                                     stderr=self.files[1], text=True)

    def result(self, timeout: float = 600):
        """(returncode, stdout, stderr, seconds since the start)."""
        rc = self.proc.wait(timeout)
        dt = time.perf_counter() - self.t0
        out = []
        for f in self.files:
            f.seek(0)
            out.append(f.read())
        return rc, out[0], out[1], dt

    def __enter__(self):
        _BESIDE.append(self)
        return self

    def __exit__(self, *exc):
        _BESIDE.remove(self)
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        for f in self.files:
            f.close()


def family_cli(model: str, root: str, dev: str) -> Child:
    """``python -m mquant_tpu_torch.quant_vlm --model MODEL --tiny`` on
    ``dev`` with the headline flags and visual GPTQ (patch embed, ViT,
    projector), an artifact under ``root``, started beside the family's
    phase (:func:`family_cli_check` collects it)."""
    out = os.path.join(root, "tiny_cli")
    cmd = [sys.executable, "-m", "mquant_tpu_torch.quant_vlm", "--model",
           model, "--tiny", "--device", dev, "--rotate",
           "--online_llm_hadamard", "--llm_split", "--act_order",
           "--visual_w_gptq", "--calib_num", "32", "--nsamples", "8",
           "--realize_int", "--artifact", out]
    return Child(cmd, root, "tiny_cli")


def family_cli_check(cli: Child, model: str, card: str,
                     visual_sites: int) -> None:
    """:func:`family_cli`'s run: exit 0, no RTN fallback, 14 +
    ``visual_sites`` GPTQ sites."""
    cmd = cli.cmd
    rc, stdout, stderr, dt = cli.result()
    if rc != 0:
        raise AssertionError(f"quant_vlm --model {model}: exit {rc}: "
                             f"{stderr[-3000:]}")
    summary = json.loads(stdout.strip().splitlines()[-1])
    if (summary["gptq_fallbacks"] or summary["visual_gptq_fallbacks"]
            or summary["gptq_sites"] != 14
            or summary["visual_gptq_sites"] != visual_sites):
        raise AssertionError(f"quant_vlm --model {model}: {summary}")
    log(f"quant_vlm CLI on {summary['device']}: --model {model} --tiny "
        f"{' '.join(cmd[8:-2])}: exit 0 in {dt:.1f} s (the process's start "
        f"included; beside the family's phase), GPTQ "
        f"{summary['gptq_sites']} + visual "
        f"{summary['visual_gptq_sites']} sites, no RTN fallback; card {card}")


def family_burst(tag: str, runner, card: str, seed: int) -> dict:
    """The ServingEngine over the runner's decoder: the FAMILY_BURST id
    prompts at once (FAMILY_BURST_TOKENS greedy tokens each), counted,
    then each prompt alone on the same engine; tokens equal. Returns the
    burst's launch counts."""
    import numpy as np
    import torch

    from mquant_tpu_torch.serve.generate import bucket_len

    rng = np.random.default_rng(seed + 23)
    vocab = runner.cfg.llm.vocab
    prompts = [rng.integers(1, vocab, n) for n in FAMILY_BURST]
    eng = runner.new_engine(len(prompts), bucket_len(
        bucket_len(max(FAMILY_BURST), 16) + FAMILY_BURST_TOKENS))
    # warm: the admissions' and the block's graphs are made outside the
    # counted burst
    eng.warmup(prompt_lens=FAMILY_BURST)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=FAMILY_BURST_TOKENS)
            for p in prompts]
    outs = eng.run()
    torch.cuda.synchronize()
    t_burst = time.perf_counter() - t0
    launches = read_launches(f"{tag} engine", FAMILY_KERNELS)
    toks = [list(outs[r]) for r in rids]
    for r in rids:
        eng.release(r)
    for i, (p, t) in enumerate(zip(prompts, toks)):
        check_tokens(f"{tag} engine request {i}", [t], FAMILY_BURST_TOKENS,
                     vocab)
        rid = eng.submit(p, max_new_tokens=FAMILY_BURST_TOKENS)
        alone = list(eng.run()[rid])
        eng.release(rid)
        if alone != t:
            d = next(j for j, (a, b) in enumerate(zip(alone, t)) if a != b)
            raise AssertionError(f"{tag} engine: request {i} "
                                 f"({len(p)} ids) differs from itself alone "
                                 f"at token {d}")
    n_tok = len(prompts) * FAMILY_BURST_TOKENS
    log(f"{tag} engine: {len(prompts)} id prompts of {FAMILY_BURST} ids, "
        f"{FAMILY_BURST_TOKENS} greedy tokens each, in {t_burst:.3f} s "
        f"({n_tok / t_burst:.1f} tok/s, admissions included); each equal to "
        f"itself sent alone; launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
        + f"; card {card}")
    return launches


EVAL_TOKENS = 16  # new tokens per eval row
EVAL_SLOTS = 8  # the engine's pool
EVAL_CALIB_DEPTH = 2  # the dataset-calibrated pipeline's LLM layers (4
# until the MiniCPM-V phase took its time)
EVAL_KERNELS = SLICE_KERNELS


def eval_tsvs(root: str, seed: int) -> dict:
    """The phase's TSVs in VLMEvalKit's layout, images as base64 PNG
    (``utils.png``) at 448² and 224×448: MMBench-named MCQ (4 rows × 4
    options, circular), MME yes/no (8 rows: 4 images × 2 questions, two
    categories), DocVQA-named ANLS (4 rows, answers as stringified
    lists)."""
    import base64

    import numpy as np

    from mquant_tpu_torch.utils.png import encode_png

    rng = np.random.default_rng(seed + 7)

    def png(h, w):
        return base64.b64encode(encode_png(
            rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
            int(rng.integers(0, 5)))).decode()

    def write(name, header, rows):
        path = os.path.join(root, name)
        with open(path, "w") as f:
            f.write("\t".join(header) + "\n")
            for r in rows:
                f.write("\t".join(str(r[h]) for h in header) + "\n")
        return path

    sides = [(448, 448), (224, 448)]
    mcq = write("MMBench_DEV_EN.tsv",
                ["index", "question", "answer", "A", "B", "C", "D", "image"],
                [dict(index=i, question=f"Which object is shown ({i})?",
                      answer="ABCD"[i], A="a car", B="an apple", C="a shoe",
                      D="a hat", image=png(*sides[i % 2])) for i in range(4)])
    mme_imgs = [png(448, 448) for _ in range(4)]
    mme = write("MME.tsv",
                ["index", "question", "answer", "category", "image_id",
                 "image"],
                [dict(index=i, question=f"Is there a {w} in the image?",
                      answer=("Yes", "No")[i % 2],
                      category=("color", "count")[i // 4], image_id=i // 2,
                      image=mme_imgs[i // 2])
                 for i, w in enumerate("cat dog car sun red two hat box"
                                       .split())])
    doc = write("DocVQA_VAL.tsv", ["index", "question", "answer", "image"],
                [dict(index=i, question=f"What is the total on page {i}?",
                      answer=str([f"{10 * i + 3}", f"{10 * i + 3}.00"]),
                      image=png(224, 448)) for i in range(4)])
    return {"mcq": mcq, "mme": mme, "doc": doc}


def id_text_tokenizer():
    """A ByteTokenizer without eos whose ``decode`` writes the token ids as
    text: every row runs its EVAL_TOKENS tokens, and two predictions are
    equal exactly when their tokens are."""
    from mquant_tpu_torch.evaluation.adapter import ByteTokenizer

    class IdText(ByteTokenizer):
        eos_id = -1

        def decode(self, ids):
            return " ".join(str(int(i)) for i in ids)

    return IdText()


def check_metrics(what: str, metrics: dict, scorer: str) -> None:
    """Finite and in range: [0, 100], MME's per-category acc + acc+ in
    [0, 200] and its sums up to 200 per category."""
    n_cat = max(1, sum(1 for k in metrics
                       if k not in ("total", "perception", "reasoning")))
    top = {"MME": 200.0 * n_cat}.get(scorer, 100.0)
    bad = {k: v for k, v in metrics.items()
           if not (math.isfinite(v) and 0.0 <= v <= top)}
    if bad or not metrics:
        raise AssertionError(f"{what}: metrics out of range {bad or metrics}")


def run_eval_phase(runner, card: str, seed: int, info: dict,
                   dev: str = "cuda") -> dict:
    """Phase 4, the evaluation harness at 7B widths on the pipeline's own
    artifact (``runner``): ``evaluation.eval.eval_dataset`` over the
    MMBench, MME and DocVQA TSVs of :func:`eval_tsvs` and ``SyntheticVQA``,
    EVAL_TOKENS new tokens a row, through ``runner.generate`` and through
    ``runner.engine_server(slots=EVAL_SLOTS)``, counted. Checks: every
    metric finite and in range, ``merge_results`` over shards (0, 2) and
    (1, 2) equal to the unsharded metrics, each batched prediction equal to
    its row served alone through the same engine, batched metrics equal to
    the single ones; ``runner_judge`` on the same runner consulted on the
    MCQ rows exact matching cannot parse (its calls printed). Then
    ``run_pipeline(calib_dataset=<the MCQ TSV>)`` at 7B widths cut to
    EVAL_CALIB_DEPTH layers through calibration and GPTQ (no RTN
    fallback), its stage seconds beside the synthetic calibration's
    (``info``). The predictions of random weights are noise: no accuracy
    is claimed. Returns the launch counts of the evaluation."""
    import tempfile

    import torch

    from mquant_tpu_torch.evaluation.eval import (build_dataset, eval_dataset,
                                                  merge_results)
    from mquant_tpu_torch.evaluation.judge import runner_judge
    from mquant_tpu_torch.evaluation.scoring import extract_option

    root = tempfile.mkdtemp(prefix="mquant_eval_")
    tok = runner.tok
    runner.tok = id_text_tokenizer()
    try:
        tsvs = eval_tsvs(root, seed)
        out = os.path.join(root, "out")

        def single(p):
            return runner.generate(p, max_new_tokens=EVAL_TOKENS)

        batch_fn = runner.engine_server(slots=EVAL_SLOTS,
                                        max_new_tokens=EVAL_TOKENS)
        with torch.no_grad():
            single(build_dataset("SyntheticVQA").build_prompt(0))  # warm-up
            batch_fn([build_dataset("SyntheticVQA").build_prompt(0)])
        torch.cuda.synchronize()
        reset_launches()
        timing, results = [], {}
        for name in (tsvs["mcq"], tsvs["mme"], tsvs["doc"], "SyntheticVQA"):
            ds = build_dataset(name)
            with torch.no_grad():
                one = eval_dataset(single, ds, out_dir=out, model_name="one")
                torch.cuda.synchronize()
                many = eval_dataset(single, ds, out_dir=out,
                                    model_name="many", batch_fn=batch_fn,
                                    batch_size=EVAL_SLOTS)
                torch.cuda.synchronize()
            results[ds.name] = (ds, one, many)
            timing.append((ds.name, one["n"], one["seconds"],
                           many["seconds"]))
        launches = read_launches("eval", EVAL_KERNELS)

        calls = []
        judge = runner_judge(runner)

        def counted(pred, options, question=""):
            calls.append(pred)
            return judge(pred, options, question)

        for name, (ds, one, many) in results.items():
            check_metrics(f"eval {name}", one["metrics"], ds.scorer)
            rows_one = _csv_predictions(one["results_file"])
            rows_many = _csv_predictions(many["results_file"])
            with torch.no_grad():
                alone = [batch_fn([ds.build_prompt(i)])[0]
                         for i in range(len(ds))]
            if rows_many != alone:
                bad = [i for i, (a, b) in enumerate(zip(rows_many, alone))
                       if a != b]
                raise AssertionError(f"eval {name}: batched rows {bad} differ "
                                     "from the rows served alone")
            if many["metrics"] != one["metrics"]:
                log(f"eval {name}: batched metrics {many['metrics']} beside "
                    f"single {one['metrics']} (predictions "
                    f"{sum(a == b for a, b in zip(rows_one, rows_many))} of "
                    f"{len(rows_one)} equal: the engine's pool rounds other "
                    "than the single decode, ROADMAP C-w6)")
            with torch.no_grad():
                files = [eval_dataset(single, ds, out_dir=out,
                                      model_name=f"shard{i}",
                                      shard=(i, 2))["results_file"]
                         for i in range(2)]
            merged = merge_results(ds, files)
            shard_preds = sorted(sum((_csv_predictions(f) for f in files),
                                     []))
            if shard_preds != sorted(rows_one) or merged != one["metrics"]:
                raise AssertionError(f"eval {name}: shards merged to {merged}"
                                     f", unsharded {one['metrics']}")
            if ds.scorer == "MCQ":
                n_calls = len(calls)
                judged = ds.evaluate(
                    [{**ds.build_prompt(i), "prediction": p}
                     for i, p in enumerate(rows_one)], extract_fn=counted)
                check_metrics(f"eval {name} judged", judged, ds.scorer)
                unparsed = sum(extract_option(p, ds.build_prompt(i)["options"])
                               is None for i, p in enumerate(rows_one))
                if len(calls) - n_calls != unparsed:
                    raise AssertionError(f"eval {name}: the judge saw "
                                         f"{len(calls) - n_calls} rows, exact "
                                         f"matching missed {unparsed}")
                log(f"eval {name}: runner_judge consulted on the {unparsed} "
                    f"of {len(rows_one)} rows exact matching cannot parse "
                    f"({len(calls)} calls); metrics {judged}")
            log(f"eval {name}: {one['n']} rows, metrics {one['metrics']}; "
                "shards (0, 2) + (1, 2) merged equal; each batched row equal "
                "to the row alone through the engine")
        for name, n, t1, tb in timing:
            log(f"eval {name}: single {n / t1:.2f} rows/s "
                f"({n * EVAL_TOKENS / t1:.1f} generated tok/s), batched "
                f"through {EVAL_SLOTS} slots {n / tb:.2f} rows/s "
                f"({n * EVAL_TOKENS / tb:.1f} tok/s); card {card}")
        log("eval: random weights, so every prediction is noise: no "
            "accuracy is claimed")
        del batch_fn
        gc.collect()
        torch.cuda.empty_cache()
        run_dataset_calibration(tsvs["mcq"], card, seed, info, dev)
    finally:
        runner.tok = tok
        shutil.rmtree(root)
    return launches


def _csv_predictions(path: str) -> list:
    import csv

    with open(path, newline="") as f:
        return [r["prediction"] for r in csv.DictReader(f)]


def run_dataset_calibration(tsv: str, card: str, seed: int, info: dict,
                            dev: str = "cuda") -> None:
    """``run_pipeline(calib_dataset=tsv)``: the headline W4A8 flags at 7B
    widths cut to EVAL_CALIB_DEPTH layers, calibrated on the TSV's rows
    (the serving input construction: two image buckets and other token
    counts per batch), through GPTQ and the static calibration without an
    artifact. No RTN fallback; its stage seconds printed beside those of
    the pipeline phase's synthetic calibration (``info``)."""
    import torch

    from mquant_tpu_torch.models.qwen2vl import Qwen2VLConfig
    from mquant_tpu_torch.pipeline import QuantizeConfig, run_pipeline

    base = Qwen2VLConfig.qwen2vl_7b()
    cfg = dataclasses.replace(base, llm=dataclasses.replace(
        base.llm, n_layers=EVAL_CALIB_DEPTH))
    q = QuantizeConfig(rotate=True, online_llm_hadamard=True,
                       online_had_mode="full", llm_split=True, llm_w_bits=4,
                       act_order=True, visual_w_bits=8, llm_a_bits=8,
                       visual_a_bits=8, calib_num=16, nsamples=16,
                       seed=seed)
    with torch.no_grad():
        _, params, _, _, inf = run_pipeline("Qwen2-VL-7B", q, cfg=cfg,
                                            calib_dataset=tsv, device=dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    rep = inf["gptq"]
    if rep["fallbacks"] or rep["sites"] != 7 * EVAL_CALIB_DEPTH:
        raise AssertionError(f"dataset calibration: GPTQ sites {rep['sites']}"
                             f", RTN fallbacks {rep['fallbacks']}")
    log(f"dataset calibration: run_pipeline(calib_dataset=MMBench TSV, 16 "
        f"rows) at 7B widths cut to {EVAL_CALIB_DEPTH} of 28 layers: "
        f"{rep['sites']} GPTQ sites, no RTN fallback; stage seconds " +
        ", ".join(f"{k} {v['seconds']:.2f}" for k, v in inf["stages"].items())
        + "; beside the synthetic calibration of the pipeline phase: " +
        ", ".join(f"{k} {v['seconds']:.2f}"
                  for k, v in info["stages"].items()) + f"; card {card}")


PROFILE_STEPS = 16  # decode steps per profiled run
TOP_ITEMS = 6  # device items printed per phase


def decode_steps(gen, cache0):
    """PROFILE_STEPS greedy decode steps from a prefilled batch-1 cache (the
    same rows are rewritten on every call)."""
    import torch

    tok0 = torch.zeros((1, 1), dtype=torch.int32, device=cache0["k"].device)

    def decode():
        tok, cache = tok0, cache0
        for _ in range(PROFILE_STEPS):
            logits, cache = gen._forward(tok, cache)
            tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]

    return decode


@contextlib.contextmanager
def attention_events(store: list):
    """Records a CUDA event pair around every ``layers.attention`` call (the
    einsum or the flash route, with its mask, softmax and casts) into
    ``store``."""
    import torch

    from mquant_tpu_torch.models import layers as L

    attention = L.attention

    def timed(*a, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = attention(*a, **kw)
        ev[1].record()
        store.append(ev)
        return out

    L.attention = timed
    try:
        yield
    finally:
        L.attention = attention


# device kernels of the decode GEMVs and attention, by the profiler's names
# (the tensor-core GEMV's unpack argument: 4 the W4 one, 5 the int8 one)
STEP_DEVICE_OPS = {"w4a8_gemv": r"gemv_tc_kernel<\d+, \w+, 4, ",
                   "int8_gemv": r"gemv_tc_kernel<\d+, \w+, 5, ",
                   "attn_decode": r"decode_attn_kernel"}


def log_step_launches(items, calls: dict) -> None:
    """Phase 5: device operations per decode step (the profiler's kernels
    and memsets), the wrappers' calls per step, and the device launches per
    GEMV and per attention call (one each: the kernels launch nothing
    else, no memset and no second kernel)."""
    ops = sum(n for _, n, _ in items)
    memsets = sum(n for _, n, key in items if "memset" in key.lower())
    per_call = {}
    for w, pat in STEP_DEVICE_OPS.items():
        dev = sum(n for _, n, key in items if re.search(pat, key))
        if calls.get(w):
            per_call[w] = round(dev / calls[w], 3)
    log(f"profile:   launches per step: {ops:.1f} device operations "
        f"({memsets:.1f} memsets); wrapper calls "
        + ", ".join(f"{k} {v:.1f}" for k, v in sorted(calls.items()))
        + "; device launches per call "
        + ", ".join(f"{k} {v}" for k, v in per_call.items()))


def profile_phases(phases, card: str):
    """Phase 5. For each (name, fn, calls per run): wall time with a
    synchronize at each end (best of 3), device busy time (sum of the CUDA
    kernels' self time under ``torch.profiler``), idle share 1 − busy / wall,
    the largest device items, and, in the first timed run, the stream time
    between CUDA events around each ``layers.attention`` call (device time
    where the card is busy throughout, as in a prefill)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for name, fn, per in phases:
        walls, events = [], []
        for r in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with (attention_events(events) if r == 0
                  else contextlib.nullcontext()):
                fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3 / per)
        wall = min(walls)
        reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        calls = {k: n / per for m in kernel_modules()
                 for k, n in m.LAUNCHES.items() if n}
        items = sorted(((e.self_device_time_total / 1e3 / per, e.count / per,
                         e.key) for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA
                        and e.self_device_time_total > 0), reverse=True)
        busy = sum(ms for ms, _, _ in items)
        if busy <= 0:
            log(f"profile: {name}: wall {wall:.2f} ms; device time not "
                "measured (the profiler saw no CUDA kernel)")
            continue
        log(f"profile: {name}: wall {wall:.2f} ms (best of 3), device busy "
            f"{busy:.2f} ms, idle share {1 - busy / wall:.3f}; card {card}")
        for ms, n, key in items[:TOP_ITEMS]:
            log(f"profile:   {ms:8.3f} ms {n:7.1f}x  {key[:90]}")
        if name.startswith("decode step"):
            log_step_launches(items, calls)
        if events:
            att = sum(a.elapsed_time(b) for a, b in events) / per
            log(f"profile:   {att:8.3f} ms {len(events) / per:7.1f}x  "
                f"layers.attention (stream time between CUDA events around "
                f"each call in the first timed run, idle gaps inside "
                f"included; {att / busy:.3f} x device busy)")


BENCH_ITERS = 2  # the bench's best of (3, its default, until the long
# context phase came)


# the phases ``--phase NAME`` runs alone after the build, each with its
# LLM uncut: (card, seed) → launch counts
def run_longctx_alone(card: str, seed: int) -> list:
    """``--phase longctx``: phase 3's check of the flash kernel at the
    one-piece prefill's shape, then the long-context phase."""
    check_flash(seed, [s for s in FLASH_SHAPES if s[0].startswith("longctx")])
    return [run_longctx(build_model(seed), card)]


# ---------------------------------------------------------------------------
# the tp phase: tensor parallelism at tp = 2, two ranks sharing the card
# ---------------------------------------------------------------------------

TP_RANKS = 2  # ranks on cuda:0 (gloo: NCCL refuses two ranks on one device)
TP_DEPTH = 4  # Qwen2-VL-7B's decoder layers (28 uncut) in the tp phase
TP_VIT_DEPTH = 4  # its ViT blocks (32 uncut)
TP_TOKENS = 32  # greedy tokens of the full-VLM request
TP_PATH_STEPS = 8  # paths F and S: one 1024-token prefill and 8 steps
TP_LONG = 2048  # a text prefill at the flash kernel's threshold
TP_BURST = (77, 300, 513, 1000)  # the engine burst's id prompts
TP_BURST_TOKENS = 16
TP_GPTQ_ROWS = 256  # synthetic calibration rows a rank (hessian_dp)
TP_KERNELS = ("w4a8_gemv", "int8_gemv", "int8_gemm", "attn_decode",
              "flash_attn_causal")


@contextlib.contextmanager
def kernel_shapes(store: dict):
    """Counts each kernel wrapper's calls by the shapes of its tensor
    arguments into ``store[(name, shapes)]``."""
    import torch

    mods = kernel_modules()
    saved = [dict(m.KERNELS) for m in mods]

    def wrap(name, fn):
        def call(*a, **kw):
            key = (name, tuple(tuple(t.shape) for t in a[:4]
                               if isinstance(t, torch.Tensor)))
            store[key] = store.get(key, 0) + 1
            return fn(*a, **kw)
        return call

    for m in mods:
        m.KERNELS.update({k: wrap(k, f) for k, f in m.KERNELS.items()})
    try:
        yield
    finally:
        for m, sv in zip(mods, saved):
            m.KERNELS.update(sv)


def _launch_snapshot() -> dict:
    return {k: n for m in kernel_modules() for k, n in m.LAUNCHES.items()}


def _tp_model(seed: int, dev: str, cfg=None):
    """The tp phase's Qwen2-VL-7B at published widths (or ``cfg``), its
    decoder cut to TP_DEPTH and its ViT to TP_VIT_DEPTH: the block path's
    seeded W4A8 decoder with the int8 head, path S's split ``down``, the
    W8A8 tower and merger, the request's inputs, the burst's ids and the
    GPTQ problem, all drawn on ``dev`` from one generator in one order (so
    every rank draws the same)."""
    import torch

    from mquant_tpu_torch import random_init as R
    from mquant_tpu_torch.models.qwen2vl import Qwen2VLConfig

    dev = torch.device(dev)
    v7 = cfg or Qwen2VLConfig.qwen2vl_7b()
    vcfg = dataclasses.replace(
        v7, llm=dataclasses.replace(v7.llm, n_layers=TP_DEPTH),
        vit=dataclasses.replace(v7.vit, n_layers=TP_VIT_DEPTH))
    cfg = vcfg.llm
    g = torch.Generator(device=dev).manual_seed(seed)
    params, state = R.init_w4a8(cfg, g, dev)
    vp, mp, vstate = R.init_vision_w8a8(vcfg.vit, vcfg.merger, g, dev)
    split_down = R.init_split_down(cfg, g, dev)
    patches, grid, toks = R.vlm_inputs(vcfg.image_token_id,
                                       vcfg.vit.patch_dim, PREFILL, g, dev)
    hi = min(1000, cfg.vocab)
    long_ids = torch.randint(1, hi, (1, TP_LONG), generator=g, device=dev)
    burst = [torch.randint(1, hi, (n,), generator=g, device=dev).cpu()
             .numpy() for n in TP_BURST]
    n_in, n_out = cfg.intermediate, cfg.hidden
    X = torch.randn((TP_RANKS * TP_GPTQ_ROWS, n_in), generator=g, device=dev)
    W = torch.randn((n_in, n_out), generator=g, device=dev) * 0.02
    return dict(vcfg=vcfg, params=params, state=state, vp=vp, mp=mp,
                vstate=vstate, split_down=split_down, patches=patches,
                grid=grid, toks=toks, long_ids=long_ids, burst=burst, X=X,
                W=W, dev=dev)


def _tp_embeds(m: dict, vcfg, vp, mp, embed):
    """The full-VLM request's spliced prompt embeddings through the (local
    or whole) tower and merger."""
    from mquant_tpu_torch import random_init as R
    from mquant_tpu_torch.models.qwen2vl import splice_image_embeds
    from mquant_tpu_torch.models.vision import merger_forward, vit_forward

    specs = R.vision_specs()
    feats, _ = vit_forward(vcfg.vit, vp, m["patches"], specs, m["vstate"],
                           "real", grid_hw=m["grid"])
    merged, _ = merger_forward(vcfg.merger, mp, feats, specs, m["vstate"],
                               "real")
    return splice_image_embeds(embed[m["toks"]], m["toks"], merged,
                               vcfg.image_token_id)


def _tp_holds(m: dict, vcfg, llm, vp, mp, n_path: int = TP_PATH_STEPS
              ) -> dict:
    """Holds (a)-(c) on one model (the rank's shard under its mesh, or the
    whole model): the full-VLM request's tokens and last-step logits, a
    2048-id text prefill's last logits, paths F and S (one prefill and
    ``n_path`` steps each), the engine burst's tokens; with each hold's
    wall seconds."""
    import torch

    from mquant_tpu_torch import random_init as R
    from mquant_tpu_torch.serve.engine import ServingEngine
    from mquant_tpu_torch.serve.generate import Generator

    cfg, out, secs = vcfg.llm, {}, {}

    def steps(gen, x, n):
        last = []
        toks = gen.generate_on_device(x, max_new_tokens=n,
                                      on_step=lambda lg: last.append(
                                          lg.float().clone()))
        return toks.cpu(), last[-1].cpu()

    def timed_hold(name, fn):
        _tp_sync(m["dev"])
        t0 = time.perf_counter()
        out[name] = fn()
        _tp_sync(m["dev"])
        secs[name] = time.perf_counter() - t0

    with torch.no_grad():
        block = Generator(cfg, llm, specs=R.llm_specs(), state=m["state"],
                          mode="real", max_len=TP_LONG + 32)
        timed_hold("a", lambda: steps(
            block, _tp_embeds(m, vcfg, vp, mp, block.params["embed"]["w"]),
            TP_TOKENS))
        timed_hold("long", lambda: block.prefill(m["long_ids"])[0].float()
                   .cpu())
        emb = _tp_embeds(m, vcfg, vp, mp, block.params["embed"]["w"])
        full = Generator(cfg, block.params, specs=R.llm_specs("full"),
                         state=m["state"], mode="real",
                         max_len=PREFILL + 32)
        timed_hold("F", lambda: steps(full, emb, n_path + 1))
        del full
        lay = {**block.params["layers"], "down": m["down_S"]}
        split = Generator(cfg, {**block.params, "layers": lay},
                          specs=R.llm_specs("full", split=True),
                          state=m["state"], mode="real",
                          max_len=PREFILL + 32)
        timed_hold("S", lambda: steps(split, emb, n_path + 1))
        del split
        eng = ServingEngine(cfg, block.params, specs=R.llm_specs(),
                            state=m["state"], mode="real", slots=4,
                            max_len=1024 + 2 * TP_BURST_TOKENS,
                            steps_per_block=8)

        def burst():
            rids = [eng.submit(p, max_new_tokens=TP_BURST_TOKENS)
                    for p in m["burst"]]
            res = eng.run()
            return [res[r] for r in rids]

        timed_hold("c", burst)
    return out, secs


def _tp_sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _tp_rank(rank: int, store: str, seed: int, res_dir: str, dev: str,
             cfg):
    """One rank of the tp phase: the process group (gloo over a file store,
    both ranks on cuda:0), the same draw, this rank's shard, the holds under
    the mesh; then rank 0 runs the whole model and holds the shard's
    outputs against it, and both ranks run the sharded GPTQ walk (rank 0
    also the single-rank walk). Writes its launch counts, shapes, wall
    seconds and comparisons to ``res_dir``."""
    import pickle

    import torch
    import torch.distributed as dist

    from mquant_tpu_torch.gptq import core as GC
    from mquant_tpu_torch.gptq import sharded as GS
    from mquant_tpu_torch.kernels import _build
    from mquant_tpu_torch.parallel import sharding as PS

    if dev == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=TP_RANKS)
    try:
        t_start = time.perf_counter()
        if dev == "cuda":
            _build.load()
        m = _tp_model(seed, dev, cfg)
        mesh, dp_mesh = PS.make_mesh(), PS.make_mesh(tp=1)
        vcfg = m["vcfg"]
        lcfg = PS.local_config(vcfg, mesh)
        whole = {"llm": m["params"], "vit": m["vp"], "merger": m["mp"]}
        sp = PS.shard_params(whole, mesh, cfg=vcfg)
        down_S = PS.shard_params(
            {"layers": {"down": m["split_down"]}}, mesh,
            cfg=vcfg.llm)["layers"]["down"]
        res = {"rank": rank, "setup_s": time.perf_counter() - t_start}
        shapes = {}
        before = _launch_snapshot()
        with PS.set_mesh(mesh), kernel_shapes(shapes):
            tp_out, res["secs"] = _tp_holds({**m, "down_S": down_S}, lcfg,
                                            sp["llm"], sp["vit"],
                                            sp["merger"])
        after = _launch_snapshot()
        res["launches"] = {k: after[k] - before[k] for k in after}
        res["shapes"] = shapes
        # (d) the sharded GPTQ walk on one 7B down site
        X, W = m["X"], m["W"]
        t0 = time.perf_counter()
        H = GS.hessian_dp(PS.shard_batch(X, dp_mesh), dp_mesh)
        shd = GS.gptq_matrix_sharded(W, H, mesh, bits=4, act_order=True)
        _tp_sync(dev)
        res["secs"]["d"] = time.perf_counter() - t0
        if rank == 0:
            del sp
            if dev == "cuda":
                torch.cuda.empty_cache()
            ref, res["ref_secs"] = _tp_holds({**m, "down_S": {
                **m["split_down"]}}, vcfg, m["params"], m["vp"], m["mp"])
            res["cmp"] = _tp_compare(tp_out, ref)
            t0 = time.perf_counter()
            solo = GC.gptq_quantize_matrix(W, H, bits=4, act_order=True)
            _tp_sync(dev)
            res["ref_secs"]["d"] = time.perf_counter() - t0
            H1 = GC.accumulate_hessian(None, X)
            res["gptq"] = {
                "H_rel": float((H - H1).abs().max() / H1.abs().max()),
                "w": torch.equal(shd.w, solo.w),
                "scale": torch.equal(shd.scale, solo.scale),
                "perm": torch.equal(shd.perm, solo.perm),
                "fallback": bool(shd.used_fallback),
                "w_diff": int((shd.w != solo.w).sum()),
                "site": tuple(W.shape)}
        res["total_s"] = time.perf_counter() - t_start
        with open(os.path.join(res_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _tp_compare(tp_out: dict, ref: dict) -> dict:
    """Per hold: tokens equal, logits max |d| and in bf16 ulps."""
    import torch

    cmp = {}
    for k in ("a", "F", "S"):
        (tt, lt), (tr, lr) = tp_out[k], ref[k]
        d, ulps = bf16_ulp_err(lt, lr)
        cmp[k] = {"tokens": bool(torch.equal(tt, tr)), "max_d": d,
                  "ulps": ulps, "n": int(tt.shape[-1])}
    d, ulps = bf16_ulp_err(tp_out["long"], ref["long"])
    cmp["long"] = {"tokens": bool(torch.equal(tp_out["long"].argmax(-1),
                                              ref["long"].argmax(-1))),
                   "max_d": d, "ulps": ulps, "n": 1}
    cmp["c"] = {"tokens": tp_out["c"] == ref["c"], "max_d": 0.0,
                "ulps": 0.0, "n": sum(len(t) for t in ref["c"])}
    return cmp


def run_tp_phase(card: str, seed: int, dev: str = "cuda", cfg=None
                 ) -> list:
    """The tp phase: two ranks on cuda:0 (``torch.multiprocessing``, spawn,
    gloo over a file store; NCCL refuses two ranks on one device), each
    drawing the same seeded Qwen2-VL-7B (TP_DEPTH decoder layers,
    TP_VIT_DEPTH ViT blocks) and holding its shard (``parallel.sharding``:
    14 of 28 query heads, 2 of 4 KV heads, 9472 of 18944 intermediate
    columns, 76032 of 152064 vocabulary columns, 8 of 16 ViT heads). Holds,
    against the whole model on rank 0: (a) the full-VLM request's 32
    tokens and last-step logits (and a 2048-id text prefill, the flash
    kernel at 14 heads), (b) paths F and S (one 1024-token prefill and 8
    steps each), (c) the engine's four-prompt burst, (d) the sharded GPTQ
    walk on one 7B ``down`` (18944 × 3584) against the single-rank walk on
    the same H. Decode steps run eagerly under the mesh (gloo's
    collectives cannot be captured in a CUDA graph). Wall times are two
    ranks time-sharing one card, not tensor-parallel speed. Returns both
    ranks' launch counts of the sharded holds. ``dev`` / ``cfg``: a
    rehearsal on the CPU at a small config."""
    import pickle
    import tempfile

    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(_tp_rank, args=(os.path.join(d, "store"), seed,
                                           d, dev, cfg),
                           nprocs=TP_RANKS, start_method="spawn")
        ranks = []
        for r in range(TP_RANKS):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    log("tp: decode steps ran eagerly under the mesh (gloo collectives are "
        "not captured in CUDA graphs); times below are two ranks "
        "time-sharing one card, not tensor-parallel speed")
    for res in ranks:
        counts = {k: n for k, n in res["launches"].items() if n}
        log(f"tp rank {res['rank']}: setup {res['setup_s']:.1f} s, holds "
            + ", ".join(f"{k} {v:.2f} s" for k, v in res["secs"].items())
            + f", total {res['total_s']:.1f} s; launches {counts}")
        by_kernel = {}
        for (name, shp), n in sorted(res["shapes"].items()):
            if name in TP_KERNELS:
                by_kernel.setdefault(name, []).append(f"{shp} x{n}")
        for name, lst in by_kernel.items():
            log(f"tp rank {res['rank']}: {name} at " + "; ".join(lst))
    log("tp: the whole model on rank 0: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in r0["ref_secs"].items()))
    failed = []
    for k, c in r0["cmp"].items():
        log(f"tp hold {k}: tokens equal {c['tokens']} ({c['n']}), logits "
            f"max |d| {c['max_d']:.6g} ({c['ulps']:.3g} bf16 ulp)")
        if not c["tokens"] or c["ulps"] > 1.0:
            failed.append(k)
    g = r0["gptq"]
    log(f"tp hold d: GPTQ on {g['site']} over {TP_RANKS} ranks, on the H "
        f"of hessian_dp (against one rank's 2XᵀX of all rows: rel "
        f"{g['H_rel']:.3g}): codes equal "
        f"{g['w']} ({g['w_diff']} differ), scales {g['scale']}, perm "
        f"{g['perm']}, fallback {g['fallback']}")
    if not (g["w"] and g["scale"] and g["perm"]) or g["fallback"]:
        failed.append("d")
    missing = [k for k in TP_KERNELS
               if any(res["launches"][k] <= 0 for res in ranks)]
    if failed or missing:
        raise AssertionError(f"tp: holds failed {failed}; kernels never "
                             f"launched on a rank {missing}")
    log(f"tp phase: {wall:.1f} s (spawn, draws, holds, the whole model on "
        f"rank 0); card {card}")
    return [res["launches"] for res in ranks]


PHASES = {"pipeline": lambda card, seed: run_pipeline_phase(card, seed, 28),
          "longctx": run_longctx_alone,
          "golden": lambda card, seed: [run_golden(card)],
          "internvl": run_internvl_phase, "glm4v": run_glm4v_phase,
          "tp": run_tp_phase,
          "qwenvl": run_qwenvl_phase, "minicpmv": run_minicpmv_phase,
          "checkpoint": lambda card, seed: run_checkpoint_phase(card, seed,
                                                                28)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phase", choices=sorted(PHASES), default=None,
                    help="build the kernels and run this phase alone, its "
                         "LLM uncut")
    args = ap.parse_args(argv)

    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false)")
    card = card_line()
    log(card)  # name, power limit: as nvidia-smi prints them
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build
    from mquant_tpu_torch.kernels import _build

    path, secs = _build.build(verbose=True)
    log(f"build: {path.name} in {secs:.1f} s")
    _build.load()
    funcs = sass_functions(path)
    sass_hopper_kernels(funcs)
    sass_unpack_variants(funcs)
    sass_w8_bf16(funcs)
    if args.phase:
        t0 = time.perf_counter()
        counts = PHASES[args.phase](card, args.seed)
        log(f"{args.phase} phase alone"
            + ("" if args.phase == "tp" else ", its LLM uncut") + ": "
            f"{time.perf_counter() - t0:.1f} s; launches "
            + ", ".join(f"{k} {sum(c[k] for c in counts)}" for k in REPLACES
                        if sum(c[k] for c in counts)) + f"; card {card}")
        return 0

    # phase 3: kernels vs plain
    t0 = time.perf_counter()
    summary = check_kernels(args.seed)
    summary.update(check_attention(args.seed))
    check_bf16_reduction(args.seed)
    summary.update(check_tail(args.seed))
    summary.update(check_probe_kernels(args.seed))
    summary.update(check_decode_probe_kernels(args.seed))
    summary.update(check_group_epilogue(args.seed))
    log(f"phase 3: {time.perf_counter() - t0:.1f} s; card {card}")

    # the tp phase: tensor parallelism at tp = 2, two ranks on this card
    counts = run_tp_phase(card, args.seed)

    # the prefill probe and the int8 rate probe, counted as one path; the
    # three decode-rate probes, another
    t0 = time.perf_counter()
    counts += [run_probe(args.seed, card), run_decode_probes(args.seed, card)]
    log(f"probes: {time.perf_counter() - t0:.1f} s; card {card}")

    # the golden: the JAX package's tokens at 7B widths, held on the card
    t0 = time.perf_counter()
    counts.append(run_golden(card))
    log(f"golden phase: {time.perf_counter() - t0:.1f} s; card {card}")

    # phases 4 and 5: each path of the main path, then its profile
    model = build_model(args.seed)
    for name, run in (("slice", lambda: [run_slice(model, card)]),
                      ("path F", lambda: [run_full(model, card)]),
                      ("path S", lambda: [run_split(model, card)]),
                      ("artifact + engine",
                       lambda: run_artifact(model, card, args.seed)),
                      ("document", lambda: [run_document(model, card)]),
                      ("batch", lambda: [run_batch(model, card)])):
        t0 = time.perf_counter()
        counts += run()
        log(f"{name} phase: {time.perf_counter() - t0:.1f} s; card {card}")
    # phase 4 (c): the storage configurations and quantized KV caches
    t0 = time.perf_counter()
    counts += run_storage_phase(model, card)
    log(f"storage phase: {time.perf_counter() - t0:.1f} s; card {card}")
    # phase 4 (d): the chunked long-context prefill on the same model
    t0 = time.perf_counter()
    counts.append(run_longctx(model, card))
    log(f"longctx phase: {time.perf_counter() - t0:.1f} s; card {card}")

    # phase 6: the bench (W4A8 against bf16 at depth 28), its JSON printed
    del model
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    counts += run_pipeline_phase(card, args.seed)
    log(f"pipeline phase: {time.perf_counter() - t0:.1f} s; card {card}")
    # InternVL2-8B at its published widths: quantized, then served
    t0 = time.perf_counter()
    counts += run_internvl_phase(card, args.seed, depth=IVL_DEPTH)
    log(f"internvl phase: {time.perf_counter() - t0:.1f} s; card {card}")
    # GLM-4V-9B at its published widths: quantized, then served
    t0 = time.perf_counter()
    counts += run_glm4v_phase(card, args.seed, depth=GLM_DEPTH)
    log(f"glm4v phase: {time.perf_counter() - t0:.1f} s; card {card}")
    # Qwen-VL-Chat at its published widths, its LLM at QVL_DEPTH
    t0 = time.perf_counter()
    counts += run_qwenvl_phase(card, args.seed, depth=QVL_DEPTH)
    log(f"qwenvl phase: {time.perf_counter() - t0:.1f} s; card {card}")
    # MiniCPM-V-2.6 at its published widths, its LLM at MCPM_DEPTH, and a
    # padded non-square request (A6)
    t0 = time.perf_counter()
    counts += run_minicpmv_phase(card, args.seed, depth=MCPM_DEPTH)
    log(f"minicpmv phase: {time.perf_counter() - t0:.1f} s; card {card}")
    # the offline pipeline from an HF checkpoint at CKPT_DEPTH, with the
    # evaluation phase on its runner
    t0 = time.perf_counter()
    counts += run_checkpoint_phase(card, args.seed)
    log(f"checkpoint + eval phases: {time.perf_counter() - t0:.1f} s; "
        f"card {card}")
    from mquant_tpu_torch import bench

    t0 = time.perf_counter()
    bench.main(["--iters", str(BENCH_ITERS)])
    log(f"bench: {time.perf_counter() - t0:.1f} s; card {card}")

    kernels = []
    for k in REPLACES:
        s = summary[k]
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCES[k],
            "replaces": REPLACES[k], "launches": sum(c[k] for c in counts),
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": ("operations" if s["op_bound_ms"] * 2 >= s["bound_ms"]
                         else "bytes"),
            "library_ms": (s["library_ms"] if s["lib_shapes"] == s["shapes"]
                           else None)})
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
