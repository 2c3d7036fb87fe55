"""Quantize a Qwen2-VL, Qwen-VL, InternVL2 or GLM-4V model with the port's
pipeline, write its artifact and evaluate it (counterpart of
``exam/quant_vlm.py``).

On the card unless ``--device cpu``. Without checkpoints the weights are
random, drawn from ``--seed``, and the calibration data synthetic:
max(1, calib_num // 16) batches of one ``--calib_image_size``² image and
32 text tokens; GPTQ takes the first ``--nsamples`` rows. The reference's
headline W4A8 configuration on Qwen2-VL-7B:

  python -m mquant_tpu_torch.quant_vlm --model Qwen2-VL-7B \\
      --rotate --online_llm_hadamard --llm_split --act_order \\
      --llm_w_bits 4 --llm_a_bits 8 --visual_w_bits 8 --visual_a_bits 8 \\
      --calib_num 512 --nsamples 32 --calib_image_size 448 \\
      --realize_int --artifact out/qwen2vl7b_w4a8

and on Qwen-VL-Chat (``--model Qwen-VL-Chat``: the CLIP-style tower with
``fc_sub_mean``, the attn_pool resampler, the Qwen decoder;
``--visual_w_gptq`` runs the resampler's GPTQ), InternVL2-8B (``--model
InternVL2-8B``: InternViT, pixel shuffle + mlp1, the InternLM2 decoder) or
GLM-4V-9B (``--model GLM-4V-9B``: the EVA2CLIP tower, the GLU projector,
ChatGLM; ``--visual_w_gptq`` runs the GLU projector's GPTQ) with the same
flags.

``--calib_dataset NAME_OR_TSV`` calibrates on the first ``--calib_num``
rows of an eval dataset instead (through the serving input construction).
``--dataset_name NAME_OR_TSV`` then evaluates the quantized model
(``evaluation.eval``; the runner in ``real`` mode under ``--realize_int``,
``fake`` otherwise): ``--eval_limit`` rows, ``--eval_batch`` > 1 rows at a
time through the continuous-batching engine, MCQ answers that exact
matching cannot parse matched by the model of ``--judge_artifact``, the
results CSV under ``--output_dir``. The port's TSV reader takes PNG images
only (VLMEvalKit's are JPEG: ROADMAP A13b). On the card, e.g.

  python -m mquant_tpu_torch.quant_vlm --model Qwen2-VL-7B --rotate \
      --online_llm_hadamard --llm_split --realize_int \
      --dataset_name PATH.tsv --eval_batch 8

``--tiny`` takes the tiny test configuration. The storage flags are the JAX
CLI's (``--w_asym``, ``--w_groupsize``, ``--a_asym``, ``--a_groupsize``,
``--a_clip_ratio``, ``--act_per_tensor``, plus ``--act_per_channel`` to turn
it off), and ``--k_bits`` / ``--v_bits`` 8 or 4 give the evaluation's runner
an int8 / int4 KV cache. So are the pipeline's options: ``--model_dir`` (an
HF Qwen2-VL, Qwen-VL, InternVL2 or GLM-4V checkpoint: sharded or single
safetensors, or
``pytorch_model.bin``; its tokenizer through ``transformers`` where that is
installed, else the byte tokenizer), ``--smooth_alpha``,
``--online_had_mode auto``, ``--lm_head_bits auto`` with
``--lm_head_gate``, ``--auto_bits`` with ``--auto_bits_low`` /
``--auto_bits_high``, ``--visual_w_gptq``, ``--log_file``, and
``--fp32_had``, accepted and without effect as in JAX. On the card, e.g.

  python -m mquant_tpu_torch.quant_vlm --model Qwen2-VL-7B \
      --model_dir CKPT --rotate --online_llm_hadamard --llm_split \
      --act_order --visual_w_gptq --online_had_mode auto \
      --lm_head_bits auto --realize_int --artifact ART \
      --export_safetensors EXPORT

``--export_safetensors DIR`` also writes the params and the static state
as ``params.safetensors`` / ``state.safetensors`` (the JAX CLI's files,
``utils.checkpoint.export_safetensors``). The last line of stdout is a
JSON summary: each stage's seconds and peak GiB, the GPTQ fallbacks (the
LLM's and the visual), the gates' picks, the artifact's and the export's
bytes and, with ``--dataset_name``, the metrics, the row count and the
eval's seconds.
"""

from __future__ import annotations

import argparse
import json
import sys


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="Qwen2-VL-7B",
                   help="Qwen2-VL-{2B,7B,72B}, Qwen-VL-Chat, InternVL2-8B "
                        "or GLM-4V-9B")
    p.add_argument("--tiny", action="store_true", help="tiny config")
    p.add_argument("--model_dir", default=None,
                   help="HF checkpoint dir (omitted: random weights)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rotate", action="store_true")
    p.add_argument("--rotate_mode", default="hadamard",
                   choices=["hadamard", "random"])
    p.add_argument("--no_rotate_visual", action="store_true")
    p.add_argument("--no_rotate_llm", action="store_true")
    p.add_argument("--online_llm_hadamard", action="store_true")
    p.add_argument("--online_had_mode", default="full",
                   choices=["full", "block", "auto"],
                   help="block: I ⊗ H_128; auto: a calibration-time gate "
                        "picks full or block by the int8 error on the "
                        "captured down inputs")
    p.add_argument("--llm_split", action="store_true")
    p.add_argument("--online_visual_hadamard", action="store_true")
    p.add_argument("--visual_split", action="store_true")
    p.add_argument("--smooth_alpha", type=float, default=0.0,
                   help="SmoothQuant-style migration before rotation "
                        "(0 = off)")
    p.add_argument("--fp32_had", action="store_true",
                   help="accepted for flag parity; changes nothing")
    p.add_argument("--visual_w_bits", type=int, default=8)
    p.add_argument("--llm_w_bits", type=int, default=4)
    p.add_argument("--visual_w_rtn", action="store_true", default=True)
    p.add_argument("--visual_w_gptq", action="store_true",
                   help="GPTQ for the vision tower, patch embed and merger "
                        "(default: RTN)")
    p.add_argument("--llm_w_rtn", action="store_true")
    p.add_argument("--visual_w_clip", "--llm_w_clip", dest="w_clip",
                   action="store_true")
    p.add_argument("--auto_bits", type=float, default=0.0,
                   help="sensitivity-based mixed precision: target average "
                        "weight bits; every measured site starts at "
                        "--auto_bits_low and the most damaging are promoted "
                        "to --auto_bits_high under the budget")
    p.add_argument("--auto_bits_low", type=int, default=4)
    p.add_argument("--auto_bits_high", type=int, default=8)
    p.add_argument("--lm_head_bits", default="0",
                   choices=["0", "4", "8", "auto"],
                   help="0 = float head, 8 / 4 = int8 / packed-W4 head, "
                        "auto = W4 iff its head-only perplexity ratio stays "
                        "under --lm_head_gate")
    p.add_argument("--lm_head_gate", type=float, default=1.002)
    p.add_argument("--act_order", action="store_true")
    p.add_argument("--percdamp", type=float, default=0.01)
    p.add_argument("--nsamples", type=int, default=128)
    p.add_argument("--visual_a_bits", type=int, default=8)
    p.add_argument("--llm_a_bits", type=int, default=8)
    p.add_argument("--visual_static", action="store_true", default=True)
    p.add_argument("--llm_static", action="store_true", default=True)
    p.add_argument("--act_observer", default="minmax",
                   choices=["minmax", "ema", "percentile", "omse", "ptf"])
    p.add_argument("--calib_num", type=int, default=128)
    p.add_argument("--calib_decode_steps", type=int, default=0)
    p.add_argument("--calib_image_size", type=int, default=16,
                   help="side of the synthetic calibration images")
    p.add_argument("--calib_dataset", default=None,
                   help="calibrate on real prompts from this eval dataset "
                        "(same names as --dataset_name); default: synthetic")
    p.add_argument("--skip_names", nargs="*", default=[])
    p.add_argument("--realize_int", action="store_true")
    p.add_argument("--k_bits", "--v_bits", dest="kv_bits", type=int,
                   default=None, choices=[4, 8],
                   help="quantized KV cache of the evaluation's runner "
                        "(8: int8, 4: nibble-packed int4)")
    p.add_argument("--w_groupsize", type=int, default=None)
    p.add_argument("--w_asym", action="store_true")
    p.add_argument("--a_asym", action="store_true")
    p.add_argument("--a_groupsize", type=int, default=None)
    p.add_argument("--a_clip_ratio", type=float, default=1.0)
    p.add_argument("--act_per_tensor", action="store_true", default=True)
    p.add_argument("--act_per_channel", dest="act_per_tensor",
                   action="store_false",
                   help="per-channel static activation scales (folded into "
                        "the weights when realized)")
    p.add_argument("--artifact", default=None, help="artifact output dir")
    p.add_argument("--export_safetensors", default=None,
                   help="also write params / state as .safetensors files "
                        "into this directory")
    p.add_argument("--dataset_name", default=None,
                   help="eval dataset (MME | MMBench | OCRBench | TextVQA_VAL "
                        "| DocVQA_VAL | SyntheticVQA | path to TSV)")
    p.add_argument("--eval_limit", type=int, default=None)
    p.add_argument("--judge_artifact", default=None,
                   help="artifact dir of a JUDGE model: MCQ predictions "
                        "exact matching cannot parse are matched by this "
                        "served model")
    p.add_argument("--eval_batch", type=int, default=0,
                   help=">1: evaluate through the continuous-batching "
                        "engine pool, eval_batch rows at a time")
    p.add_argument("--output_dir", default="output")
    p.add_argument("--log_file", default=None)
    return p


def _tokenizer(model_dir: str, log):
    """The checkpoint's tokenizer through ``transformers`` where it is
    installed; else None (the byte tokenizer)."""
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(model_dir,
                                             trust_remote_code=True)
    except Exception as e:  # no transformers, or no tokenizer files
        log.warning(f"tokenizer load failed ({e}); using byte tokenizer")
        return None


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    import torch

    from .pipeline import QuantizeConfig, run_pipeline
    from .utils.misc import config_logging, seed_everything

    log = config_logging(args.log_file)
    seed_everything(args.seed)
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("quant_vlm: no CUDA device (pass --device cpu "
                             "for the CPU)")
        torch.backends.cuda.matmul.allow_tf32 = False
    q = QuantizeConfig(
        rotate=args.rotate, rotate_mode=args.rotate_mode,
        rotate_visual=not args.no_rotate_visual,
        rotate_llm=not args.no_rotate_llm,
        online_llm_hadamard=args.online_llm_hadamard,
        online_had_mode=args.online_had_mode, llm_split=args.llm_split,
        online_visual_hadamard=args.online_visual_hadamard,
        visual_split=args.visual_split, smooth_alpha=args.smooth_alpha,
        visual_w_bits=args.visual_w_bits, llm_w_bits=args.llm_w_bits,
        visual_w_rtn=args.visual_w_rtn and not args.visual_w_gptq,
        llm_w_rtn=args.llm_w_rtn, w_clip=args.w_clip,
        auto_bits=args.auto_bits, auto_bits_low=args.auto_bits_low,
        auto_bits_high=args.auto_bits_high,
        lm_head_bits=(args.lm_head_bits if args.lm_head_bits == "auto"
                      else int(args.lm_head_bits)),
        lm_head_gate=args.lm_head_gate,
        act_order=args.act_order, percdamp=args.percdamp,
        nsamples=args.nsamples, visual_a_bits=args.visual_a_bits,
        llm_a_bits=args.llm_a_bits, visual_static=args.visual_static,
        llm_static=args.llm_static, act_observer=args.act_observer,
        calib_num=args.calib_num, calib_decode_steps=args.calib_decode_steps,
        skip_names=tuple(args.skip_names), realize_int=args.realize_int,
        w_groupsize=args.w_groupsize, w_asym=args.w_asym, a_asym=args.a_asym,
        a_groupsize=args.a_groupsize, a_clip_ratio=args.a_clip_ratio,
        act_per_tensor=args.act_per_tensor, kv_bits=args.kv_bits,
        seed=args.seed)
    tokenizer = _tokenizer(args.model_dir, log) if args.model_dir else None
    cfg, params, state, specs, info = run_pipeline(
        args.model, q, model_dir=args.model_dir, tiny=args.tiny,
        artifact_dir=args.artifact, calib_dataset=args.calib_dataset,
        tokenizer=tokenizer, image_size=args.calib_image_size,
        device=args.device)
    log.info(f"pipeline done: {args.model}")
    gptq = info.get("gptq") or {}
    vis = info.get("vis_gptq") or {}
    summary = {
        "device": (torch.cuda.get_device_name(torch.device(args.device))
                   if torch.device(args.device).type == "cuda" else "cpu"),
        "stages": {k: {"seconds": v["seconds"],
                       "peak_gib": (None if v["peak_bytes"] is None
                                    else v["peak_bytes"] / 2**30)}
                   for k, v in info["stages"].items()},
        "gptq_sites": gptq.get("sites", 0),
        "gptq_fallbacks": gptq.get("fallbacks", []),
        "gptq_seconds": gptq.get("seconds"),
        "visual_gptq_sites": vis.get("sites", 0),
        "visual_gptq_fallbacks": vis.get("fallbacks", []),
        "online_had_auto": info.get("online_had_auto"),
        "lm_head_bits": info.get("lm_head_bits"),
        "autobits": info.get("autobits"),
        "artifact": args.artifact,
        "artifact_bytes": info.get("artifact_bytes")}
    if args.export_safetensors:
        summary["export_bytes"] = export(args, cfg, params, state)
        log.info(f"safetensors written to {args.export_safetensors}")
    if args.dataset_name:
        summary["eval"] = evaluate(args, cfg, params, state, specs,
                                   tokenizer)
    print(json.dumps(summary), flush=True)
    return 0


def export(args, cfg, params, state) -> int:
    """``--export_safetensors DIR``: params.safetensors (with the model name
    and config in its metadata) and state.safetensors; returns the bytes."""
    import os

    from .utils.checkpoint import config_to_dict, export_safetensors

    os.makedirs(args.export_safetensors, exist_ok=True)
    meta = {"model": args.model, "config": json.dumps(config_to_dict(cfg))}
    n = export_safetensors(params, os.path.join(
        args.export_safetensors, "params.safetensors"), extra_meta=meta)
    if state is not None:
        n += export_safetensors(state, os.path.join(
            args.export_safetensors, "state.safetensors"))
    return n


def evaluate(args, cfg, params, state, specs, tokenizer=None) -> dict:
    """``--dataset_name``: the quantized model through ``eval_dataset``;
    returns the summary's "eval" entry."""
    from .evaluation.adapter import VLMRunner
    from .evaluation.eval import build_dataset, eval_dataset

    runner = VLMRunner(args.model, cfg, params, specs=specs, state=state,
                       mode="real" if args.realize_int else "fake",
                       tokenizer=tokenizer, kv_quant=args.kv_bits or False)
    ds = build_dataset(args.dataset_name)
    batch_fn = (runner.engine_server(slots=args.eval_batch)
                if args.eval_batch and args.eval_batch > 1 else None)
    extract_fn = None
    if args.judge_artifact:
        # a second served model matches unparseable MCQ answers (the
        # reference's ChatGPT-judge slot, image_mcq.py:216-224)
        from .evaluation.judge import runner_judge
        from .serve.server import build_runner_from_artifact

        extract_fn = runner_judge(build_runner_from_artifact(
            args.judge_artifact, device=args.device))
    res = eval_dataset(runner.generate, ds, out_dir=args.output_dir,
                       model_name=args.model, limit=args.eval_limit,
                       batch_fn=batch_fn, batch_size=args.eval_batch,
                       extract_fn=extract_fn)
    return {"dataset": ds.name, "metrics": res["metrics"], "rows": res["n"],
            "seconds": res["seconds"], "results_file": res["results_file"]}


if __name__ == "__main__":
    sys.exit(main())
