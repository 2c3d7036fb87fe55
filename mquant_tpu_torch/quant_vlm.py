"""Quantize a Qwen2-VL model with the port's pipeline and write its
artifact (counterpart of ``exam/quant_vlm.py`` without its evaluation,
ROADMAP A13).

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

``--tiny`` takes the tiny test configuration. The last line of stdout is
a JSON summary: each stage's seconds and peak GiB, the GPTQ fallbacks, the
artifact's bytes.
"""

from __future__ import annotations

import argparse
import json
import sys


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="Qwen2-VL-7B",
                   help="Qwen2-VL-{2B,7B,72B}")
    p.add_argument("--tiny", action="store_true", help="tiny config")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rotate", action="store_true")
    p.add_argument("--rotate_mode", default="hadamard",
                   choices=["hadamard", "random"])
    p.add_argument("--no_rotate_visual", action="store_true")
    p.add_argument("--no_rotate_llm", action="store_true")
    p.add_argument("--online_llm_hadamard", action="store_true")
    p.add_argument("--online_had_mode", default="full",
                   choices=["full", "block"])
    p.add_argument("--llm_split", action="store_true")
    p.add_argument("--online_visual_hadamard", action="store_true")
    p.add_argument("--visual_split", action="store_true")
    p.add_argument("--visual_w_bits", type=int, default=8)
    p.add_argument("--llm_w_bits", type=int, default=4)
    p.add_argument("--llm_w_rtn", action="store_true")
    p.add_argument("--visual_w_clip", "--llm_w_clip", dest="w_clip",
                   action="store_true")
    p.add_argument("--lm_head_bits", type=int, default=0, choices=[0, 4, 8])
    p.add_argument("--act_order", action="store_true")
    p.add_argument("--percdamp", type=float, default=0.01)
    p.add_argument("--nsamples", type=int, default=128)
    p.add_argument("--visual_a_bits", type=int, default=8)
    p.add_argument("--llm_a_bits", type=int, default=8)
    p.add_argument("--act_observer", default="minmax",
                   choices=["minmax", "ema", "percentile", "omse", "ptf"])
    p.add_argument("--calib_num", type=int, default=128)
    p.add_argument("--calib_decode_steps", type=int, default=0)
    p.add_argument("--calib_image_size", type=int, default=16,
                   help="side of the synthetic calibration images")
    p.add_argument("--skip_names", nargs="*", default=[])
    p.add_argument("--realize_int", action="store_true")
    p.add_argument("--artifact", default=None, help="artifact output dir")
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    import torch

    from .pipeline import QuantizeConfig, run_pipeline

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
        visual_split=args.visual_split, visual_w_bits=args.visual_w_bits,
        llm_w_bits=args.llm_w_bits, llm_w_rtn=args.llm_w_rtn,
        w_clip=args.w_clip, lm_head_bits=args.lm_head_bits,
        act_order=args.act_order, percdamp=args.percdamp,
        nsamples=args.nsamples, visual_a_bits=args.visual_a_bits,
        llm_a_bits=args.llm_a_bits, act_observer=args.act_observer,
        calib_num=args.calib_num, calib_decode_steps=args.calib_decode_steps,
        skip_names=tuple(args.skip_names), realize_int=args.realize_int,
        seed=args.seed)
    _, _, _, _, info = run_pipeline(
        args.model, q, tiny=args.tiny, artifact_dir=args.artifact,
        image_size=args.calib_image_size, device=args.device)
    gptq = info.get("gptq") or {}
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
        "artifact": args.artifact,
        "artifact_bytes": info.get("artifact_bytes")}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
