"""The offline PTQ pipeline, Qwen2-VL, Qwen-VL, InternVL2 and GLM-4V
(counterpart of ``mquant_tpu/pipeline.py``): an HF checkpoint, random or
given weights → SmoothQuant migration → the online-Hadamard gate → fuse /
rotate → the lm_head width gate → sensitivity-based mixed bits → weight
quantization (LLM GPTQ or RTN, vision tower, patch embed and merger /
resampler / mlp1 / GLU projector GPTQ or RTN, head RTN) → static
activation calibration (MSQ) → integer realization → artifact
(``utils.checkpoint.save_artifact``), which
``serve.server.build_runner_from_artifact`` serves.

One structured :class:`QuantizeConfig` with the JAX package's fields.
Everything runs on the card unless the caller passes ``device="cpu"``;
``run_pipeline``'s ``info`` records each stage's seconds and, on the card,
its peak memory. The stages take the family from the model config
(``models.registry.family_of``) and run its forward on a batch's
{"tokens", "patches", extras} (:func:`batch_forward`). MiniCPM-V raises
naming ROADMAP A12 (``models.registry.get_family``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Dict, List, Optional, Tuple

import torch

from .models.layers import SiteSpec
from .models.llm import LLM_SITES
from .models.registry import (family_of, get_family, grid_image_features,
                              image_tokens)
from .models.resampler import RES_SITES
from .models.vision import VIT_SITES

log = logging.getLogger("mquant_tpu_torch.pipeline")

# site names per subsystem prefix (a superset: a family's forward never
# reaches the sites it lacks, as GLM-4V's proj sites for InternVL2)
SUBSYSTEM_SITES = {
    "vis": VIT_SITES + ("patch_embed",),
    "merger": ("mlp0", "mlp2"),
    "res": RES_SITES,
    "proj": ("fc1", "fc2", "conv", "linear_proj", "gate", "h_to_4h",
             "4h_to_h"),
    "llm": LLM_SITES,
}
QWEN2VL_SUBSYSTEMS = ("vis", "merger", "llm")


@dataclasses.dataclass
class QuantizeConfig:
    """The JAX package's fields, with its defaults (their meaning there;
    the reference's flag names). :func:`check_ported` says which values
    this port implements."""

    rotate: bool = True
    rotate_mode: str = "hadamard"  # hadamard | random
    rotate_visual: bool = True
    rotate_llm: bool = True
    online_llm_hadamard: bool = True
    online_had_mode: str = "full"  # full | block | auto (the calib-time
    # gate, _choose_online_had_mode)
    llm_split: bool = True
    online_visual_hadamard: bool = False
    visual_split: bool = False
    smooth_alpha: float = 0.0
    visual_w_bits: int = 8
    llm_w_bits: int = 4
    visual_w_rtn: bool = True
    llm_w_rtn: bool = False
    w_clip: bool = False
    w_asym: bool = False
    w_groupsize: Optional[int] = None
    auto_bits: float = 0.0
    auto_bits_low: int = 4
    auto_bits_high: int = 8
    lm_head_bits: object = 0  # 0 = float head, 4 / 8 = quantized, "auto" =
    # the head gate (utils.autobits.decide_head_bits) under lm_head_gate
    lm_head_gate: float = 1.002
    act_order: bool = False
    percdamp: float = 0.01
    nsamples: int = 128
    visual_a_bits: int = 8
    llm_a_bits: int = 8
    visual_static: bool = True
    llm_static: bool = True
    a_asym: bool = False
    a_groupsize: Optional[int] = None
    a_clip_ratio: float = 1.0
    calib_decode_steps: int = 0
    act_per_tensor: bool = True
    act_observer: str = "minmax"
    calib_num: int = 128
    skip_names: Tuple[str, ...] = ()
    realize_int: bool = False
    kv_bits: Optional[int] = None
    seed: int = 0


def check_ported(q: QuantizeConfig, family: str = "qwen2vl"):
    """Raise ValueError for a value of ``q`` that names no option, and
    NotImplementedError for visual GPTQ of MiniCPM-V's resampler, whose
    family is not ported (ROADMAP A12c)."""
    if q.lm_head_bits not in (0, 4, 8, "auto"):
        raise ValueError(f"lm_head_bits={q.lm_head_bits!r}: 0, 4, 8 or "
                         "'auto'")
    if q.online_had_mode not in ("full", "block", "auto"):
        raise ValueError(f"online_had_mode={q.online_had_mode!r}")
    if family == "minicpmv" and not q.visual_w_rtn:
        raise NotImplementedError(
            "visual GPTQ of the minicpmv resampler is not ported (ROADMAP "
            "A12c)")


def build_specs(q: QuantizeConfig,
                subsystems: tuple = QWEN2VL_SUBSYSTEMS
                ) -> Dict[str, SiteSpec]:
    """Specs for every quant site of a family's ``subsystems`` (MSQ:
    per-subsystem settings; Qwen2-VL's by default), the head's where
    ``lm_head_bits`` is set, ``llm.down`` with the online Hadamard and RMS
    split, ``vis.fc2`` with the visual ones."""
    specs: Dict[str, SiteSpec] = {}
    for prefix in subsystems:
        sites = SUBSYSTEM_SITES[prefix]
        visual = prefix != "llm"
        w_bits = q.visual_w_bits if visual else q.llm_w_bits
        a_bits = q.visual_a_bits if visual else q.llm_a_bits
        static = q.visual_static if visual else q.llm_static
        for s in sites:
            name = f"{prefix}.{s}"
            if any(sk in name for sk in q.skip_names):
                continue
            specs[name] = SiteSpec(
                w_bits=w_bits or None, a_bits=a_bits or None, a_static=static,
                a_symmetric=not q.a_asym,
                a_per_channel=False if q.act_per_tensor else True,
                a_groupsize=q.a_groupsize, a_clip_ratio=q.a_clip_ratio,
                observer=q.act_observer)
    if q.lm_head_bits and q.lm_head_bits != "auto":
        specs["llm.lm_head"] = head_spec(q, int(q.lm_head_bits))
    if ("llm.down" in specs and q.rotate and q.rotate_llm
            and q.online_llm_hadamard):
        if q.online_had_mode == "block":
            specs["llm.down"] = dataclasses.replace(
                specs["llm.down"], online_had="block", head_dim=128,
                split=q.llm_split)
        else:
            specs["llm.down"] = dataclasses.replace(
                specs["llm.down"], online_had="full", split=q.llm_split)
    if "vis.fc2" in specs and q.rotate and q.rotate_visual:
        if q.online_visual_hadamard or q.visual_split:
            specs["vis.fc2"] = dataclasses.replace(
                specs["vis.fc2"],
                online_had="full" if q.online_visual_hadamard else None,
                split=q.visual_split)
    return specs


# ---------------------------------------------------------------------------
# weights and calibration data
# ---------------------------------------------------------------------------


def synthetic_calib_batches(cfg, n_batches: int, gen: torch.Generator,
                            batch: int = 1, text_len: int = 32,
                            image_size: int = 16, device="cuda"
                            ) -> List[dict]:
    """Random multimodal calibration batches of the right shapes, drawn
    from ``gen``: a normal image (batch, image_size², 3) patchified, its
    image tokens (one per 2 × 2 patches, GLM-4V's boi and eoi too) at
    positions 2.., then text_len − 2 random ids below min(vocab, 1000), the
    rest token 11 (Qwen-VL: its resampler's n_queries image tokens). The
    batch's extras are the family's: Qwen2-VL's ``grid_hw``, InternVL2's
    and GLM-4V's ``grid`` (gh, gw), none for Qwen-VL."""
    from .models.vision import patchify_2d, patchify_qwen2vl

    name = family_of(cfg).name
    out = []
    for _ in range(n_batches):
        images = torch.randn((batch, image_size, image_size, 3),
                             generator=gen, device=gen.device).to(device)
        if name != "qwen2vl":
            patches, _ = patchify_2d(images, cfg.patch)
            gh = gw = image_size // cfg.patch
            n_img = image_tokens(cfg, gh, gw)
            extra = {} if name == "qwenvl" else {"grid": (gh, gw)}
        else:
            patches, grid = patchify_qwen2vl(images, patch=cfg.patch)
            n_img = patches.shape[1] // 4
            extra = {"grid_hw": grid}
        toks = torch.full((batch, n_img + text_len), 11, dtype=torch.int64)
        toks[:, 2:2 + n_img] = cfg.image_token_id
        toks[:, n_img + 2:] = torch.randint(
            0, min(cfg.llm.vocab, 1000), (batch, text_len - 2),
            generator=gen, device=gen.device).cpu()
        out.append({"tokens": toks.to(device), "patches": patches, **extra})
    return out


def batch_forward(cfg, params: Dict, batch: dict, **kw):
    """The family's forward on one batch {"tokens", "patches", extras}:
    (logits, cache, stats)."""
    extras = {k: v for k, v in batch.items() if k not in ("tokens",
                                                          "patches")}
    return family_of(cfg).forward_fn(cfg, params, batch["tokens"],
                                     batch.get("patches"), **extras, **kw)


def _bound_nsamples(batches: List[dict], nsamples: int) -> List[dict]:
    """At most ``nsamples`` calibration rows for GPTQ: whole batches plus
    one row-sliced remainder."""
    if not nsamples or nsamples <= 0:
        return batches
    out, seen = [], 0
    for b in batches:
        rows = b["tokens"].shape[0]
        if seen + rows <= nsamples:
            out.append(b)
            seen += rows
        else:
            take = nsamples - seen
            if take > 0:
                out.append({k: (v[:take] if isinstance(v, torch.Tensor)
                                and v.ndim >= 1 and v.shape[0] == rows
                                else v) for k, v in b.items()})
                seen += take
        if seen >= nsamples:
            break
    return out


def embed_batch(cfg, params: Dict, batch: dict) -> torch.Tensor:
    """Decoder-input embeddings of one batch: the embedding, the float
    ViT and projector (the merger, the resampler, pixel shuffle + mlp1 or
    the GLU projector), the splice."""
    from .models.qwen2vl import splice_image_embeds
    from .models.vision import merger_forward, vit_forward

    toks = batch["tokens"]
    embeds = params["llm"]["embed"]["w"][toks].to(cfg.llm.dtype)
    if batch.get("patches") is None:
        return embeds
    features = grid_image_features(family_of(cfg).name)
    if features is not None:
        img, _ = features(cfg, params, batch["patches"], batch.get("grid"))
    else:
        feats, _ = vit_forward(cfg.vit, params["vit"], batch["patches"],
                               grid_hw=batch.get("grid_hw"))
        img, _ = merger_forward(cfg.merger, params["merger"], feats)
    return splice_image_embeds(embeds, toks, img, cfg.image_token_id)


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------


def _set_in(tree: Dict, path, value) -> Dict:
    out = dict(tree)
    out[path[0]] = value if len(path) == 1 else _set_in(tree[path[0]],
                                                        path[1:], value)
    return out


def _rtn_visual(params: Dict, specs: Dict[str, SiteSpec], q: QuantizeConfig,
                done: set) -> Dict:
    """Round-to-nearest for every vision tower / projector site with
    weight bits that is not in ``done`` (the GPTQ'd sites)."""
    from .core import quant as Q

    group_of = {"vis": "vit", "merger": "merger", "res": "res",
                "proj": "proj"}
    for name, spec in specs.items():
        prefix, site = name.split(".", 1)
        if prefix == "llm" or spec.w_bits is None or name in done:
            continue
        group_key = group_of[prefix]
        if group_key not in params:
            continue
        path = ((group_key, "blocks", site) if prefix == "vis"
                and site in VIT_SITES else (group_key, site))
        node = params
        for k in path[:-1]:
            node = node.get(k, {})
        src = node.get(path[-1])
        if not isinstance(src, dict) or src.get("w") is None:
            continue
        stacked = src["w"].ndim == 3
        new_site = dict(src)
        new_site["w"] = Q.rtn_fake_quant_weight(
            src["w"], spec.w_bits, mse_clip=q.w_clip, symmetric=not q.w_asym,
            reduce_axes=(-2,) if stacked else None).to(src["w"].dtype)
        params = _set_in(params, list(path), new_site)
    return params


def _gptq_visual(cfg, params: Dict, specs: Dict[str, SiteSpec],
                 q: QuantizeConfig, calib_batches: List[dict],
                 report: Dict) -> tuple:
    """Visual GPTQ, stage by stage: the patch embed on the raw patches,
    the ViT blocks on the quantized patch embed's output (after a CLIP
    tower's ln_pre and ``fc_sub_mean``), the merger (or the resampler, or
    mlp1 on the pixel-shuffled features, or the GLU projector) on the
    quantized tower's features. Returns (params, the GPTQ'd site names);
    ``report`` gets "fallbacks" and "sites"."""
    from .gptq import modules as GM
    from .gptq.driver import GPTQConfig, gptq_quantize_vit
    from .models.vision import vit_forward, vit_preamble

    gcfg = GPTQConfig(percdamp=q.percdamp, act_order=q.act_order,
                      group_size=q.w_groupsize, mse_clip=q.w_clip,
                      sym=not q.w_asym)
    report.update(fallbacks=[], sites=0)
    batches = _bound_nsamples(
        [b for b in calib_batches if b.get("patches") is not None],
        q.nsamples)
    done: set = set()
    if specs.get("vis.patch_embed") is not None:
        params, report = GM.gptq_quantize_patch_embed(
            cfg, params, [b["patches"].to(cfg.vit.dtype) for b in batches],
            specs, gcfg, report)
        done.add("vis.patch_embed")
    feats = [vit_preamble(cfg.vit, params["vit"], b["patches"])
             for b in batches]
    if feats:
        params = dict(params)
        params["vit"], vrep = gptq_quantize_vit(
            cfg.vit, params["vit"], feats, specs,
            grids=([b.get("grid_hw") for b in batches]
                   if cfg.vit.rotary_2d else None), gcfg=gcfg)
        report["fallbacks"] += vrep["fallbacks"]
        report["sites"] += vrep["sites"]
        done |= {f"vis.{s}" for s in VIT_SITES}
    del feats
    name = family_of(cfg).name
    group = {"qwen2vl": "merger", "qwenvl": "res"}.get(name, "proj")
    if group in params:
        tower = [vit_forward(cfg.vit, params["vit"], b["patches"],
                             grid_hw=b.get("grid_hw"))[0] for b in batches]
        if name == "glm4v":
            from .models.projectors import GLU_SITES

            params, report = GM.gptq_quantize_glu(
                cfg, params, [(t, *b["grid"]) for t, b in zip(tower,
                                                              batches)],
                specs, gcfg, report)
            done |= {f"proj.{s}" for s in GLU_SITES}
        elif name == "qwenvl":
            params, report = GM.gptq_quantize_resampler(cfg, params, tower,
                                                        specs, gcfg, report)
            done |= {f"res.{s}" for s in RES_SITES}
        elif name == "internvl":  # mlp1 on the pixel-shuffled features
            from .models.projectors import pixel_shuffle

            tower = [pixel_shuffle(t, *b["grid"])
                     for t, b in zip(tower, batches)]
            params, report = GM.gptq_quantize_mlp1(cfg, params, tower, specs,
                                                   gcfg, report)
            done |= {"proj.fc1", "proj.fc2"}
        else:
            params, report = GM.gptq_quantize_merger(cfg, params, tower,
                                                     specs, gcfg, report)
            done |= {"merger.mlp0", "merger.mlp2"}
    if report["fallbacks"]:
        log.warning(f"visual GPTQ RTN-fallbacks: {report['fallbacks']}")
    return params, done


def quantize_weights(cfg, params: Dict, specs: Dict[str, SiteSpec],
                     q: QuantizeConfig,
                     calib_batches: Optional[List[dict]] = None,
                     report: Optional[Dict] = None,
                     vis_report: Optional[Dict] = None) -> tuple:
    """Weight quantization: the vision tower, patch embed and projector by
    GPTQ (``visual_w_rtn`` off, with batches) or RTN, the LLM by GPTQ on
    the calibration batches' decoder inputs (RTN with ``llm_w_rtn`` or no
    batches), the head by per-channel RTN. Returns (params, the exact
    weight grids for realization); ``report`` receives the LLM GPTQ
    driver's report, ``vis_report`` the visual GPTQ's."""
    from .core import quant as Q
    from .core.formats import get_format

    params = dict(params)
    done: set = set()
    if (not q.visual_w_rtn and calib_batches
            and specs.get("vis.q", SiteSpec()).w_bits is not None
            and "vit" in params):
        params, done = _gptq_visual(cfg, params, specs, q, calib_batches,
                                    vis_report if vis_report is not None
                                    else {})
    params = _rtn_visual(params, specs, q, done)

    wqps = None
    if specs.get("llm.q", SiteSpec()).w_bits is None:
        return params, wqps
    if q.llm_w_rtn or calib_batches is None:
        from .transform.recipes import rtn_quantize_decoder

        params["llm"], wqps = rtn_quantize_decoder(
            cfg.llm, params["llm"], specs, mse_clip=q.w_clip,
            symmetric=not q.w_asym, return_qparams=True)
        return params, wqps
    from .gptq.driver import GPTQConfig, gptq_quantize_decoder

    embeds = [embed_batch(cfg, params, b)
              for b in _bound_nsamples(calib_batches, q.nsamples)]
    gcfg = GPTQConfig(percdamp=q.percdamp, act_order=q.act_order,
                      group_size=q.w_groupsize, mse_clip=q.w_clip,
                      sym=not q.w_asym)
    # arange RoPE positions for the image tokens too, as the JAX pipeline
    params["llm"], rep = gptq_quantize_decoder(cfg.llm, params["llm"], embeds,
                                               specs, gcfg=gcfg)
    del embeds
    if rep["fallbacks"]:
        log.warning(f"GPTQ RTN-fallbacks: {rep['fallbacks']}")
    if report is not None:
        report.update(rep)
    wqps = rep["qparams"]
    head_spec = specs.get("llm.lm_head")
    head = params["llm"].get("lm_head")
    if (head_spec is not None and head_spec.w_bits is not None
            and isinstance(head, dict) and head.get("w") is not None):
        fmt = get_format(head_spec.w_bits, signed=not q.w_asym)
        qp = Q.weight_qparams(head["w"], fmt, per_channel=True,
                              symmetric=not q.w_asym, mse_clip=q.w_clip)
        params["llm"] = {**params["llm"], "lm_head": {
            **head, "w": Q.fake_quantize(head["w"], qp, fmt).to(
                head["w"].dtype)}}
        out = head["w"].shape[-1]
        wqps = {**wqps, "lm_head": (
            qp.scale.reshape(1, out),
            None if qp.zero_point is None else qp.zero_point.reshape(1, out))}
    return params, wqps


def calibrate_activations(cfg, params: Dict, specs: Dict[str, SiteSpec],
                          calib_batches: List[dict],
                          decode_steps: int = 0) -> Dict:
    """Static activation calibration over the batches' multimodal forwards
    (mode "calib"); ``decode_steps`` > 0 also folds that many greedy decode
    steps per batch into the LLM sites' stats (after an uncounted prefill
    into a KV cache)."""
    from .calib.calibrate import calibrate, finalize_state, merge_stats
    from .models.llm import decoder_forward, init_cache

    def fwd(batch, collect_samples=False):
        logits, _, st = batch_forward(cfg, params, batch, specs=specs,
                                      mode="calib", collect_stats=True,
                                      collect_samples=collect_samples)
        return logits, st

    if not decode_steps:
        return calibrate(fwd, [(b,) for b in calib_batches], specs)

    needs_samples = any(s.observer in ("omse", "ptf") for s in specs.values())
    running = samples = None
    for i, b in enumerate(calib_batches):
        last = i == len(calib_batches) - 1
        _, (stats, smp) = fwd(b, collect_samples=last and needs_samples)
        running = merge_stats(specs, running, stats)
        if last and needs_samples:
            samples = smp
        embeds = embed_batch(cfg, params, b)
        B, T = b["tokens"].shape
        cache = init_cache(cfg.llm, B, T + decode_steps,
                           device=embeds.device)
        logits, cache, _ = decoder_forward(
            cfg.llm, params["llm"], embeds, specs=specs, mode="calib",
            cache=cache, prefill_fresh=True)
        tok = logits[:, -1:].argmax(dim=-1)
        for _ in range(decode_steps):
            logits, cache, st2 = decoder_forward(
                cfg.llm, params["llm"], tok, specs=specs, mode="calib",
                cache=cache, collect_stats=True)
            running = merge_stats(specs, running, st2[0])
            tok = logits[:, -1:].argmax(dim=-1)
    return finalize_state(specs, running or {}, samples)


def _choose_online_had_mode(cfg, params: Dict, batch: dict,
                            max_tokens: int = 128) -> tuple:
    """The calibration-time gate of ``online_had_mode="auto"``: the first
    ``max_tokens`` raw ``down`` inputs of each layer on one batch, scored
    for each candidate transform (full: the padded Kronecker Hadamard over
    the intermediate; block: I ⊗ H₁₂₈) by the error it leaves on the
    ``down`` output under the serving quantization: per-layer static
    per-tensor int8 activations × per-channel symmetric int4 weights with
    the transform folded in, ‖(xH)·q(HᵀW) − xW‖² over ‖xW‖², summed over
    the layers. Neither candidate dominates: spikes correlated within one
    128-block defeat block mode; a dense single block defeats the full
    transform. Returns (pick, {mode: error}).

    The products are f32 (TF32 must be off on the card). As in the JAX
    function, the full candidate pads the intermediate by
    ``auto_pad_size(I)`` zero columns (its size, not the difference), and
    divides by 127 and 7 as its jitted body does (times the reciprocals)."""
    from .core.quant import _over
    from .kernels.fwht import online_hadamard
    from .transform.hadamard import auto_pad_size

    assert not torch.backends.cuda.matmul.allow_tf32, (
        "the online-Hadamard gate needs f32 products: TF32 is on")
    probe = {"llm.down": SiteSpec(a_bits=8, a_static=True)}
    _, _, st = batch_forward(cfg, params, batch, specs=probe, mode="fake",
                             collect_stats=True, collect_samples=True)
    x_all = st[1]["llm.down"]  # (L, N, I) raw down inputs
    x_all = x_all[:, :max_tokens].float()
    I = x_all.shape[-1]
    w_all = params["llm"]["layers"]["down"]["w"]  # (L, I, H)
    pad = auto_pad_size(I)

    def q_err(xt, wt, y0):
        sa = _over(torch.clamp(xt.abs().max(), min=1e-8), 127.0, True)
        xq = torch.clamp(torch.round(xt / sa), -127, 127) * sa
        sw = _over(torch.clamp(wt.abs().amax(dim=0, keepdim=True),
                               min=1e-8), 7.0, True)
        wq = torch.clamp(torch.round(wt / sw), -7, 7) * sw
        return float(((xq @ wq - y0) ** 2).sum())

    sums: Dict[str, float] = {}
    ref_sum = 0.0
    for li in range(x_all.shape[0]):  # a layer at a time: f32 copies
        x, w = x_all[li], w_all[li].float()
        y0 = x @ w
        ref_sum += float((y0 * y0).sum())
        xf = torch.nn.functional.pad(x, (0, pad)) if pad else x
        wf = torch.nn.functional.pad(w, (0, 0, 0, pad)) if pad else w
        e = {"full": q_err(online_hadamard(xf), online_hadamard(wf.T).T, y0)}
        if I % 128 == 0:
            N, H = x.shape[0], w.shape[1]
            xb = online_hadamard(x.reshape(N, I // 128, 128)).reshape(N, I)
            wb = online_hadamard(
                w.T.reshape(H, I // 128, 128)).reshape(H, I).T
            e["block"] = q_err(xb, wb, y0)
        for k, v in e.items():
            sums[k] = sums.get(k, 0.0) + v
    errs = {k: v / max(ref_sum, 1e-12) for k, v in sums.items()}
    return min(errs, key=errs.get), errs


@contextlib.contextmanager
def _stage(info: Dict, name: str, device):
    """Record a stage's seconds (device synchronized at both ends) and, on
    the card, its peak allocated bytes in ``info["stages"][name]``."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    yield
    if cuda:
        torch.cuda.synchronize(dev)
    info.setdefault("stages", {})[name] = {
        "seconds": time.perf_counter() - t0,
        "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None}


# info keys that are reports, not rotation metadata (the artifact's
# meta["rotation"] string leaves them out; meta["autobits"] holds the bits)
_REPORT_KEYS = ("stages", "gptq", "vis_gptq", "autobits", "autobits_sens",
                "lm_head_ratios")


def head_spec(q: QuantizeConfig, bits: int) -> SiteSpec:
    """The lm_head's spec at ``bits`` (the LLM's activation settings)."""
    return SiteSpec(w_bits=bits, a_bits=q.llm_a_bits or None,
                    a_static=q.llm_static, a_symmetric=not q.a_asym,
                    a_per_channel=False if q.act_per_tensor else True,
                    observer=q.act_observer)


def run_pipeline(model: str, q: QuantizeConfig,
                 model_dir: Optional[str] = None,
                 params: Optional[Dict] = None, cfg=None,
                 calib_batches: Optional[List[dict]] = None,
                 calib_dataset: Optional[str] = None, tokenizer=None,
                 artifact_dir: Optional[str] = None, tiny: bool = False,
                 rotations: Optional[Dict[str, torch.Tensor]] = None,
                 image_size: int = 16, device="cuda"):
    """The full PTQ pipeline on ``device``. Without ``params`` the weights
    are the HF checkpoint in ``model_dir`` (``models.loader.load_model``,
    every leaf in ``cfg.llm.dtype``) or else random, drawn from ``q.seed``;
    without ``calib_batches``, the first ``q.calib_num`` rows of the eval
    dataset ``calib_dataset`` (a name or TSV path for
    ``evaluation.eval.build_dataset``) through a ``VLMRunner`` on the float
    params with ``tokenizer``, or else max(1, calib_num // 16) synthetic
    batches of ``image_size``² images. ``rotations`` ({"vit": Q_v, "llm":
    Q_l}) replaces the drawn rotations. The gates (smoothing's amax, the
    online-Hadamard pick, the head pick, the sensitivities) read the first
    calibration batch or, for smoothing, all of them.
    Returns (cfg, params, state, specs, info); ``info["stages"]`` holds
    each stage's seconds and peak bytes, ``info["gptq"]`` the LLM GPTQ
    driver's report, ``info["vis_gptq"]`` the visual GPTQ's; the gates add
    "smooth_alpha", "online_had_auto" ({"picked", "full", "block"}),
    "lm_head_bits" with "lm_head_ratios" ({4: ratio, 8: ratio}), and
    "autobits" (site → bits) with "autobits_sens" (site → sensitivity)."""
    fam = get_family(model)
    check_ported(q, fam.name)
    cfg = cfg or (fam.tiny_fn() if tiny else fam.config_fn())
    gen = torch.Generator().manual_seed(q.seed)
    info: Dict = {}

    if params is None and model_dir:
        from .models.loader import load_model

        with _stage(info, "load", device):
            params = load_model(fam.name, cfg, model_dir, dtype=cfg.llm.dtype,
                                device=device)
        log.info(f"loaded checkpoint from {model_dir}")
    elif params is None:
        with _stage(info, "init", device):
            params = fam.init_fn(cfg, gen, device=device)
        log.info("using random-initialized weights (no model_dir)")
    specs = build_specs(q, fam.subsystems)
    if calib_batches is None and calib_dataset:
        # real prompts through the serving input construction, built
        # before any transform (batch content does not depend on weights)
        from .evaluation.adapter import VLMRunner, calib_batches_from_dataset
        from .evaluation.eval import build_dataset

        with _stage(info, "calib_batches", device):
            runner = VLMRunner(fam.name, cfg, params, tokenizer=tokenizer)
            calib_batches = calib_batches_from_dataset(
                runner, build_dataset(calib_dataset), q.calib_num)
            del runner
        log.info(f"calibration prompts from {calib_dataset}: "
                 f"{len(calib_batches)} rows")
    if calib_batches is None:
        with _stage(info, "calib_batches", device):
            calib_batches = synthetic_calib_batches(
                cfg, max(1, q.calib_num // 16), gen,
                image_size=image_size, device=device)

    if q.smooth_alpha > 0:
        # migration precedes rotation (rotation mixes channels)
        from .transform.smooth import collect_llm_channel_amax, smooth_decoder

        with _stage(info, "smooth", device):
            amax = collect_llm_channel_amax(cfg, params, calib_batches)
            params = {**params, "llm": smooth_decoder(params["llm"], amax,
                                                      q.smooth_alpha)}
        info["smooth_alpha"] = q.smooth_alpha
        log.info(f"smoothquant migration applied (alpha={q.smooth_alpha})")

    if q.online_had_mode == "auto":
        # after smoothing, before the rotation folds the chosen H into down
        pick = "full"
        if q.rotate and q.rotate_llm and q.online_llm_hadamard:
            with _stage(info, "had_gate", device):
                pick, errs = _choose_online_had_mode(cfg, params,
                                                     calib_batches[0])
            info["online_had_auto"] = {"picked": pick, **errs}
            log.info(f"online-Hadamard auto-select: {pick} (int8 MSE "
                     f"{errs})")
        q = dataclasses.replace(q, online_had_mode=pick)
        specs = build_specs(q, fam.subsystems)

    if q.rotate:
        from .transform.vlm_recipes import prepare_vlm

        with _stage(info, "fuse_rotate", device):
            params, rinfo = prepare_vlm(
                fam.name, cfg, params, gen, rotate_visual=q.rotate_visual,
                rotate_llm=q.rotate_llm, mode=q.rotate_mode,
                online_had_down=q.online_llm_hadamard and q.rotate_llm,
                online_had_mode=q.online_had_mode,
                split_down=q.llm_split and q.rotate_llm,
                online_had_visual=q.online_visual_hadamard,
                split_visual=q.visual_split, rotations=rotations)
        info.update(rinfo)
        pad = getattr(info.get("llm"), "down_pad", 0)
        if pad:
            cfg = dataclasses.replace(
                cfg, llm=dataclasses.replace(cfg.llm, intermediate_pad=pad))
        log.info(f"fuse+rotate done: {info}")

    if q.lm_head_bits == "auto":
        # after rotation: the head is rotated
        from .utils.autobits import decide_head_bits

        with _stage(info, "head_gate", device):
            pick, ratios = decide_head_bits(cfg, params, specs,
                                            calib_batches[0],
                                            gate=q.lm_head_gate)
        specs["llm.lm_head"] = head_spec(q, pick)
        info["lm_head_bits"] = pick
        info["lm_head_ratios"] = ratios
        log.info("lm_head gate: W4 ppl ratio %.5f, int8 %.5f (gate %.4f) "
                 "→ %d-bit head", ratios[4], ratios[8], q.lm_head_gate, pick)

    if q.auto_bits > 0:
        # sensitivities of the transformed model; the returned specs drive
        # GPTQ, calibration and realization
        from .utils.autobits import (allocation_report, autobits_specs,
                                     site_weight_elems)

        with _stage(info, "autobits", device):
            specs, sens, bits = autobits_specs(
                cfg, params, specs, calib_batches[0], q.auto_bits,
                low=q.auto_bits_low, high=q.auto_bits_high)
        info["autobits"] = bits
        info["autobits_sens"] = sens
        log.info("auto-bits allocation (target avg %.2f):\n%s", q.auto_bits,
                 allocation_report(sens, site_weight_elems(params, specs),
                                   bits))

    info["gptq"], info["vis_gptq"] = {}, {}
    with _stage(info, "weights", device):
        params, wqps = quantize_weights(cfg, params, specs, q, calib_batches,
                                        report=info["gptq"],
                                        vis_report=info["vis_gptq"])
    log.info("weight quantization done")

    state = None
    if q.visual_static or q.llm_static:
        with _stage(info, "calibrate", device):
            state = calibrate_activations(cfg, params, specs, calib_batches,
                                          decode_steps=q.calib_decode_steps)
        log.info(f"activation calibration done ({len(state)} sites)")

    if q.realize_int:
        from .transform.recipes import realize_decoder_weights

        with _stage(info, "realize", device):
            params = {**params, "llm": realize_decoder_weights(
                params["llm"], specs, qps=wqps, state=state)}
        log.info("realized int weights for the LLM serving path")

    if artifact_dir:
        from .utils.checkpoint import config_to_dict, save_artifact

        meta = {"model": model, "config": str(cfg),
                "config_dict": config_to_dict(cfg),
                "quantize_config": dataclasses.asdict(q),
                "rotation": str({k: v for k, v in info.items()
                                 if k not in _REPORT_KEYS})}
        if "autobits" in info:
            meta["autobits"] = info["autobits"]
        with _stage(info, "save", device):
            info["artifact_bytes"] = save_artifact(artifact_dir, params,
                                                   state, specs, meta=meta)
        log.info(f"artifact saved to {artifact_dir}")
    return cfg, params, state, specs, info
