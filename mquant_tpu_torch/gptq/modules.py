"""GPTQ for the cross-modal modules (the Qwen2-VL merger, Qwen-VL's
resampler, InternVL2's mlp1, GLM-4V's GLU projector) and the patch embed
(counterpart of ``mquant_tpu/gptq/modules.py``).

A module's inputs are captured by its own forward: a "capture spec" (weight
bits off, activation bits set and static, no finalized state) makes every
``qlinear`` of the stage record its input as the quantizer would see it
(after the online Hadamard and the RMS split) while quantizing nothing.
Stages run in dependency order, each capture re-running the forward with
the stages before it already quantized. The patch embed is a linear over
flattened patch pixels, so its Hessian is over the raw patches.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..models.layers import SiteSpec
from . import core as C
from .driver import GPTQConfig


def _capture_specs(specs: Dict[str, SiteSpec], sites: Sequence[str]) -> Dict:
    """Specs that make ``qlinear`` record the input of ``sites`` while
    quantizing nothing (a static activation spec without state passes
    through); the other sites keep their transforms only."""
    out = {}
    for name, sp in (specs or {}).items():
        if name in sites:
            out[name] = dataclasses.replace(sp, a_bits=sp.a_bits or 8,
                                            a_static=True, out_bits=None)
        else:
            out[name] = dataclasses.replace(sp, a_bits=None, a_static=False,
                                            out_bits=None)
    return out


def _get_path(tree: Dict, path: Tuple[str, ...]):
    node = tree
    for k in path:
        node = node[k]
    return node


def _set_path(tree: Dict, path: Tuple[str, ...], value) -> Dict:
    out = dict(tree)
    out[path[0]] = (value if len(path) == 1
                    else _set_path(tree[path[0]], path[1:], value))
    return out


def gptq_quantize_module(params: Dict,
                         run_capture: Callable[[Dict, Dict, object],
                                               Dict[str, torch.Tensor]],
                         batches: List, stages: Sequence[Sequence[str]],
                         path_of: Dict[str, Tuple[str, ...]],
                         specs: Dict[str, SiteSpec],
                         gcfg: GPTQConfig = GPTQConfig(),
                         report: Optional[Dict] = None) -> tuple:
    """Stage-sequential GPTQ over one module. ``run_capture(params,
    capture_specs, batch)`` runs its forward in mode "calib" and returns
    the recorded inputs {site: (N, C)}; ``stages`` lists the site groups in
    dependency order; ``path_of`` maps a site to its params path. Returns
    (params, report) with "fallbacks" and "sites"."""
    report = report if report is not None else {"fallbacks": [], "sites": 0}
    for stage_sites in stages:
        active = [s for s in stage_sites
                  if specs.get(s) is not None and specs[s].w_bits is not None
                  and s in path_of]
        if not active:
            continue
        cspecs = _capture_specs(specs, active)
        Hs: Dict[str, Optional[torch.Tensor]] = {s: None for s in active}
        for b in batches:
            samples = run_capture(params, cspecs, b)
            for s in active:
                if s in samples:
                    Hs[s] = C.accumulate_hessian(Hs[s], samples[s])
        for s in active:
            if Hs[s] is None:
                continue
            site_p = dict(_get_path(params, path_of[s]))
            if site_p.get("w") is None:
                continue
            res = C.gptq_quantize_matrix(
                site_p["w"].float(), Hs[s], bits=specs[s].w_bits,
                percdamp=gcfg.percdamp, act_order=gcfg.act_order,
                group_size=gcfg.group_size, mse_clip=gcfg.mse_clip,
                sym=gcfg.sym)
            site_p["w"] = res.w.to(site_p["w"].dtype)
            params = _set_path(params, path_of[s], site_p)
            report["sites"] += 1
            if bool(res.used_fallback):
                report["fallbacks"].append(s)
    return params, report


def _samples_from(st) -> Dict[str, torch.Tensor]:
    return {} if st is None else st[1]


def gptq_quantize_merger(cfg, params: Dict, feat_batches: List[torch.Tensor],
                         specs: Dict[str, SiteSpec], gcfg=GPTQConfig(),
                         report=None) -> tuple:
    """The Qwen2-VL merger, [mlp0] → [mlp2], on the quantized tower's
    features."""
    from ..models.vision import merger_forward

    def cap(p, cspecs, feats):
        _, st = merger_forward(cfg.merger, p["merger"], feats, specs=cspecs,
                               mode="calib", collect_stats=True,
                               collect_samples=True)
        return _samples_from(st)

    stages = [["merger.mlp0"], ["merger.mlp2"]]
    paths = {"merger.mlp0": ("merger", "mlp0"),
             "merger.mlp2": ("merger", "mlp2")}
    return gptq_quantize_module(params, cap, feat_batches, stages, paths,
                                specs, gcfg, report)


def gptq_quantize_resampler(cfg, params: Dict,
                            feat_batches: List[torch.Tensor],
                            specs: Dict[str, SiteSpec], gcfg=GPTQConfig(),
                            report=None) -> tuple:
    """Qwen-VL's resampler (``attn_pool``), [kv_proj] → [k, v, q] → [out]
    → [proj_fc], on the quantized tower's features."""
    from ..models.resampler import RES_SITES, resampler_forward

    def cap(p, cspecs, feats):
        _, st = resampler_forward(cfg.resampler, p["res"], feats,
                                  specs=cspecs, mode="calib",
                                  collect_stats=True, collect_samples=True)
        return _samples_from(st)

    stages = [["res.kv_proj"], ["res.k", "res.v", "res.q"], ["res.out"],
              ["res.proj_fc"]]
    paths = {f"res.{s}": ("res", s) for s in RES_SITES}
    return gptq_quantize_module(params, cap, feat_batches, stages, paths,
                                specs, gcfg, report)


def gptq_quantize_mlp1(cfg, params: Dict,
                       shuffled_batches: List[torch.Tensor],
                       specs: Dict[str, SiteSpec], gcfg=GPTQConfig(),
                       report=None) -> tuple:
    """InternVL's mlp1, [fc1] → [fc2], on the quantized tower's
    pixel-shuffled features."""
    from ..models.projectors import mlp1_forward

    def cap(p, cspecs, x):
        _, st = mlp1_forward(cfg.mlp1, p["proj"], x, specs=cspecs,
                             mode="calib", collect_stats=True,
                             collect_samples=True)
        return _samples_from(st)

    stages = [["proj.fc1"], ["proj.fc2"]]
    paths = {"proj.fc1": ("proj", "fc1"), "proj.fc2": ("proj", "fc2")}
    return gptq_quantize_module(params, cap, shuffled_batches, stages, paths,
                                specs, gcfg, report)


def gptq_quantize_glu(cfg, params: Dict, feat_batches: List[tuple],
                      specs: Dict[str, SiteSpec], gcfg=GPTQConfig(),
                      report=None) -> tuple:
    """GLM-4V's GLU projector, [conv] → [linear_proj] → [gate, h_to_4h] →
    [4h_to_h], on the quantized tower's features: ``feat_batches`` holds
    (features, gh, gw) tuples."""
    from ..models.projectors import GLU_SITES, glu_projector_forward

    def cap(p, cspecs, b):
        feats, gh, gw = b
        _, st = glu_projector_forward(cfg.proj, p["proj"], feats, gh, gw,
                                      specs=cspecs, mode="calib",
                                      collect_stats=True,
                                      collect_samples=True)
        return _samples_from(st)

    stages = [["proj.conv"], ["proj.linear_proj"],
              ["proj.gate", "proj.h_to_4h"], ["proj.4h_to_h"]]
    paths = {f"proj.{s}": ("proj", s) for s in GLU_SITES}
    return gptq_quantize_module(params, cap, feat_batches, stages, paths,
                                specs, gcfg, report)


def gptq_quantize_patch_embed(cfg, params: Dict,
                              patch_batches: List[torch.Tensor],
                              specs: Dict[str, SiteSpec], gcfg=GPTQConfig(),
                              report=None, prefix: str = "vis") -> tuple:
    """The patch embed, its Hessian over the raw flattened patch pixels
    (``patch_batches`` in the tower's dtype)."""
    name = f"{prefix}.patch_embed"

    def cap(p, cspecs, patches):
        return {name: patches.reshape(-1, patches.shape[-1])}

    return gptq_quantize_module(params, cap, patch_batches, [[name]],
                                {name: ("vit", "patch_embed")}, specs, gcfg,
                                report)
