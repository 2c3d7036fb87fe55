"""Model registry (counterpart of ``mquant_tpu/models/registry.py``): the
Qwen2-VL family. The JAX package's other families (Qwen-VL, InternVL2,
MiniCPM-V, GLM-4V) are not ported yet (ROADMAP A12) and raise."""

from __future__ import annotations

from typing import Any, Callable, NamedTuple


class ModelFamily(NamedTuple):
    name: str  # picks the chat template
    tiny_fn: Callable[[], Any]  # the CPU-testable miniature config
    init_fn: Callable  # (cfg, torch.Generator, device=...) → random params


_UNPORTED = (("qwenvl", "qwenvl"), ("qwen-vl", "qwenvl"),
             ("internvl", "internvl"), ("minicpm", "minicpmv"),
             ("glm", "glm4v"))


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree if tree is None else tree.to(device)


def _init_qwen2vl(cfg, gen, device="cuda"):
    """Random params drawn from ``gen`` on its device (a CPU generator
    gives the same values for every device), then moved to ``device``."""
    from .qwen2vl import init_qwen2vl_params

    return _to(init_qwen2vl_params(cfg, gen, device=gen.device), device)


def get_family(name: str) -> ModelFamily:
    """The family of a model name (the JAX function's matching: case, "-"
    and "_" ignored)."""
    key = name.lower().replace("-", "").replace("_", "")
    if "qwen2vl" in key:
        from .qwen2vl import Qwen2VLConfig

        return ModelFamily("qwen2vl", Qwen2VLConfig.tiny, _init_qwen2vl)
    for pat, fam in _UNPORTED:
        if pat in key:
            raise NotImplementedError(f"model family {fam} is not ported "
                                      "(ROADMAP A12)")
    raise ValueError(f"unknown model family {name!r}")
