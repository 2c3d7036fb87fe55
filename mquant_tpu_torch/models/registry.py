"""Model registry (counterpart of ``mquant_tpu/models/registry.py``): the
Qwen2-VL and InternVL2 families. The JAX package's other families (GLM-4V:
ROADMAP A12b; Qwen-VL and MiniCPM-V: A12c) are not ported yet and raise."""

from __future__ import annotations

from typing import Any, Callable, NamedTuple


class ModelFamily(NamedTuple):
    name: str  # picks the chat template and the family's branches
    config_fn: Callable[[], Any]  # the preset a model name picks
    tiny_fn: Callable[[], Any]  # the CPU-testable miniature config
    # (cfg, torch.Generator, device=...) → random params: drawn on the
    # generator's device, placed on ``device`` (a CPU generator gives the
    # same values whichever device they end on)
    init_fn: Callable
    # (cfg, params, tokens, patches, **batch extras, specs=, state=, mode=,
    #  positions=, cache=, collect_stats=, collect_samples=)
    #  → (logits, cache, stats)
    forward_fn: Callable
    subsystems: tuple  # site prefixes, the LLM's last


_UNPORTED = (("qwenvl", "qwenvl", "A12c"), ("qwen-vl", "qwenvl", "A12c"),
             ("minicpm", "minicpmv", "A12c"), ("glm", "glm4v", "A12b"))


def get_family(name: str) -> ModelFamily:
    """The family of a model name (the JAX function's matching: case, "-"
    and "_" ignored; an unnamed size takes the family's default preset)."""
    key = name.lower().replace("-", "").replace("_", "")
    if "qwen2vl" in key:
        from .qwen2vl import (Qwen2VLConfig, init_qwen2vl_params,
                              qwen2vl_forward)

        presets = {"qwen2vl2b": Qwen2VLConfig.qwen2vl_2b,
                   "qwen2vl7b": Qwen2VLConfig.qwen2vl_7b,
                   "qwen2vl72b": Qwen2VLConfig.qwen2vl_72b}
        return ModelFamily("qwen2vl",
                           presets.get(key, Qwen2VLConfig.qwen2vl_7b),
                           Qwen2VLConfig.tiny, init_qwen2vl_params,
                           qwen2vl_forward, ("vis", "merger", "llm"))
    if "internvl" in key:
        from .internvl import (InternVLConfig, init_internvl_params,
                               internvl_forward)

        return ModelFamily("internvl", InternVLConfig.internvl2_8b,
                           InternVLConfig.tiny, init_internvl_params,
                           internvl_forward, ("vis", "proj", "llm"))
    for pat, fam, item in _UNPORTED:
        if pat in key:
            raise NotImplementedError(f"model family {fam} is not ported "
                                      f"(ROADMAP A12, {item})")
    raise ValueError(f"unknown model family {name!r}")


def family_of(cfg) -> ModelFamily:
    """The family of a model config, by its class."""
    from .internvl import InternVLConfig

    return get_family("internvl" if isinstance(cfg, InternVLConfig)
                      else "qwen2vl")
