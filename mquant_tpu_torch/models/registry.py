"""Model registry (counterpart of ``mquant_tpu/models/registry.py``): the
Qwen2-VL, Qwen-VL, InternVL2 and GLM-4V families. The JAX package's other
family (MiniCPM-V: ROADMAP A12c) is not ported yet and raises."""

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


_UNPORTED = (("minicpm", "minicpmv", "A12c"),)


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
    if "qwenvl" in key:
        from .qwenvl import QwenVLConfig, init_qwenvl_params, qwenvl_forward

        return ModelFamily("qwenvl", QwenVLConfig.qwenvl_chat,
                           QwenVLConfig.tiny, init_qwenvl_params,
                           qwenvl_forward, ("vis", "res", "llm"))
    if "internvl" in key:
        from .internvl import (InternVLConfig, init_internvl_params,
                               internvl_forward)

        return ModelFamily("internvl", InternVLConfig.internvl2_8b,
                           InternVLConfig.tiny, init_internvl_params,
                           internvl_forward, ("vis", "proj", "llm"))
    if "glm" in key:
        from .glm4v import GLM4VConfig, glm4v_forward, init_glm4v_params

        return ModelFamily("glm4v", GLM4VConfig.glm4v_9b, GLM4VConfig.tiny,
                           init_glm4v_params, glm4v_forward,
                           ("vis", "proj", "llm"))
    for pat, fam, item in _UNPORTED:
        if pat in key:
            raise NotImplementedError(f"model family {fam} is not ported "
                                      f"(ROADMAP A12, {item})")
    raise ValueError(f"unknown model family {name!r}")


# the model names the port resolves: the JAX package's SUPPORTED_MODELS less
# the families that still raise
SUPPORTED_MODELS = ("Qwen-VL-Chat", "Qwen2-VL-2B", "Qwen2-VL-7B",
                    "Qwen2-VL-72B", "InternVL2-8B", "GLM-4V-9B")


def family_of(cfg) -> ModelFamily:
    """The family of a model config, by its class."""
    from .glm4v import GLM4VConfig
    from .internvl import InternVLConfig
    from .qwenvl import QwenVLConfig

    for cls, name in ((GLM4VConfig, "glm4v"), (InternVLConfig, "internvl"),
                      (QwenVLConfig, "qwenvl")):
        if isinstance(cfg, cls):
            return get_family(name)
    return get_family("qwen2vl")


def image_tokens(cfg, gh: int, gw: int) -> int:
    """Image tokens a (gh, gw) patch grid takes in the prompt of ``cfg``'s
    family: one per 2 × 2 patches, and GLM-4V's boi and eoi; Qwen-VL's
    resampler queries whatever the grid."""
    name = family_of(cfg).name
    if name == "qwenvl":
        return cfg.resampler.n_queries
    return (gh // 2) * (gw // 2) + (2 if name == "glm4v" else 0)


def grid_image_features(name: str):
    """The ``image_features`` of a family whose runner batches carry the
    patch ``grid`` (InternVL2, GLM-4V; Qwen-VL, which does not read it),
    or None (Qwen2-VL: ``grid_hw``)."""
    if name == "internvl":
        from .internvl import image_features
    elif name == "glm4v":
        from .glm4v import image_features
    elif name == "qwenvl":
        from .qwenvl import image_features
    else:
        return None
    return image_features
