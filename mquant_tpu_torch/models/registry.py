"""Model registry (counterpart of ``mquant_tpu/models/registry.py``): the
Qwen2-VL family. The JAX package's other families (Qwen-VL, InternVL2,
MiniCPM-V, GLM-4V) are not ported yet (ROADMAP A12) and raise."""

from __future__ import annotations

from typing import NamedTuple


class ModelFamily(NamedTuple):
    name: str  # picks the chat template


_UNPORTED = (("qwenvl", "qwenvl"), ("qwen-vl", "qwenvl"),
             ("internvl", "internvl"), ("minicpm", "minicpmv"),
             ("glm", "glm4v"))


def get_family(name: str) -> ModelFamily:
    """The family of a model name (the JAX function's matching: case, "-"
    and "_" ignored)."""
    key = name.lower().replace("-", "").replace("_", "")
    if "qwen2vl" in key:
        return ModelFamily("qwen2vl")
    for pat, fam in _UNPORTED:
        if pat in key:
            raise NotImplementedError(f"model family {fam} is not ported "
                                      "(ROADMAP A12)")
    raise ValueError(f"unknown model family {name!r}")
