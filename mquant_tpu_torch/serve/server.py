"""The deploy path (counterpart of ``mquant_tpu/serve/server.py``'s
``build_runner_from_artifact``): an artifact directory, written by the JAX
pipeline or by ``utils.checkpoint.save_artifact``, loaded as a ready
``VLMRunner``. The HTTP server and the continuous-batching engine behind it
are not ported yet (ROADMAP A11)."""

from __future__ import annotations

from typing import Optional


def build_runner_from_artifact(artifact_dir: str, mode: Optional[str] = None,
                               tokenizer=None, max_len: int = 512,
                               device="cuda",
                               image_size: Optional[int] = None):
    """Artifact → ``VLMRunner`` on ``device`` (the card unless the caller
    asks for another). ``mode`` defaults to "real" where the pipeline
    realized int storage (its ``quantize_config.realize_int``), else
    "fake". ``image_size`` is the runner's base bucket side (default 4
    patches)."""
    from ..evaluation.adapter import VLMRunner
    from ..utils.checkpoint import config_from_dict, load_artifact

    params, state, specs, meta = load_artifact(artifact_dir, device=device)
    if "config_dict" not in meta:
        raise ValueError(f"artifact at {artifact_dir} predates config_dict "
                         "meta; re-export with run_pipeline")
    cfg = config_from_dict(meta["config_dict"])
    if mode is None:
        mode = ("real" if (meta.get("quantize_config") or {}).get(
            "realize_int") else "fake")
    return VLMRunner(meta["model"], cfg, params, specs=specs, state=state,
                     mode=mode, tokenizer=tokenizer, max_len=max_len,
                     image_size=image_size)
