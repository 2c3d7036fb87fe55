"""Runtime utilities (counterpart of ``mquant_tpu/utils/misc.py``):
seeding, logging, device memory reports, profiling and a step timer."""

from __future__ import annotations

import contextlib
import gc
import logging
import os
import random
import time
from typing import Optional

import numpy as np
import torch


def seed_everything(seed: int = 0) -> torch.Generator:
    """Seed python, numpy and torch; returns a torch.Generator on the host
    seeded with ``seed`` (the port's randomness takes explicit
    generators)."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def config_logging(log_file: Optional[str] = None,
                   level=logging.INFO) -> logging.Logger:
    """File and console logging in one line format."""
    handlers = [logging.StreamHandler()]
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        handlers.append(logging.FileHandler(log_file))
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s",
        handlers=handlers, force=True)
    return logging.getLogger("mquant_tpu_torch")


def device_memory_stats() -> dict:
    """Allocated and peak allocated bytes per CUDA device
    (``torch.cuda.memory_stats``); empty without a card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0)}
    return out


def cleanup_memory(logger: Optional[logging.Logger] = None) -> dict:
    """Collect garbage and release the caching allocator's free blocks;
    logs each device's allocated bytes before and after."""
    before = device_memory_stats()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    after = device_memory_stats()
    if logger:
        for d in before:
            b = before[d].get("bytes_in_use", 0)
            a = after[d].get("bytes_in_use", 0)
            logger.info(f"cleanup_memory {d}: {b / 2**30:.2f} → "
                        f"{a / 2**30:.2f} GiB")
    return after


@contextlib.contextmanager
def profile_trace(log_dir: str = "mquant_trace"):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA where there
    is a card), written as a Chrome trace into ``log_dir``; yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Timer:
    """Named wall-clock segments; ``sync`` (a tensor or a device)
    synchronizes its CUDA device before the segment's end is read."""

    def __init__(self):
        self.times = {}

    @contextlib.contextmanager
    def __call__(self, name: str, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            dev = sync.device if isinstance(sync, torch.Tensor) else \
                torch.device(sync)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def report(self) -> str:
        rows = []
        for k, v in self.times.items():
            rows.append(f"{k}: n={len(v)} "
                        f"median={sorted(v)[len(v) // 2] * 1e3:.1f}ms")
        return "; ".join(rows)
