"""Device timing on one NVIDIA GPU, for the probes and ``chip_smoke.py``.

:func:`cuda_ms` captures a run of calls in one CUDA graph and replays it
between two CUDA events, so host launch cost is not counted. Every result
should be printed beside :func:`card_line` (name and power limit, as
``nvidia-smi`` prints them): a card set below its maximum power runs slower
under load.
"""

from __future__ import annotations

import statistics
import subprocess
from typing import Callable

import torch


def card_line() -> str:
    """The first card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn: Callable[[int], object], calls: int, reps: int = 5) -> float:
    """Device ms per call: ``fn(0) .. fn(calls - 1)`` captured in one CUDA
    graph and replayed between two CUDA events; the median over ``reps``
    replays. Two warm-up calls on a side stream come first (allocator,
    library handles, one-time kernel attributes)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(2):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i)
    graph.replay()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    return statistics.median(times)
