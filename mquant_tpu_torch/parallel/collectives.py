"""The collectives of the tensor-parallel forward, over a mesh's process
groups (``parallel.sharding.Mesh``): sums and maxima across the tp row (or
the dp column, or the whole grid), gathers along the last axis, and the
broadcasts a server's ranks keep in step by.

One route on every backend: ``all_reduce`` and ``broadcast`` only, the two
collectives gloo takes on CUDA tensors. A gather is an ``all_reduce(SUM)``
of a zero-filled buffer in which each rank wrote its slice, exact (x + 0 is
x for every value but -0.0, which comes back +0.0). The CPU tests and the
card's two ranks run it on gloo. No run has yet had a card a rank, so NCCL
(``serve.server``'s ``--tp`` on cards) has never executed these calls.
Every rank of a group calls each collective in the same order, as
``torch.distributed`` requires.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from .sharding import Mesh


def _axis(mesh: Mesh, axis: str) -> Tuple[Any, int, int]:
    """(group, size, this rank's index) of one axis of the grid: "tp" (the
    row), "dp" (the column) or "all" (the whole grid, row-major)."""
    if axis == "tp":
        return mesh.tp_group, mesh.tp, mesh.tp_index
    if axis == "dp":
        return mesh.dp_group, mesh.dp, mesh.dp_index
    if axis == "all":
        return mesh.group, mesh.size, mesh.index
    raise ValueError(f"unknown mesh axis {axis!r}")


def all_reduce(t: torch.Tensor, mesh: Mesh, op: str = "sum",
               axis: str = "tp") -> torch.Tensor:
    """``t`` summed (``op`` "sum") or maximized ("max") across ``axis``, in
    place; returns it."""
    group, n, _ = _axis(mesh, axis)
    if n == 1:
        return t
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    dist.all_reduce(t, op=red, group=group)
    return t


def all_reduce_f32(t: torch.Tensor, mesh: Mesh, axis: str = "tp"
                   ) -> torch.Tensor:
    """A float partial summed across ``axis`` in f32, returned in its own
    dtype (the fp / fake row-parallel sites' reduce)."""
    s = t.float() if t.dtype != torch.float32 else t.clone()
    return all_reduce(s, mesh, "sum", axis).to(t.dtype)


def gather_last(t: torch.Tensor, mesh: Mesh, axis: str = "tp"
                ) -> torch.Tensor:
    """The ranks' slices (…, n) concatenated along the last axis in rank
    order: (…, size · n)."""
    group, size, i = _axis(mesh, axis)
    if size == 1:
        return t
    n = t.shape[-1]
    full = t.new_zeros((*t.shape[:-1], size * n))
    full[..., i * n:(i + 1) * n] = t
    dist.all_reduce(full, op=dist.ReduceOp.SUM, group=group)
    return full


def broadcast(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` of the tp row's first rank on every rank of the row, in place;
    returns it."""
    if mesh.tp > 1:
        dist.broadcast(t, src=mesh.tp_ranks[0], group=mesh.tp_group)
    return t


def broadcast_object(obj: Any, mesh: Optional[Mesh]) -> Any:
    """A picklable object of the tp row's first rank on every rank of the
    row (a server's tick: what rank 0's handlers received); ``obj`` itself
    without a mesh."""
    if mesh is None or mesh.tp == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=mesh.tp_ranks[0],
                               group=mesh.tp_group)
    return box[0]
