"""Multi-GPU offline GPTQ (counterpart of ``mquant_tpu/gptq/sharded.py``):
the Hessian accumulated over the dp ranks' calibration rows, and a walk with
the weight's out axis split over the whole mesh.

* :func:`hessian_dp`: each dp rank's ``2 XᵀX`` over its own rows, summed by
  one ``all_reduce(SUM)`` across the dp column: every rank ends with the
  whole Hessian (JAX lets XLA insert the psum; f32 sums in another order).
* :func:`gptq_matrix_sharded`: the row walk is sequential over INPUT rows,
  but every OUTPUT column is independent given H, so W (in, out) splits its
  out axis over every rank of the grid (dp and tp together; the offline
  stage has no data axis to keep) while H, the act_order permutation and
  U = chol(H⁻¹) are each rank's own copy of the same computation. Each rank
  walks its columns with ``gptq.core``'s walk, and the codes, scales and
  zero points are gathered, so the result equals the single-rank walk on
  the same H, column for column.
* :func:`realize_sharded`: ``kernels.qmm.quantize_weights_real`` on each
  rank's columns, gathered (the packed W4 bytes pack each column apart).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import quant as Q
from ..core.formats import get_format
from ..parallel import collectives as PC
from ..parallel.sharding import Mesh
from . import core as C

__all__ = ["hessian_dp", "gptq_matrix_sharded", "walk_sharded",
           "realize_sharded"]


def hessian_dp(x: torch.Tensor, mesh: Mesh, axis: str = "dp"
               ) -> torch.Tensor:
    """``2 XᵀX`` of this rank's calibration rows x (..., in) (its
    ``parallel.sharding.shard_batch`` share) summed over ``axis``: the
    whole Hessian on every rank. Chunked accumulation composes: call per
    chunk and add."""
    return PC.all_reduce(C.accumulate_hessian(None, x), mesh, "sum", axis)


def _columns(n: int, mesh: Mesh):
    if n % mesh.size:
        raise ValueError(f"out = {n} is not divisible by the mesh's "
                         f"{mesh.size} ranks")
    k = n // mesh.size
    return mesh.index * k, (mesh.index + 1) * k


def gptq_matrix_sharded(W: torch.Tensor, H: torch.Tensor, mesh: Mesh,
                        bits: int, percdamp: float = 0.01,
                        act_order: bool = False,
                        group_size: Optional[int] = None,
                        mse_clip: bool = False, sym: bool = True
                        ) -> C.GPTQResult:
    """``gptq.core.gptq_quantize_matrix`` with W (in, out, every rank's
    copy) walked by column shards over the whole mesh and gathered back
    (:func:`walk_sharded`): the act_order permutation and U = chol(H⁻¹) are
    each rank's own copy of the same computation on the same H."""
    if act_order:  # most salient inputs first
        perm = torch.argsort(-torch.diagonal(H), stable=True)
        Hp = H[perm][:, perm]
    else:
        perm, Hp = None, H
    U = C._hinv_cholesky(Hp, percdamp)
    return walk_sharded(W, torch.diagonal(Hp), U, perm, mesh, bits,
                        group_size, mse_clip, sym)


def walk_sharded(W: torch.Tensor, diag: torch.Tensor, U: torch.Tensor,
                 perm: Optional[torch.Tensor], mesh: Mesh, bits: int,
                 group_size: Optional[int] = None, mse_clip: bool = False,
                 sym: bool = True) -> C.GPTQResult:
    """``gptq.core._gptq_walk`` (the walk given the permuted Hessian's
    diagonal and U) on this rank's columns of W, the fake-quantized weight,
    the scales and zero points gathered whole on every rank. The RTN
    fallback, whole-matrix in the single-rank walk, is taken by every rank
    where any rank's walk is not finite."""
    lo, hi = _columns(W.shape[1], mesh)
    Wl = W[:, lo:hi]
    res = C._gptq_walk(Wl, diag, U, perm, bits=bits, group_size=group_size,
                       mse_clip=mse_clip, sym=sym)
    bad = res.used_fallback.reshape(1).to(torch.int32)
    bad_any = bool(PC.all_reduce(bad, mesh, "max", "all").item())
    w, scale, zero = res.w, res.scale, res.zero
    if bad_any and not bool(res.used_fallback):
        fmt = get_format(bits, signed=sym)
        qp = Q.weight_qparams(Wl.float(), fmt, per_channel=True,
                              symmetric=sym, mse_clip=mse_clip, recip=True)
        w = Q.fake_quantize(Wl.float(), qp, fmt).to(W.dtype)
        g = scale.shape[0]
        scale = qp.scale.reshape(1, -1).expand(g, -1)
        if zero is not None:
            zero = qp.zero_point.reshape(1, -1).expand(g, -1)

    def gather(t):
        return PC.gather_last(t.contiguous(), mesh, "all")

    return C.GPTQResult(
        w=gather(w), scale=gather(scale),
        used_fallback=torch.tensor(bad_any, device=W.device),
        zero=None if zero is None else gather(zero), perm=perm)


def realize_sharded(W: torch.Tensor, bits: int, mesh: Mesh,
                    pack: bool = True, scale: Optional[torch.Tensor] = None,
                    zero: Optional[torch.Tensor] = None) -> dict:
    """``quantize_weights_real(W, bits, pack, scale, zero)`` with W's (and
    the grid's) out axis split over the whole mesh, each rank realizing its
    columns; the storage comes back whole on every rank."""
    from ..kernels.qmm import quantize_weights_real

    lo, hi = _columns(W.shape[1], mesh)
    part = quantize_weights_real(
        W[:, lo:hi], bits, pack=pack,
        scale=None if scale is None else scale[..., lo:hi],
        zero=None if zero is None else zero[..., lo:hi])
    return {k: PC.gather_last(v.contiguous(), mesh, "all")
            for k, v in part.items()}
