"""Equivalent transforms: LayerNorm → RMSNorm fusion and mean-baking
(counterpart of ``mquant_tpu/transform/fuse.py``, the functions the
Qwen2-VL recipes use).

Pure functions on weight tensors in float64 (on the tensors' device).
Linears store ``w`` (…, in, out) and an optional ``b`` (…, out); forward
``y = x @ w + b``; leading stacked-layer axes are allowed. The algebra is
exact: LN(x; γ, β) @ W + b == RMSNorm_unit(x) @ (γ[:, None] · W) + (β @ W + b)
when x is zero-mean, which centering its producers
(:func:`center_linear_output`) arranges.
"""

from __future__ import annotations

from typing import Optional

import torch


def _f64(x) -> torch.Tensor:
    return x.to(torch.float64)


def fold_norm_into_linears(norm_w: torch.Tensor,
                           norm_b: Optional[torch.Tensor], linears: list
                           ) -> tuple:
    """Fold a norm's affine (γ, β) into the linears it feeds. Returns
    (ones like γ, None, new linears)."""
    g = _f64(norm_w)
    out = []
    for lin in linears:
        w = _f64(lin["w"])
        new = dict(lin)
        new["w"] = w * g[..., :, None]  # scale input rows by γ
        if norm_b is not None:
            contrib = torch.einsum("...i,...io->...o", _f64(norm_b), w)
            b = _f64(lin["b"]) if lin.get("b") is not None else 0.0
            new["b"] = b + contrib
        out.append(new)
    return torch.ones_like(g), None, out


def fold_norm_into_linears_blockdiag(norm_w: torch.Tensor,
                                     norm_b: Optional[torch.Tensor],
                                     linear: dict, repeats: int) -> tuple:
    """The block-diagonal fold for a linear whose input is ``repeats``
    concatenated copies of the normed vector (the Qwen2-VL merger's ln_q →
    mlp0)."""
    g = _f64(norm_w).repeat(repeats)
    w = _f64(linear["w"])
    new = dict(linear)
    new["w"] = w * g[:, None]
    if norm_b is not None:
        beta = _f64(norm_b).repeat(repeats)
        b = _f64(linear["b"]) if linear.get("b") is not None else 0.0
        new["b"] = b + beta @ w
    return torch.ones_like(_f64(norm_w)), None, new


def center_linear_output(linear: dict) -> dict:
    """Make a linear's outputs exactly zero-mean (W minus its mean over the
    out axis, b minus its mean), so that a LayerNorm downstream reduces to
    an RMSNorm."""
    w = _f64(linear["w"])
    new = dict(linear)
    new["w"] = w - w.mean(dim=-1, keepdim=True)
    if linear.get("b") is not None:
        b = _f64(linear["b"])
        new["b"] = b - b.mean()
    return new


def center_embedding(embed_w: torch.Tensor) -> torch.Tensor:
    """Each embedding row minus its mean: a position table added to a
    centered stream keeps it zero-mean."""
    e = _f64(embed_w)
    return e - e.mean(dim=-1, keepdim=True)


def sub_mean_matrix(n: int, device="cpu") -> torch.Tensor:
    """The (I − 11ᵀ/n) centering projection as an explicit float64 matrix,
    for a site where centering cannot be folded upstream (Qwen-VL's ln_pre
    → ``fc_sub_mean``)."""
    return (torch.eye(n, dtype=torch.float64, device=device)
            - torch.ones((n, n), dtype=torch.float64, device=device) / n)
