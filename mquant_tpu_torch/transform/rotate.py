"""Offline orthogonal rotations folded into weights, QuaRot-style
(counterpart of ``mquant_tpu/transform/rotate.py``, the functions the
Qwen2-VL recipes use).

Pure float64 functions on weight tensors (w (…, in, out), y = x @ w + b,
Q orthogonal):

* rotating the hidden stream h → h @ Q: its producers fold Q on the output
  side (w' = w Q, b' = b Q), its consumers on the input side (w' = Qᵀ w);
* the per-head rotation of the V → O channel (:func:`rotate_ov_per_head`);
* the online Hadamard before ``down``: Hᵀ folded into ``down``'s input
  offline, H applied to the activation at run time.
"""

from __future__ import annotations

from typing import Optional

import torch


def _f64(x) -> torch.Tensor:
    return x.to(torch.float64)


def rotate_linear_input(linear: dict, Q: torch.Tensor) -> dict:
    """w' = Qᵀ w (a consumer of the rotated stream)."""
    new = dict(linear)
    new["w"] = torch.einsum("ij,...jo->...io", _f64(Q).T, _f64(linear["w"]))
    return new


def rotate_linear_output(linear: dict, Q: torch.Tensor) -> dict:
    """w' = w Q, b' = b Q (a producer of the rotated stream)."""
    new = dict(linear)
    new["w"] = _f64(linear["w"]) @ _f64(Q)
    if linear.get("b") is not None:
        new["b"] = _f64(linear["b"]) @ _f64(Q)
    return new


def rotate_embedding(embed_w: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """E' = E Q: the embedding rows live in the rotated stream."""
    return _f64(embed_w) @ _f64(Q)


def rotate_ov_per_head(v_proj: dict, o_proj: dict, head_dim: int,
                       Q_head: torch.Tensor,
                       n_kv_heads: Optional[int] = None,
                       n_heads: Optional[int] = None) -> tuple:
    """Per-head rotation of the V → O channel: each of v's n_kv_heads output
    blocks is rotated by Q_head on the output side, each of o's n_heads
    input blocks on the input side (GQA commutes with it)."""
    Qh = _f64(Q_head)
    wv = _f64(v_proj["w"])
    *lead, fin, fout = wv.shape
    kvh = (fout // head_dim) if n_kv_heads is None else n_kv_heads
    new_v = dict(v_proj)
    new_v["w"] = (wv.reshape(*lead, fin, kvh, head_dim) @ Qh).reshape(
        *lead, fin, fout)
    if v_proj.get("b") is not None:
        bv = _f64(v_proj["b"]).reshape(*lead, kvh, head_dim) @ Qh
        new_v["b"] = bv.reshape(*lead, fout)
    wo = _f64(o_proj["w"])
    *lead, fin, fout = wo.shape
    h = (fin // head_dim) if n_heads is None else n_heads
    wo = torch.einsum("ij,...hjo->...hio", Qh.T,
                      wo.reshape(*lead, h, head_dim, fout))
    new_o = dict(o_proj)
    new_o["w"] = wo.reshape(*lead, fin, fout)
    return new_v, new_o


def pad_linear_input(linear: dict, new_in: int) -> dict:
    """Zero-pad a linear's input dim (``down`` padded to a
    Hadamard-friendly size)."""
    w = _f64(linear["w"])
    if new_in < w.shape[-2]:
        raise ValueError(f"cannot pad {w.shape[-2]} rows to {new_in}")
    new = dict(linear)
    new["w"] = torch.nn.functional.pad(w, (0, 0, 0, new_in - w.shape[-2]))
    return new


def pad_linear_output(linear: dict, new_out: int) -> dict:
    """Zero-pad a linear's output dim (the matching gate / up pad)."""
    w = _f64(linear["w"])
    if new_out < w.shape[-1]:
        raise ValueError(f"cannot pad {w.shape[-1]} columns to {new_out}")
    new = dict(linear)
    new["w"] = torch.nn.functional.pad(w, (0, new_out - w.shape[-1]))
    if linear.get("b") is not None:
        b = _f64(linear["b"])
        new["b"] = torch.nn.functional.pad(b, (0, new_out - b.shape[-1]))
    return new


def fold_exact_hadamard_input(linear: dict, M: torch.Tensor) -> dict:
    """w' = M w: the run-time ``online_hadamard(x)`` computes x Mᵀ
    (M = ``transform_matrix(n)``), and (x Mᵀ)(M w) = x w."""
    return rotate_linear_input(linear, _f64(M).T)


def fold_exact_hadamard_input_block(linear: dict, block: int) -> dict:
    """w' = H w on each ``block``-wide slice of the input dim: the partner
    of the run-time block Hadamard (I_{n/block} ⊗ H_block)."""
    from .hadamard import transform_matrix

    w = _f64(linear["w"])
    Hb = torch.from_numpy(transform_matrix(block)).to(w.device)
    *lead, fin, fout = w.shape
    if fin % block:
        raise ValueError(f"input dim {fin} is no multiple of {block}")
    wr = torch.einsum("ij,...kjo->...kio", Hb,
                      w.reshape(*lead, fin // block, block, fout))
    new = dict(linear)
    new["w"] = wr.reshape(*lead, fin, fout)
    return new
