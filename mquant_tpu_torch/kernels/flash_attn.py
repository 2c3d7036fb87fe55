"""Causal flash attention for long prefills (counterpart of the library
Pallas kernel ``jax.experimental.pallas.ops.tpu.flash_attention`` that
``mquant_tpu/models/layers.py::attention`` calls for causal prefill with
T == S ≥ 2048).

:func:`flash_attention_causal` launches the hand-written CUDA kernel
``mq_flash_attn_causal`` (``csrc/attn.cu``: TMA loads through an mbarrier
ring, wgmma bf16 products, online f32 softmax, the (T, T) scores never in
device memory) for a CUDA tensor inside its contract (:func:`supports`), or
raises; :func:`flash_attention_causal_ref` is its plain version, the port's
f32 GQA einsum, taken only for a CPU tensor. GQA is native: query head h
reads KV head h // (H / KVH), and K/V are never repeated (the JAX call
repeats them). ``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

from typing import Dict

import torch

# kernel launches (read and reset by chip_smoke.py)
LAUNCHES: Dict[str, int] = {"flash_attn_causal": 0}

HEAD_DIM = 128  # the kernel's head width
BLOCK_T = 64  # T must be a multiple (the kernel's 128-row tiles zero-fill)


def _check_shapes(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError("flash_attention_causal: q (B, T, H, hd), k / v "
                         "(B, T, KVH, hd)")
    B, T, H, hd = q.shape
    if k.shape[0] != B or k.shape[1] != T or k.shape[3] != hd or \
            H % k.shape[2]:
        raise ValueError(f"flash_attention_causal: k {tuple(k.shape)} does "
                         f"not match q {tuple(q.shape)}")
    return B, T, H, hd, k.shape[2]


def flash_attention_causal_ref(q, k, v, scale: float):
    """Plain version of :func:`flash_attention_causal`: the f32-softmax GQA
    einsum of ``models.layers`` with the causal mask."""
    from ..models.layers import einsum_attention

    _check_shapes(q, k, v)
    return einsum_attention(q, k, v, None, scale, causal=True)


def supports(hd: int, dtype: torch.dtype, T: int) -> bool:
    """The kernel's contract: head_dim 128, bf16, T a positive multiple of
    ``BLOCK_T``. The wrapper raises on a CUDA tensor outside it, and
    ``models.layers.attention`` routes by it."""
    return hd == HEAD_DIM and dtype == torch.bfloat16 and T > 0 and \
        T % BLOCK_T == 0


def _check_card(q, k, v) -> None:
    """Raises unless the kernel takes these operands: :func:`supports`, one
    dtype, contiguous, one device."""
    name = "flash_attn_causal"
    B, T, H, hd, KVH = _check_shapes(q, k, v)
    if len({t.dtype for t in (q, k, v)}) != 1 or not supports(hd, q.dtype, T):
        raise ValueError(f"{name}: needs bf16 q, k, v, head_dim == "
                         f"{HEAD_DIM} and T % {BLOCK_T} == 0, got {q.dtype}, "
                         f"{hd}, {T}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError(f"{name}: operands must be contiguous and 16-byte "
                         "aligned (TMA)")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError(f"{name}: tensors on several devices")


def flash_attention_causal(q, k, v, scale: float):
    """out (B, T, H, hd) = softmax(q·kᵀ·scale, causal)·v in q's dtype for
    q (B, T, H, hd), k / v (B, T, KVH, hd). On CUDA: :func:`supports`,
    contiguous operands."""
    name = "flash_attn_causal"
    B, T, H, hd, KVH = _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_causal_ref(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    _check_card(q, k, v)
    out = torch.empty_like(q)
    from ._build import load

    lib = load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = lib.mq_flash_attn_causal(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, H,
        KVH, float(scale), stream)
    LAUNCHES[name] += 1
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status}")
    return out


# the kernel or its plain version, looked up at call time by
# ``models.layers.attention`` (chip_smoke.py swaps PLAIN in for its on-card
# reference forward)
KERNELS = {"flash_attn_causal": flash_attention_causal}
PLAIN = {"flash_attn_causal": flash_attention_causal_ref}
