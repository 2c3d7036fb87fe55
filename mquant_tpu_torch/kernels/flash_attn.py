"""Causal flash attention for long prefills (counterpart of the library
Pallas kernel ``jax.experimental.pallas.ops.tpu.flash_attention`` that
``mquant_tpu/models/layers.py::attention`` calls for causal prefill with
T == S ≥ 2048).

:func:`flash_attention_causal` launches the hand-written CUDA kernel
``mq_flash_attn_causal`` (``csrc/attn.cu``: mma.sync bf16 tiles, online f32
softmax, the (T, T) scores never in device memory) for a CUDA tensor, or
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
BLOCK_T = 64  # query / key rows per tile: T must be a multiple


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


def flash_attention_causal(q, k, v, scale: float):
    """out (B, T, H, hd) = softmax(q·kᵀ·scale, causal)·v in q's dtype for
    q (B, T, H, hd), k / v (B, T, KVH, hd). On CUDA: bf16, hd == 128,
    T % 64 == 0, contiguous operands."""
    name = "flash_attn_causal"
    B, T, H, hd, KVH = _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_causal_ref(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError(f"{name}: the kernel takes bf16 q, k, v")
    if hd != HEAD_DIM or T % BLOCK_T:
        raise ValueError(f"{name}: needs head_dim == {HEAD_DIM} and "
                         f"T % {BLOCK_T} == 0, got {hd}, {T}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError(f"{name}: operands must be contiguous")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError(f"{name}: tensors on several devices")
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
