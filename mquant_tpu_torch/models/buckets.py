"""Adaptive-resolution buckets for images of any size (the port's copy of
``mquant_tpu/models/buckets.py``): an image maps to the fixed (h, w) pixel
bucket of the closest aspect ratio and is resized into it."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """A fixed set of (h, w) pixel buckets, all multiples of the patch size."""

    patch: int
    buckets: Tuple[Tuple[int, int], ...]  # (H, W) pixel sizes

    @staticmethod
    def default(patch: int = 14, base: int = 448) -> "BucketSpec":
        s = base
        return BucketSpec(patch=patch, buckets=(
            (s, s), (s, 2 * s), (2 * s, s), (s // 2, s), (s, s // 2),
            (2 * s, 2 * s)))

    def choose(self, h: int, w: int) -> Tuple[int, int]:
        """Bucket with the closest aspect ratio, then the smallest
        sufficient area."""
        ar = h / max(w, 1)

        def key(b):
            bh, bw = b
            return (abs(np.log(ar / (bh / bw))), abs(bh * bw - h * w))

        return min(self.buckets, key=key)


def resize_normalize(img_u8: np.ndarray, size: Tuple[int, int],
                     mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)) -> np.ndarray:
    """uint8 (H, W, C) → float32 (dh, dw, C): align-corners bilinear, then
    (v / 255 − mean) / std (the JAX package's numpy path of
    ``native.resize_normalize``, f64 weights as there)."""
    dh, dw = size
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    sh, sw = img_u8.shape[:2]
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    ys = np.linspace(0, sh - 1, dh)
    xs = np.linspace(0, sw - 1, dw)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, sh - 1)
    x1 = np.minimum(x0 + 1, sw - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    f = img_u8.astype(np.float32)
    v = ((1 - wy) * ((1 - wx) * f[y0][:, x0] + wx * f[y0][:, x1])
         + wy * ((1 - wx) * f[y1][:, x0] + wx * f[y1][:, x1]))
    return ((v / 255.0 - mean) / std).astype(np.float32)


def prepare_image(img: np.ndarray, spec: BucketSpec,
                  max_tokens: Optional[int] = None,
                  mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)):
    """uint8 / float in [0, 1] (H, W, 3) image → (resized float32 (bh, bw,
    3), grid (gh, gw), None). Padding to ``max_tokens`` with a validity
    mask is not ported (ROADMAP A6)."""
    if max_tokens is not None:
        raise NotImplementedError("padded patch sequences (pad_to_max) are "
                                  "not ported (ROADMAP A6)")
    h, w = img.shape[:2]
    bh, bw = spec.choose(h, w)
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    out = resize_normalize(img, (bh, bw), mean, std)
    return out, (bh // spec.patch, bw // spec.patch), None


def max_bucket_tokens(spec: BucketSpec) -> int:
    return max((bh // spec.patch) * (bw // spec.patch)
               for bh, bw in spec.buckets)
