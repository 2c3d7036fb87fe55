"""JAX-package parameters and quant state → the port's tensors.

Input: a nested dict of numpy arrays, as ``jax.tree.map(np.asarray, tree)``
gives it, with the JAX ``QuantParams`` as any (scale, zero_point) named tuple
or plain 2-tuple. Output: the same structure with torch tensors on ``device``
(the card unless the caller asks for another) and the port's
:class:`~mquant_tpu_torch.core.quant.QuantParams`. Every
array converts exactly, int8 bytes included; bfloat16 arrays (numpy's
``ml_dtypes`` bfloat16, which torch cannot read directly) go through their
16-bit patterns. This module imports no JAX.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .core.quant import QuantParams


def array_to_torch(a, device="cuda", dtype: Optional[torch.dtype] = None
                   ) -> torch.Tensor:
    """One array → tensor, exactly (then cast to ``dtype`` if given)."""
    a = np.asarray(a)
    # ascontiguousarray makes a 0-d array 1-d: the shape is restored below
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    t = t.reshape(a.shape).to(device)
    return t if dtype is None else t.to(dtype)


def _is_quant_params(obj) -> bool:
    fields = getattr(obj, "_fields", None)
    return isinstance(obj, tuple) and (fields == ("scale", "zero_point")
                                       or (fields is None and len(obj) == 2))


def to_torch(tree: Any, device="cuda", dtype: Optional[torch.dtype] = None
             ) -> Any:
    """Convert a params / state tree. ``dtype`` (optional) casts the float
    weights and biases (dict keys "w" and "b"); integer storage and every
    scale keep their own dtype."""

    def conv(obj, key=None):
        if obj is None:
            return None
        if isinstance(obj, dict):
            return {k: conv(v, k) for k, v in obj.items()}
        if _is_quant_params(obj):
            scale, zp = obj
            return QuantParams(array_to_torch(scale, device),
                               None if zp is None else array_to_torch(zp, device))
        if isinstance(obj, (list, tuple)):
            return type(obj)(conv(v) for v in obj)
        if isinstance(obj, (np.ndarray, np.generic)) or hasattr(obj, "__array__"):
            t = array_to_torch(obj, device)
            if dtype is not None and key in ("w", "b") and t.is_floating_point():
                t = t.to(dtype)
            return t
        return obj

    return conv(tree)
