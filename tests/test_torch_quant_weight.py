"""The port's weight quantization parameters (``core.quant.weight_qparams``)
and round-to-nearest helpers against the JAX package's, on seeded f32 and
bf16 weights, 2-D and stacked (L, in, out): scales and zero points bit-equal
with the MSE clip search off and on (the search's errors sum in other orders
on the two backends; its argmin picks the same shrink on these weights), and
the RTN codes and fake-quantized weights bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mquant_tpu.core import formats as JF
from mquant_tpu.core import quant as JQ
from mquant_tpu_torch import interop
from mquant_tpu_torch.core import formats as TF
from mquant_tpu_torch.core import quant as TQ


def _weight(seed, shape, dtype):
    w = np.random.default_rng(seed).normal(size=shape) * 0.05
    w[..., 0, :] *= 8  # an outlier row, so the clip search has work to do
    return np.asarray(jnp.asarray(w, dtype))


def _eq(t, j):
    if j is None:
        assert t is None
        return
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


CASES = [  # (shape, per_channel, symmetric, reduce_axes)
    ((96, 40), True, True, None),
    ((96, 40), True, False, None),
    ((96, 40), False, True, None),
    ((96, 40), False, False, None),
    ((3, 64, 24), True, True, (-2,)),
    ((3, 64, 24), True, False, (-2,)),
    ((3, 64, 24), True, True, None),
]


@pytest.mark.parametrize("mse_clip", [False, True])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1:]}")
def test_weight_qparams_bit_equal(case, bits, dtype, mse_clip):
    shape, per_channel, symmetric, axes = case
    w = _weight(len(shape) * 10 + bits, shape, dtype)
    kw = dict(per_channel=per_channel, symmetric=symmetric,
              mse_clip=mse_clip, reduce_axes=axes)
    qj = JQ.weight_qparams(jnp.asarray(w), JF.get_format(bits, symmetric),
                           **kw)
    qt = TQ.weight_qparams(interop.array_to_torch(w, device="cpu"),
                           TF.get_format(bits, symmetric), **kw)
    assert qt.scale.shape == np.shape(qj.scale)
    _eq(qt.scale, qj.scale)
    _eq(qt.zero_point, qj.zero_point)


def test_mse_clip_moves_the_scale():
    """The outlier row makes a shrink win: the searched scale is below the
    minmax one in some channels (the search is not a no-op here)."""
    w = interop.array_to_torch(_weight(0, (96, 40), jnp.float32), "cpu")
    fmt = TF.get_format(4, True)
    s0 = TQ.weight_qparams(w, fmt).scale
    s1 = TQ.weight_qparams(w, fmt, mse_clip=True).scale
    assert (s1 <= s0).all() and (s1 < s0).any()


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("mse_clip", [False, True])
def test_rtn_helpers_bit_equal(symmetric, mse_clip):
    w = _weight(5, (2, 64, 24), jnp.bfloat16)
    kw = dict(symmetric=symmetric, mse_clip=mse_clip, reduce_axes=(-2,))
    wt = interop.array_to_torch(w, device="cpu")
    qj, pj = JQ.rtn_quantize_weight(jnp.asarray(w), 4, **kw)
    qt, pt = TQ.rtn_quantize_weight(wt, 4, **kw)
    assert qt.dtype == (torch.int8 if symmetric else torch.uint8)
    _eq(qt, qj)
    _eq(pt.scale, pj.scale)
    fj = JQ.rtn_fake_quant_weight(jnp.asarray(w), 4, **kw)
    ft = TQ.rtn_fake_quant_weight(wt, 4, **kw)
    assert ft.dtype == torch.bfloat16
    _eq(ft.float(), np.asarray(fj).astype(np.float32))
