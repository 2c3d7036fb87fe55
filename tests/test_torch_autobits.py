"""The port's lm_head width gate (``utils.autobits``) against the JAX
package's: the head-only perplexity ratio on the same logits within 1e-6
relative (softmax and log-softmax sums in other orders), and the
head-quantized decoder tree bit-equal (RTN per-channel minmax codes of the
lm_head, every other leaf the same object)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mquant_tpu.utils import autobits as JA
from mquant_tpu_torch import interop
from mquant_tpu_torch.utils import autobits as TA


def test_gate_constant():
    assert TA.HEAD_GATE_DEFAULT == JA.HEAD_GATE_DEFAULT


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_ppl_ratio_matches_jax(dtype):
    rng = np.random.default_rng(3)
    lf = np.asarray(jnp.asarray(rng.normal(size=(2, 16, 300)) * 3, dtype))
    lq = np.asarray(jnp.asarray(
        np.asarray(lf, np.float32) + rng.normal(size=lf.shape) * 0.2, dtype))
    rj = JA.ppl_ratio_from_logits(jnp.asarray(lf), jnp.asarray(lq))
    rt = TA.ppl_ratio_from_logits(interop.array_to_torch(lf, "cpu"),
                                  interop.array_to_torch(lq, "cpu"))
    assert rj > 1.001  # a real degradation, not the trivial 1.0
    assert abs(rt - rj) <= 1e-6 * rj
    assert TA.ppl_ratio_from_logits(interop.array_to_torch(lf, "cpu"),
                                    interop.array_to_torch(lf, "cpu")) \
        == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_head_quantized_tree_bit_equal(bits, dtype):
    rng = np.random.default_rng(bits)

    def arr(*shape):
        return np.asarray(jnp.asarray(rng.normal(size=shape) * 0.02, dtype))

    tree = {"embed": {"w": arr(50, 16)},
            "layers": {"q": {"w": arr(2, 16, 16), "b": None}},
            "ln_f": {"w": arr(16)},
            "lm_head": {"w": arr(16, 50)}}
    qj = JA.head_quantized_decoder(
        {k: _jtree(v) for k, v in tree.items()}, bits)
    tt = interop.to_torch(tree, device="cpu")
    qt = TA.head_quantized_decoder(tt, bits)
    assert qt["lm_head"]["w"].dtype == tt["lm_head"]["w"].dtype
    np.testing.assert_array_equal(
        qt["lm_head"]["w"].float().numpy(),
        np.asarray(qj["lm_head"]["w"]).astype(np.float32))
    assert not torch.equal(qt["lm_head"]["w"], tt["lm_head"]["w"])
    assert qt["embed"]["w"] is tt["embed"]["w"]
    assert qt["layers"]["q"]["w"] is tt["layers"]["q"]["w"]
    assert qt["layers"]["q"]["b"] is None


def _jtree(t):
    if isinstance(t, dict):
        return {k: _jtree(v) for k, v in t.items()}
    return None if t is None else jnp.asarray(t)
