"""The port's random initializers (``models.llm.init_decoder_params``,
``models.vision.init_vit_params`` / ``init_merger_params``) against the JAX
package's: the same tree (keys, None slots, shapes, dtypes), weights with
the JAX draw's spread (per-site standard deviation within 2% of 1/√fan_in,
0.02 for the embedding and lm_head; means near 0), zero biases and unit
norms, and one generator seed giving one tree. The values cannot be JAX's
(another RNG)."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from mquant_tpu.models import llm as JLLM
from mquant_tpu.models import qwen2vl as JQ2
from mquant_tpu.models import vision as JV
from mquant_tpu_torch.models import llm as TLLM
from mquant_tpu_torch.models import qwen2vl as TQ2
from mquant_tpu_torch.models import vision as TV

STD_RTOL = 0.02
DTYPES = {jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16}


def _cfgs():
    """Widths with enough draws per site for a 2% spread check."""
    j, t = JQ2.Qwen2VLConfig.tiny(), TQ2.Qwen2VLConfig.tiny()
    llm = dict(vocab=512, hidden=128, n_layers=2, n_heads=4, n_kv_heads=2,
               intermediate=384)
    vit = dict(width=128, n_layers=2, n_heads=2, mlp_width=256)
    return (dataclasses.replace(j.llm, **llm), dataclasses.replace(j.vit, **vit),
            dataclasses.replace(j.merger, context_dim=128, out_dim=128),
            dataclasses.replace(t.llm, **llm), dataclasses.replace(t.vit, **vit),
            dataclasses.replace(t.merger, context_dim=128, out_dim=128))


def _same_tree(t, j, path=""):
    if isinstance(j, dict):
        assert isinstance(t, dict) and set(t) == set(j), (path, set(t), set(j))
        for k in j:
            _same_tree(t[k], j[k], f"{path}/{k}")
    elif j is None:
        assert t is None, path
    else:
        assert tuple(t.shape) == j.shape, (path, t.shape, j.shape)
        assert t.dtype == DTYPES[j.dtype], (path, t.dtype, j.dtype)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif tree is not None:
        yield path, tree


def _check_values(tree):
    for path, w in _leaves(tree):
        if path.endswith("/b"):
            assert not w.any(), path
        elif path.split("/")[-2].startswith("ln"):
            assert (w == 1).all(), path
        else:
            want = (0.02 if path in ("/embed/w", "/lm_head/w")
                    else w.shape[-2] ** -0.5)
            wf = w.float()
            assert abs(float(wf.std()) / want - 1) <= STD_RTOL, path
            assert abs(float(wf.mean())) <= 0.05 * want, path


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_decoder_params_tree(dtype):
    cj, _, _, ct, _, _ = _cfgs()
    pj = JLLM.init_decoder_params(cj, jax.random.key(0), dtype=dtype)
    pt = TLLM.init_decoder_params(ct, torch.Generator().manual_seed(0),
                                  dtype=DTYPES[jnp.dtype(dtype)],
                                  device="cpu")
    _same_tree(pt, pj)
    _check_values(pt)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_vision_params_trees(dtype):
    _, vj, mj, _, vt, mt = _cfgs()
    td = DTYPES[jnp.dtype(dtype)]
    g = torch.Generator().manual_seed(0)
    pv = TV.init_vit_params(vt, g, dtype=td, device="cpu")
    pm = TV.init_merger_params(mt, g, dtype=td, device="cpu")
    _same_tree(pv, JV.init_vit_params(vj, jax.random.key(0), dtype=dtype))
    _same_tree(pm, JV.init_merger_params(mj, jax.random.key(1), dtype=dtype))
    _check_values(pv)
    _check_values(pm)


def test_one_seed_one_tree():
    _, _, _, ct, vt, mt = _cfgs()

    def build(seed):
        g = torch.Generator().manual_seed(seed)
        return {"llm": TLLM.init_decoder_params(ct, g, device="cpu"),
                "vit": TV.init_vit_params(vt, g, device="cpu"),
                "merger": TV.init_merger_params(mt, g, device="cpu")}

    a, b, c = build(3), build(3), build(4)
    la, lb, lc = (list(_leaves(x)) for x in (a, b, c))
    assert [p for p, _ in la] == [p for p, _ in lb]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))
    assert not torch.equal(la[0][1], lc[0][1])


def test_default_dtype_and_device_follow_the_config():
    _, _, _, ct, _, _ = _cfgs()
    p = TLLM.init_decoder_params(ct, torch.Generator(), device="cpu")
    assert p["layers"]["q"]["w"].dtype == ct.dtype
    assert p["layers"]["o"]["b"] is None and p["layers"]["q"]["b"] is not None
