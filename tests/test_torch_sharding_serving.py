"""The port's serving stack under tensor parallelism against the unsharded
port, as ``tests/test_sharding.py`` holds JAX's serving stack under its mesh
to the unsharded runs: the continuous-batching engine with a registered
prefix, speculative decoding, packed-resident W4 and the HTTP server at
tp = 4, plus a VLM chat request with an image through the server at
tp = 2 (the tick's vision op) and a crash of rank 0's scheduler. One spawn
of four gloo ranks (``torch_tp_ranks.serving_jobs``); outputs must be
equal, token for token."""

import base64

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mquant_tpu.models import llm as JLLM
from mquant_tpu.models.registry import get_family as j_family
from mquant_tpu_torch.models.layers import SiteSpec
from mquant_tpu_torch.models.llm import LLM_SITES
from mquant_tpu_torch.utils.png import encode_png

import torch_tp_ranks as R
from torch_threads import _one_torch_thread  # noqa: F401

FP_CFG = dict(vocab=64, hidden=32, n_layers=2, n_heads=4, n_kv_heads=4,
              intermediate=64)
W4_CFG = dict(vocab=128, hidden=64, n_layers=2, n_heads=4, n_kv_heads=2,
              intermediate=128)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _w4_tree():
    """JAX's packed-resident case: W4A8 static per-tensor scales of 0.05,
    one code a byte (each rank packs and fuses its own tree)."""
    cfg = JLLM.DecoderConfig(**W4_CFG, dtype=jnp.float32)
    params = _np_tree(JLLM.init_decoder_params(cfg, jax.random.key(0)))
    rng = np.random.default_rng(0)
    for n in LLM_SITES:
        site = params["layers"][n]
        w = site.pop("w")
        site["w_q"] = rng.integers(-7, 8, w.shape).astype(np.int8)
        site["w_scale"] = np.abs(w).max(-2) / 7
    specs = {f"llm.{n}": SiteSpec(w_bits=4, a_bits=8, a_static=True)
             for n in LLM_SITES}
    state = {f"llm.{n}": {"act": ("qp", np.full((2,), 0.05, np.float32),
                                  None)} for n in LLM_SITES}
    return dict(cfg=W4_CFG, params=params, specs=specs, state=state)


def _chat(seed: int):
    img = (np.random.default_rng(seed).random((16, 16, 3)) * 255).astype(
        np.uint8)
    url = "data:image/png;base64," + base64.b64encode(
        encode_png(img)).decode()
    return {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "what is this?"},
        {"type": "image_url", "image_url": {"url": url}}]}],
        "max_tokens": 4}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    cfg = JLLM.DecoderConfig(**FP_CFG, dtype=jnp.float32)
    params = _np_tree(JLLM.init_decoder_params(cfg, jax.random.key(5)))
    fam = j_family("qwen2vl")
    vparams = _np_tree(fam.init_fn(fam.tiny_fn(), jax.random.key(0)))
    pl = {"fp": dict(cfg=FP_CFG, params=params,
                     prompts=[list(range(1, 7)), list(range(10, 20)),
                              [30, 31, 32]]),
          "w4": _w4_tree(),
          "vlm": dict(family="qwen2vl", params=vparams,
                      chats=[_chat(1), _chat(2)])}
    return R.spawn("serving_jobs", pl, 4, tmp_path_factory.mktemp("tp"))


def test_engine_under_tp_matches_unsharded(run):
    ref, got, hits = run["engine"]
    assert got == ref
    assert hits == 1


def test_speculative_under_tp_matches_unsharded(run):
    ref, got = run["spec"]
    np.testing.assert_array_equal(got, ref)


def test_packed_resident_tp_token_exact(run):
    """Each rank packs its own q|k|v (fused: one query head and its
    replicated KV head, whole) and its row-parallel o / down at its K / tp
    rows."""
    ref, got, (qkv, o, down, qkv0) = run["packed"]
    np.testing.assert_array_equal(got, ref)
    hd = W4_CFG["hidden"] // W4_CFG["n_heads"]
    assert qkv0[-1] == (4 + 2 * 2) * hd and qkv[-1] == (1 + 2 * 1) * hd
    assert qkv[-2] * 2 == W4_CFG["hidden"]
    assert o[-2] * 2 * 4 == W4_CFG["hidden"]
    assert down[-2] * 2 * 4 == W4_CFG["intermediate"]


def test_http_server_over_tp_mesh_matches_unsharded(run):
    ref, got = run["http"]
    assert got == ref


def test_http_vlm_chat_over_tp_mesh_matches_unsharded(run):
    """Image chat requests at tp = 2: every rank runs the vision tower's
    shard on the image arrays rank 0 broadcast, then the same admission."""
    ref, got = run["http_vlm"]
    assert got == ref and len(got) == 2


def test_scheduler_crash_under_tp_releases_followers(run):
    """An exception in rank 0's tick fails its request and sends the stop
    tick: the other ranks return from ``serve_follower`` at once, not at the
    collective's timeout."""
    (status, body), waited = run["crash"]
    assert status == 400
    assert "injected scheduler failure" in body["error"]
    assert waited < 30
