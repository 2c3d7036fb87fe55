"""The port's attention kernels' plain versions and their routing, against
the JAX package (CPU; numpy inputs from a fixed seed for both packages).

* ``attn_decode_ref`` against JAX ``attn_decode_fused`` in interpret mode,
  with columns outside [start, pos) poisoned: the written caches bit-equal;
  f32 outputs within 1e-5 (both sum the same f32 products in different
  orders), bf16 outputs within 1e-2 of their largest magnitude (the two
  round the probabilities to bf16 at different points of the sum).
* ``flash_attention_causal_ref`` against JAX ``layers.attention(causal=True)``
  within 1e-5 (f32).
* ``layers.attention`` routing: which inputs take the flash path, what the
  CPU computes there, and that no path calls SDPA.
* One decode step of a tiny hd = 128 decoder: the port's fused branch (the
  plain decode kernel on CPU) against JAX with ``MQUANT_ATTN=fused`` and
  ``xla``, with a per-row ``attn_start``: logits and caches within 2e-5
  and 1e-5 (the tolerances of ``tests/test_attn_decode.py``; the packages
  sum the f32 products of the projections in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mquant_tpu.kernels.attn_decode import attn_decode_fused
from mquant_tpu.models import layers as JL
from mquant_tpu.models import llm as JM
from mquant_tpu_torch import interop
from mquant_tpu_torch.kernels import attn_decode as TA
from mquant_tpu_torch.kernels import flash_attn as TF
from mquant_tpu_torch.models import layers as TL
from mquant_tpu_torch.models import llm as TM

F32_TOL = dict(rtol=1e-5, atol=1e-5)
POISON_K, POISON_V = 50.0, 3e4  # a read of either would swamp the output


def _t(a):
    return interop.array_to_torch(a, device="cpu")


def _decode_inputs(rng, dtype, B=2, H=4, KVH=2, hd=128, S=64):
    f32 = np.float32
    q = rng.normal(size=(B, 1, H, hd)).astype(f32)
    kn = rng.normal(size=(B, 1, KVH, hd)).astype(f32)
    vn = rng.normal(size=(B, 1, KVH, hd)).astype(f32)
    kc = rng.normal(size=(B, S, KVH, hd)).astype(f32)
    vc = rng.normal(size=(B, S, KVH, hd)).astype(f32)
    cast = (lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))) \
        if dtype == "bf16" else (lambda a: a)
    return [cast(a) for a in (q, kn, vn, kc, vc)]


def _poison(kc, vc, pos, start):
    kc, vc = kc.copy(), vc.copy()
    for b in range(kc.shape[0]):
        for sl in (slice(0, start[b]), slice(pos[b], None)):
            kc[b, sl] = POISON_K
            vc[b, sl] = POISON_V
    return kc, vc


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("perrow", [True, False])
def test_attn_decode_ref_matches_jax(dtype, perrow):
    _ref_matches_jax(dtype, perrow, (37, 63), 40)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("perrow", [True, False])
def test_attn_decode_ref_matches_jax_g16(dtype, perrow):
    """GLM-4V's group: 32 query heads on 2 KV heads (G = 16), the kernel's
    widest."""
    _ref_matches_jax(dtype, perrow, (37, 90), 80, H=32, KVH=2, S=96)


def _ref_matches_jax(dtype, perrow, row_pos, shared_pos, **shape):
    rng = np.random.default_rng(11)
    q, kn, vn, kc, vc = _decode_inputs(rng, dtype, **shape)
    B = q.shape[0]
    if perrow:
        pos, start = np.array(row_pos, np.int32), np.array([5, 20], np.int32)
    else:
        pos, start = np.int32(shared_pos), None
    pos_b = np.broadcast_to(pos, (B,))
    start_b = np.zeros((B,), np.int32) if start is None else start
    kc, vc = _poison(kc, vc, pos_b, start_b)
    scale = 128**-0.5
    oj, kcj, vcj = attn_decode_fused(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(pos), scale,
        start=None if start is None else jnp.asarray(start), interpret=True)
    kct, vct = _t(kc), _t(vc)
    pos_t = torch.from_numpy(pos) if perrow else int(pos)
    start_t = None if start is None else torch.from_numpy(start)
    ot, kc2, vc2 = TA.attn_decode(_t(q), _t(kn), _t(vn), kct, vct, pos_t,
                                  scale, start=start_t)
    assert kc2 is kct and vc2 is vct  # updated in place, returned as given
    np.testing.assert_array_equal(kct.float().numpy(),
                                  np.asarray(kcj, np.float32))
    np.testing.assert_array_equal(vct.float().numpy(),
                                  np.asarray(vcj, np.float32))
    oj = np.asarray(oj, np.float32)
    if dtype == "f32":
        np.testing.assert_allclose(ot.numpy(), oj, **F32_TOL)
    else:
        np.testing.assert_allclose(ot.float().numpy(), oj, rtol=0,
                                   atol=1e-2 * np.abs(oj).max())
    # the poison never reaches the output: the clean cache gives the same
    q2, kn2, vn2, kc_c, vc_c = _decode_inputs(np.random.default_rng(11),
                                              dtype, **shape)
    clean, _, _ = TA.attn_decode_ref(_t(q2), _t(kn2), _t(vn2), _t(kc_c),
                                     _t(vc_c), pos_t, scale, start=start_t)
    np.testing.assert_array_equal(ot.float().numpy(), clean.float().numpy())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_attn_decode_ref_ignores_a_nan_tail(dtype):
    """NaN in every column outside [start, pos) (a slot pool's stale rows,
    ROADMAP C-w1) leaves the plain version's output equal to the clean
    cache's: masked scores and unread V columns both stay out."""
    q, kn, vn, kc, vc = (_t(a) for a in _decode_inputs(
        np.random.default_rng(13), dtype, B=3))
    pos, start = torch.tensor([37, 63, 5]), torch.tensor([5, 0, 0])
    cols = torch.arange(kc.shape[1])[None]
    bad = ((cols < start[:, None]) | (cols >= pos[:, None]))[..., None, None]
    out, _, _ = TA.attn_decode_ref(q, kn, vn, kc.masked_fill(bad, np.nan),
                                   vc.masked_fill(bad, np.nan), pos,
                                   128**-0.5, start=start)
    clean, _, _ = TA.attn_decode_ref(q, kn, vn, kc.clone(), vc.clone(), pos,
                                     128**-0.5, start=start)
    assert torch.equal(out, clean)


def test_attn_decode_ref_new_token_only():
    """pos == start: the output is the new token's v (softmax of one term)."""
    rng = np.random.default_rng(12)
    q, kn, vn, kc, vc = _decode_inputs(rng, "f32", B=1, S=16)
    out, _, _ = TA.attn_decode_ref(_t(q), _t(kn), _t(vn), _t(kc), _t(vc), 6,
                                   0.1, start=6)
    np.testing.assert_allclose(out[0, 0].numpy(),
                               np.repeat(vn[0, 0], 2, axis=0), **F32_TOL)


@pytest.mark.parametrize("T", [128, 256])
def test_flash_ref_matches_jax_causal(T):
    rng = np.random.default_rng(T)
    q = rng.normal(size=(1, T, 4, 128)).astype(np.float32)
    k = rng.normal(size=(1, T, 2, 128)).astype(np.float32)
    v = rng.normal(size=(1, T, 2, 128)).astype(np.float32)
    oj = JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=True)
    ot = TF.flash_attention_causal_ref(_t(q), _t(k), _t(v), 128**-0.5)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **F32_TOL)
    # on a CPU tensor the wrapper is the plain version
    ow = TF.flash_attention_causal(_t(q), _t(k), _t(v), 128**-0.5)
    np.testing.assert_array_equal(ow.numpy(), ot.numpy())


def _qkv(T, hd=128, H=2, KVH=1, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(1, T, H, hd)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(1, T, KVH, hd)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(1, T, KVH, hd)).astype(np.float32)))


def test_attention_routes_long_causal_prefill_to_flash(monkeypatch):
    """Causal, no mask, T == S ≥ FLASH_MIN_T, hd % 128 == 0 and T % 128 == 0
    take the flash kernel's slot; every other case stays the einsum."""
    calls = []

    def spy(q, k, v, scale):
        calls.append(q.shape[1])
        return torch.zeros_like(q)

    monkeypatch.setitem(TF.KERNELS, "flash_attn_causal", spy)
    n = TL.FLASH_MIN_T
    assert n == 2048
    q, k, v = _qkv(n)
    TL.attention(q, k, v, causal=True)
    assert calls == [n]
    TL.attention(q, k, v, causal=False)  # the ViT's full attention
    TL.attention(q, k, v, mask=torch.ones((1, 1, n, n), dtype=torch.bool))
    TL.attention(*_qkv(n - 128), causal=True)  # below the threshold
    TL.attention(*_qkv(n + 64), causal=True)  # T % 128 != 0
    TL.attention(*_qkv(n, hd=64), causal=True)  # hd % 128 != 0
    TL.attention(q, k[:, :n - 128], v[:, :n - 128], causal=True)  # T != S
    assert calls == [n]


def test_attention_flash_path_on_cpu_is_plain_and_no_sdpa(monkeypatch):
    def no_sdpa(*a, **k):
        raise AssertionError("scaled_dot_product_attention is not the port's")

    monkeypatch.setattr(torch.nn.functional, "scaled_dot_product_attention",
                        no_sdpa)
    before = TF.LAUNCHES["flash_attn_causal"]
    q, k, v = _qkv(TL.FLASH_MIN_T, seed=3)
    out = TL.attention(q, k, v, causal=True)
    ref = TF.flash_attention_causal_ref(q, k, v, 128**-0.5)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    assert TF.LAUNCHES["flash_attn_causal"] == before  # no kernel on CPU
    rng = np.random.default_rng(4)
    qd, kn, vn, kc, vc = _decode_inputs(rng, "f32", B=1, S=32)
    before = TA.LAUNCHES["attn_decode"]
    TA.attn_decode(_t(qd), _t(kn), _t(vn), _t(kc), _t(vc), 9, 0.1)
    assert TA.LAUNCHES["attn_decode"] == before


# ---------------------------------------------------------------------------
# one decode step of a tiny hd = 128 decoder
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny128():
    """hd = 128 so the fused decode path is eligible in both packages."""
    kw = dict(vocab=64, hidden=256, n_layers=2, n_heads=2, n_kv_heads=1,
              intermediate=384, head_dim=128)
    cfg_j = JM.DecoderConfig(**kw, dtype=jnp.float32)
    cfg_t = TM.DecoderConfig(**kw, dtype=torch.float32)
    params_np = jax.tree.map(np.asarray,
                             JM.init_decoder_params(cfg_j, jax.random.key(0)))
    return cfg_j, cfg_t, params_np


def test_fused_decode_eligibility(tiny128):
    _, cfg, _ = tiny128
    cache = TM.init_cache(cfg, 2, 32, device="cpu")
    assert TM._use_fused_decode_attn(cfg, cache, 1, False, None)
    assert not TM._use_fused_decode_attn(cfg, cache, 2, False, None)
    assert not TM._use_fused_decode_attn(cfg, cache, 1, True, None)
    assert not TM._use_fused_decode_attn(cfg, None, 1, False, None)
    assert not TM._use_fused_decode_attn(
        cfg, cache, 1, False, torch.ones((2, 1, 1, 32), dtype=torch.bool))
    bf = TM.init_cache(cfg, 2, 32, dtype=torch.bfloat16, device="cpu")
    assert not TM._use_fused_decode_attn(cfg, bf, 1, False, None)
    narrow = TM.DecoderConfig(vocab=8, hidden=64, n_layers=1, n_heads=4,
                              n_kv_heads=2, intermediate=8,
                              dtype=torch.float32)
    assert not TM._use_fused_decode_attn(
        narrow, TM.init_cache(narrow, 1, 8, device="cpu"), 1, False, None)


def test_fused_decode_step_matches_jax(tiny128, monkeypatch):
    cfg_j, cfg_t, params_np = tiny128
    params_j = jax.tree.map(jnp.asarray, params_np)
    params_t = interop.to_torch(params_np, device="cpu")
    B, T, S = 2, 7, 32
    toks = np.random.default_rng(5).integers(0, cfg_j.vocab, size=(B, T))
    lj, cj, _ = JM.decoder_forward(cfg_j, params_j, jnp.asarray(toks),
                                   cache=JM.init_cache(cfg_j, B, S),
                                   prefill_fresh=True)
    lt, ct, _ = TM.decoder_forward(cfg_t, params_t, torch.from_numpy(toks),
                                cache=TM.init_cache(cfg_t, B, S, device="cpu"),
                                prefill_fresh=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=2e-5)
    tok = np.asarray(jnp.argmax(lj[:, -1:], -1)).astype(np.int32)
    cj = dict(cj)
    cj["pos"] = jnp.asarray(T, jnp.int32)
    start = np.array([0, 3], np.int32)

    calls = []
    kern = TA.KERNELS["attn_decode"]
    monkeypatch.setitem(TA.KERNELS, "attn_decode",
                        lambda *a, **k: calls.append(1) or kern(*a, **k))
    lt2, ct2, _ = TM.decoder_forward(cfg_t, params_t, torch.from_numpy(tok),
                                  cache=ct, attn_start=torch.from_numpy(start))
    assert len(calls) == cfg_t.n_layers and ct2["pos"] == T + 1
    for knob in ("fused", "xla"):
        monkeypatch.setenv("MQUANT_ATTN", knob)
        lj2, cj2, _ = JM.decoder_forward(cfg_j, params_j, jnp.asarray(tok),
                                         cache=dict(cj),
                                         attn_start=jnp.asarray(start))
        np.testing.assert_allclose(lt2.numpy(), np.asarray(lj2), rtol=1e-5,
                                   atol=2e-5)
        for name in ("k", "v"):
            np.testing.assert_allclose(ct2[name].numpy(),
                                       np.asarray(cj2[name]), rtol=0,
                                       atol=1e-5)
