"""The port's main path, end to end at the tiny Qwen2-VL configuration (f32,
CPU), against the JAX package on shared weights.

Weights and quant state are made once with numpy from a fixed seed, handed
to JAX as arrays and to the port through ``mquant_tpu_torch.interop``. The
slice: W8A8 ViT → merger → splice into the text embeddings → W4A8 decoder
with a block online Hadamard before ``down`` and an int8 lm_head → greedy
generation through each package's ``Generator``.

Tolerances: integer products are exact in both packages; the float ops
between them (norms, rope, attention, Hadamard) sum in different orders. The
outputs are held to 1e-5 of their largest magnitude: room for f32 rounding,
but not for an int8 activation code landing one step apart (one flipped
code at the lm_head input moves a logit by about 1e-3 of the largest here).
Greedy tokens must be equal.
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mquant_tpu.core.quant import QuantParams as JQP
from mquant_tpu.models import llm as JLLM
from mquant_tpu.models import qwen2vl as JQ2
from mquant_tpu.models import vision as JV
from mquant_tpu.models.layers import SiteSpec as JSpec
from mquant_tpu.serve.generate import Generator as JGenerator
from mquant_tpu_torch import interop
from mquant_tpu_torch.models import llm as TLLM
from mquant_tpu_torch.models import qwen2vl as TQ2
from mquant_tpu_torch.models import vision as TV
from mquant_tpu_torch.models.layers import SiteSpec as TSpec
from mquant_tpu_torch.serve.generate import Generator as TGenerator

LOGIT_RTOL = 1e-5


def _specs(Spec):
    s = {f"llm.{n}": Spec(w_bits=4, a_bits=8, a_static=True)
         for n in JLLM.LLM_SITES}
    # block Hadamard before down, as the main path; 96 = 3 blocks of 32
    s["llm.down"] = dataclasses.replace(s["llm.down"], online_had="block",
                                        head_dim=32)
    s["llm.lm_head"] = Spec(w_bits=8, a_bits=8, a_static=True)
    s.update({f"vis.{n}": Spec(w_bits=8, a_bits=8, a_static=True)
              for n in JV.VIT_SITES})
    s.update({f"merger.{n}": Spec(w_bits=8, a_bits=8, a_static=True)
              for n in ("mlp0", "mlp2")})
    return s


def _weights(seed=0):
    """numpy params (LLM W4 codes in int8 storage, int8 head, int8 ViT and
    merger with per-channel scales) and JAX quant state."""
    cfg = JQ2.Qwen2VLConfig.tiny()
    rng = np.random.default_rng(seed)
    c, v, m = cfg.llm, cfg.vit, cfg.merger
    L, Hd, I, hd = c.n_layers, c.hidden, c.inter_eff, c.head_dim
    f32 = np.float32

    def qsite(L_, din, dout, lo, hi, scale, bias):
        shape = (din, dout) if L_ is None else (L_, din, dout)
        d = {"w_q": rng.integers(lo, hi, size=shape).astype(np.int8),
             "w_scale": rng.uniform(0.5, 1.5, size=shape[:-2] + (dout,)
                                    ).astype(f32) * scale}
        d["b"] = (rng.normal(size=shape[:-2] + (dout,)).astype(f32) * 0.1
                  if bias else None)
        return d

    def ln(*shape, bias=False):
        d = {"w": (1 + 0.1 * rng.normal(size=shape)).astype(f32)}
        if bias:
            d["b"] = (0.1 * rng.normal(size=shape)).astype(f32)
        return d

    llm = {
        "embed": {"w": rng.normal(size=(c.vocab, Hd)).astype(f32)},
        "layers": {
            "ln1": ln(L, Hd),
            "q": qsite(L, Hd, c.n_heads * hd, -7, 8, 0.03, True),
            "k": qsite(L, Hd, c.n_kv_heads * hd, -7, 8, 0.03, True),
            "v": qsite(L, Hd, c.n_kv_heads * hd, -7, 8, 0.03, True),
            "o": qsite(L, c.n_heads * hd, Hd, -7, 8, 0.03, False),
            "ln2": ln(L, Hd),
            "gate": qsite(L, Hd, I, -7, 8, 0.03, False),
            "up": qsite(L, Hd, I, -7, 8, 0.03, False),
            "down": qsite(L, I, Hd, -7, 8, 0.03, False),
        },
        "ln_f": ln(Hd),
        "lm_head": qsite(None, Hd, c.vocab, -127, 128, 0.002, False),
    }
    llm["lm_head"].pop("b")
    vit = {
        "patch_embed": {"w": (rng.normal(size=(v.patch_dim, v.width)) /
                              np.sqrt(v.patch_dim)).astype(f32),
                        "b": np.zeros((v.width,), f32)},
        "blocks": {
            "ln1": ln(v.n_layers, v.width, bias=True),
            **{n: qsite(v.n_layers, v.width, v.width, -127, 128, 2e-4, True)
               for n in ("q", "k", "v", "o")},
            "ln2": ln(v.n_layers, v.width, bias=True),
            "fc1": qsite(v.n_layers, v.width, v.mlp_width, -127, 128, 2e-4,
                         True),
            "fc2": qsite(v.n_layers, v.mlp_width, v.width, -127, 128, 2e-4,
                         True),
        },
    }
    merger = {"ln_q": ln(m.context_dim, bias=True),
              "mlp0": qsite(None, m.in_dim, m.in_dim, -127, 128, 1e-4, True),
              "mlp2": qsite(None, m.in_dim, m.out_dim, -127, 128, 1e-4, True)}
    state = {f"llm.{n}": {"act": JQP(jnp.full((L,), 0.03, jnp.float32))}
             for n in JLLM.LLM_SITES}
    state["llm.lm_head"] = {"act": JQP(jnp.float32(0.03))}
    state.update({f"vis.{n}": {"act": JQP(jnp.full((v.n_layers,), 0.02,
                                                   jnp.float32))}
                  for n in JV.VIT_SITES})
    state.update({f"merger.{n}": {"act": JQP(jnp.float32(0.02))}
                  for n in ("mlp0", "mlp2")})
    return cfg, {"llm": llm, "vit": vit, "merger": merger}, state


@pytest.fixture(scope="module")
def shared():
    cfg_j, params_np, state_j = _weights()
    params_j = jax.tree.map(jnp.asarray, params_np)
    params_t = interop.to_torch(params_np, device="cpu")
    state_t = interop.to_torch(jax.tree.map(np.asarray, state_j), device="cpu")
    return dict(cfg_j=cfg_j, cfg_t=TQ2.Qwen2VLConfig.tiny(),
                params_j=params_j, params_t=params_t, state_j=state_j,
                state_t=state_t, specs_j=_specs(JSpec), specs_t=_specs(TSpec))


def _image_inputs(rng, cfg):
    """A 16×16 image → 16 patch rows (4×4 grid) → 4 merged tokens, in a
    prompt with the 4 image tokens at positions 3..6."""
    img = rng.normal(size=(1, 16, 16, 3)).astype(np.float32)
    toks = rng.integers(0, 200, size=(1, 20))
    toks[0, 3:7] = cfg.image_token_id
    return img, toks


def _embeds_j(s, img, toks):
    cfg, p = s["cfg_j"], s["params_j"]
    patches, grid = JV.patchify_qwen2vl(jnp.asarray(img), patch=cfg.patch)
    feats, _ = JV.vit_forward(cfg.vit, p["vit"], patches, s["specs_j"],
                              s["state_j"], "real", grid_hw=grid)
    merged, _ = JV.merger_forward(cfg.merger, p["merger"], feats,
                                  s["specs_j"], s["state_j"], "real")
    emb = p["llm"]["embed"]["w"][jnp.asarray(toks)]
    return JQ2.splice_image_embeds(emb, jnp.asarray(toks), merged,
                                   cfg.image_token_id), patches, feats


def _embeds_t(s, img, toks):
    cfg, p = s["cfg_t"], s["params_t"]
    patches, grid = TV.patchify_qwen2vl(torch.from_numpy(img), patch=cfg.patch)
    feats, _ = TV.vit_forward(cfg.vit, p["vit"], patches, s["specs_t"],
                              s["state_t"], "real", grid_hw=grid)
    merged, _ = TV.merger_forward(cfg.merger, p["merger"], feats,
                                  s["specs_t"], s["state_t"], "real")
    emb = p["llm"]["embed"]["w"][torch.from_numpy(toks)]
    return TQ2.splice_image_embeds(emb, torch.from_numpy(toks), merged,
                                   cfg.image_token_id), patches, feats


def _close(t, j, rtol=LOGIT_RTOL):
    j = np.asarray(j)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=0,
                               atol=rtol * np.abs(j).max())


def test_vision_merger_splice_matches_jax(shared):
    rng = np.random.default_rng(1)
    img, toks = _image_inputs(rng, shared["cfg_j"])
    emb_j, patches_j, feats_j = _embeds_j(shared, img, toks)
    emb_t, patches_t, feats_t = _embeds_t(shared, img, toks)
    np.testing.assert_array_equal(patches_t.numpy(), np.asarray(patches_j))
    _close(feats_t, feats_j)
    _close(emb_t, emb_j)
    # text rows of the splice are the embedding rows themselves
    text = toks[0] != shared["cfg_j"].image_token_id
    np.testing.assert_array_equal(emb_t[0, text].numpy(),
                                  np.asarray(emb_j)[0, text])


def test_decoder_prefill_logits_match_jax(shared):
    """Tiny decoder_forward over a VLM prompt with M-RoPE positions, and the
    serving prefill's last-token logits (per-row ``last_index``)."""
    rng = np.random.default_rng(2)
    cfg = shared["cfg_j"]
    img, toks = _image_inputs(rng, cfg)
    emb_j, _, _ = _embeds_j(shared, img, toks)
    emb_t, _, _ = _embeds_t(shared, img, toks)
    pos = JQ2.mrope_positions(toks, cfg.image_token_id, grid_thw=(1, 4, 4))
    np.testing.assert_array_equal(
        TQ2.mrope_positions(toks, cfg.image_token_id, grid_thw=(1, 4, 4)), pos)
    lj, _, _ = JLLM.decoder_forward(cfg.llm, shared["params_j"]["llm"], emb_j,
                                    specs=shared["specs_j"],
                                    state=shared["state_j"], mode="real",
                                    positions=jnp.asarray(pos))
    lt, _, _ = TLLM.decoder_forward(shared["cfg_t"].llm,
                                 shared["params_t"]["llm"], emb_t,
                                 specs=shared["specs_t"],
                                 state=shared["state_t"], mode="real",
                                 positions=torch.from_numpy(pos))
    assert lt.shape == (1, 20, cfg.llm.vocab)
    _close(lt, lj)
    last, _, _ = TLLM.decoder_forward(shared["cfg_t"].llm,
                                   shared["params_t"]["llm"], emb_t,
                                   specs=shared["specs_t"],
                                   state=shared["state_t"], mode="real",
                                   positions=torch.from_numpy(pos),
                                   last_index=torch.tensor([13]))
    np.testing.assert_array_equal(last[:, 0].numpy(), lt[:, 13].numpy())


@pytest.mark.parametrize("vlm", [True, False])
def test_generator_greedy_tokens_match_jax(shared, vlm):
    """≥ 8 greedy tokens through each package's Generator (bucketed prefill
    + KV-cache decode; M-RoPE continuation for the image prompt)."""
    rng = np.random.default_rng(3)
    cfg = shared["cfg_j"]
    n_new = 10
    gj = JGenerator(cfg.llm, shared["params_j"]["llm"],
                    specs=shared["specs_j"], state=shared["state_j"],
                    mode="real", max_len=64)
    gt = TGenerator(shared["cfg_t"].llm, shared["params_t"]["llm"],
                    specs=shared["specs_t"], state=shared["state_t"],
                    mode="real", max_len=64)
    if vlm:
        img, toks = _image_inputs(rng, cfg)
        pos = JQ2.mrope_positions(toks, cfg.image_token_id,
                                  grid_thw=(1, 4, 4))
        xj, _, _ = _embeds_j(shared, img, toks)
        xt, _, _ = _embeds_t(shared, img, toks)
        oj = gj.generate_on_device(xj, n_new, positions=jnp.asarray(pos))
        ot = gt.generate_on_device(xt, n_new, positions=torch.from_numpy(pos))
    else:
        toks = rng.integers(0, cfg.llm.vocab, size=(1, 13))
        oj = gj.generate_on_device(jnp.asarray(toks), n_new)
        ot = gt.generate_on_device(torch.from_numpy(toks), n_new)
    assert ot.shape == (1, n_new)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    # the host-driven loop gives the same tokens
    hj = gt.generate(torch.from_numpy(toks) if not vlm else xt, n_new,
                     positions=None if not vlm else torch.from_numpy(pos))
    np.testing.assert_array_equal(hj.numpy(), ot.numpy())


def test_generator_eos_freezes_rows(shared):
    """A row that emits eos stays at eos and the loop stops early."""
    gt = TGenerator(shared["cfg_t"].llm, shared["params_t"]["llm"],
                    specs=shared["specs_t"], state=shared["state_t"],
                    mode="real", max_len=64)
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (1, 9)))
    free = gt.generate_on_device(toks, 6)
    eos = int(free[0, 2])
    out = gt.generate_on_device(toks, 6, eos_id=eos)
    first = int((free[0] == eos).nonzero()[0])
    np.testing.assert_array_equal(out[0, :first + 1].numpy(),
                                  free[0, :first + 1].numpy())
    assert (out[0, first:] == eos).all()


def test_generator_first_token_hook(shared):
    """``on_first_token`` sees the first column of the output, once."""
    gt = TGenerator(shared["cfg_t"].llm, shared["params_t"]["llm"],
                    specs=shared["specs_t"], state=shared["state_t"],
                    mode="real", max_len=64)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (1, 9)))
    seen = []
    out = gt.generate_on_device(toks, 5, on_first_token=seen.append)
    assert len(seen) == 1 and seen[0].shape == (1, 1)
    np.testing.assert_array_equal(seen[0].numpy(), out[:, :1].numpy())


def test_interop_converts_exactly(rng):
    """int8 bytes, f32 and bf16 arrays and QuantParams cross unchanged."""
    tree = {"a": {"w_q": rng.integers(-128, 128, size=(4, 3)).astype(np.int8),
                  "w": np.asarray(jnp.asarray(rng.normal(size=(5,)),
                                              jnp.bfloat16)),
                  "b": None},
            "st": JQP(np.float32(0.5), np.float32(3.0)),
            "st2": JQP(np.ones((2,), np.float32))}
    out = interop.to_torch(tree, device="cpu")
    np.testing.assert_array_equal(out["a"]["w_q"].numpy(), tree["a"]["w_q"])
    assert out["a"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["a"]["w"].float().numpy(),
                                  tree["a"]["w"].astype(np.float32))
    assert out["a"]["b"] is None
    assert float(out["st"].scale) == 0.5 and float(out["st"].zero_point) == 3
    assert out["st2"].zero_point is None
    cast = interop.to_torch(tree, device="cpu", dtype=torch.float32)
    assert cast["a"]["w"].dtype == torch.float32
    assert cast["a"]["w_q"].dtype == torch.int8


def test_port_imports_no_jax():
    """Importing every module of the port pulls in no JAX, nothing of the
    JAX package, and none of flax, msgpack, safetensors, ml_dtypes, PIL and
    transformers (the card has none of them)."""
    code = ("import sys, importlib, pkgutil, mquant_tpu_torch as m\n"
            "for i in pkgutil.walk_packages(m.__path__, m.__name__ + '.'):\n"
            "    importlib.import_module(i.name)\n"
            "roots = ('jax', 'jaxlib', 'flax', 'msgpack', 'safetensors', "
            "'ml_dtypes', 'PIL', 'transformers')\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in roots "
            "or k.startswith('mquant_tpu.')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _ragged_prompts(shared, mrope):
    """Three prompts of 20, 13 and 9 tokens; with ``mrope`` they are image
    prompts (4 image tokens at 3..6) given as embeddings, with their M-RoPE
    positions."""
    rng = np.random.default_rng(6)
    cfg = shared["cfg_j"]
    img, toks = _image_inputs(rng, cfg)
    lens = (20, 13, 9)
    if not mrope:
        seqs = [rng.integers(0, cfg.llm.vocab, size=(n,)) for n in lens]
        return seqs, seqs, None, None
    ej, _, _ = _embeds_j(shared, img, toks)
    et, _, _ = _embeds_t(shared, img, toks)
    pos = [JQ2.mrope_positions(toks[:, :n], cfg.image_token_id,
                               grid_thw=(1, 4, 4)) for n in lens]
    return ([ej[:, :n] for n in lens], [et[:, :n] for n in lens], pos,
            [torch.from_numpy(p) for p in pos])


@pytest.mark.parametrize("mrope", [False, True])
def test_generate_batch_matches_jax(shared, mrope):
    """Ragged left-padded batch (3 prompts, 8 new tokens) through each
    package's ``Generator.generate_batch``: token ids equal."""
    seqs_j, seqs_t, pos_j, pos_t = _ragged_prompts(shared, mrope)
    gj = JGenerator(shared["cfg_j"].llm, shared["params_j"]["llm"],
                    specs=shared["specs_j"], state=shared["state_j"],
                    mode="real", max_len=64)
    gt = TGenerator(shared["cfg_t"].llm, shared["params_t"]["llm"],
                    specs=shared["specs_t"], state=shared["state_t"],
                    mode="real", max_len=64)
    oj = gj.generate_batch(seqs_j, max_new_tokens=8, positions=pos_j)
    ot = gt.generate_batch(seqs_t, max_new_tokens=8, positions=pos_t)
    assert [len(o) for o in ot] == [8, 8, 8]
    assert ot == oj
    # and each row decodes as it would alone
    for i, s in enumerate(seqs_t):
        x = s if mrope else torch.from_numpy(s)[None]
        alone = gt.generate_on_device(
            x, 8, positions=None if pos_t is None else pos_t[i])
        assert alone[0].tolist() == ot[i]


def test_generate_batch_trims_at_eos(shared):
    seqs, _, _, _ = _ragged_prompts(shared, False)
    gt = TGenerator(shared["cfg_t"].llm, shared["params_t"]["llm"],
                    specs=shared["specs_t"], state=shared["state_t"],
                    mode="real", max_len=64)
    free = gt.generate_batch(seqs, max_new_tokens=6)
    eos = free[0][2]
    out = gt.generate_batch(seqs, max_new_tokens=6, eos_id=eos)
    for f, o in zip(free, out):
        assert o == (f[:f.index(eos)] if eos in f else f)
