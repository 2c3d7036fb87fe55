"""The port's tensor parallelism (``mquant_tpu_torch.parallel``) against the
JAX package's mesh (``tests/test_sharding.py``), on the CPU.

The parent process computes JAX's references on conftest's 8-device CPU
mesh; one spawn of four gloo ranks (``torch_tp_ranks.forward_jobs``, no JAX
there) returns the port's outputs as numpy, with meshes of tp = 4 and of
(dp 2, tp 2) made over the same four ranks. Tolerances:

* real mode (W8A8 dynamic, the main path's W4A8 static storage with the
  block Hadamard and RMS split, path F's full Hadamard and path S's split
  behind it, an int8 head over an uneven vocabulary): bit-equal to the
  single-rank port (the int32 accumulators are summed across ranks before
  one epilogue), tokens equal to JAX's Generator; W8A8 also within 2e-3 of
  JAX, as ``tests/test_sharding.py`` holds JAX's mesh to its single device;
* fp mode: within 2e-4 of JAX single-device (f32 partials summed across
  ranks in another order), as JAX's own mesh test;
* offline GPTQ: ``hessian_dp`` within rel 1e-5 of JAX's; the sharded walk
  bit-equal to the port's single-rank walk, and on JAX's U equal to JAX's
  walk under ``tests/test_torch_gptq.py``'s rule (≥ 99.9% of codes equal,
  none more than one step apart, the scales bit-equal); realize bit-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from mquant_tpu.core.quant import QuantParams as JQP
from mquant_tpu.gptq import core as JG
from mquant_tpu.gptq.sharded import hessian_dp as j_hessian_dp
from mquant_tpu.kernels import qmm as JQ
from mquant_tpu.models import layers as JL
from mquant_tpu.models import llm as JLLM
from mquant_tpu.models.registry import get_family as j_family
from mquant_tpu.parallel import sharding as JS
from mquant_tpu.pipeline import QuantizeConfig as JQC
from mquant_tpu.pipeline import build_specs as j_build_specs
from mquant_tpu.pipeline import synthetic_calib_batches
from mquant_tpu.serve.generate import Generator as JGenerator
from mquant_tpu.transform import recipes as JR
from mquant_tpu_torch import interop
from mquant_tpu_torch.kernels import qmm as TQMM
from mquant_tpu_torch.models import layers as TL
from mquant_tpu_torch.models import llm as TLLM
from mquant_tpu_torch.models.registry import get_family as t_family
from mquant_tpu_torch.parallel import sharding as TS

import torch_tp_ranks as R
from torch_threads import _one_torch_thread  # noqa: F401

FAMILIES = ["qwen2vl", "qwenvl", "internvl", "minicpmv", "glm4v"]
FP_CFG = dict(vocab=64, hidden=32, n_layers=2, n_heads=4, intermediate=64)
W4_CFG = dict(vocab=250, hidden=64, n_layers=2, n_heads=4, n_kv_heads=2,
              intermediate=512)
# the main path's three storages: (online Hadamard, RMS split, tp sizes)
W4_PATHS = {"block": ("block", True, (2, 4)), "F": ("full", False, (2,)),
            "S": ("full", True, (2,))}
NEW_TOKENS = 6
GPTQ_CASES = [(False, None, True), (True, 16, True), (False, 16, False)]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jspec(s):
    return JL.SiteSpec(**dataclasses.asdict(s))


def _tspec(s):
    return TL.SiteSpec(**dataclasses.asdict(s))


def _flat(tree, path=""):
    out = {}
    for k, v in tree.items():
        p = f"{path}.{k}" if path else k
        if isinstance(v, dict):
            out.update(_flat(v, p))
        else:
            out[p] = v
    return out


# ---------------------------------------------------------------------------
# inputs and JAX's references
# ---------------------------------------------------------------------------


def _w4_tree(seed: int, split: bool):
    """The main path's storage at tiny widths (``random_init.init_w4a8``'s
    layout): W4 codes in int8 storage, per-channel scales, q / k / v
    biases, an int8 head, static activation scales; ``split``: ``down`` as
    ``w_col0`` plus rows 1..I−1."""
    rng = np.random.default_rng(seed)
    c = W4_CFG
    L, Hd, I, V = c["n_layers"], c["hidden"], c["intermediate"], c["vocab"]
    hd = Hd // c["n_heads"]
    H, KV = c["n_heads"], c["n_kv_heads"]

    def site(din, dout, bias=False):
        d = {"w_q": rng.integers(-7, 8, (L, din, dout)).astype(np.int8),
             "w_scale": rng.uniform(0.005, 0.015, (L, dout)).astype(
                 np.float32)}
        if bias:
            d["b"] = (rng.normal(size=(L, dout)) * 0.1).astype(np.float32)
        return d

    lay = {"ln1": {"w": np.ones((L, Hd), np.float32)},
           "q": site(Hd, H * hd, True), "k": site(Hd, KV * hd, True),
           "v": site(Hd, KV * hd, True), "o": site(H * hd, Hd),
           "ln2": {"w": np.ones((L, Hd), np.float32)},
           "gate": site(Hd, I), "up": site(Hd, I), "down": site(I, Hd)}
    if split:
        d = lay["down"]
        d["w_col0"] = (d["w_q"][:, :1].astype(np.float32) * 0.01)
        d["w_q"] = np.ascontiguousarray(d["w_q"][:, 1:])
    params = {"embed": {"w": (rng.normal(size=(V, Hd)) * 0.5).astype(
                  np.float32)},
              "layers": lay, "ln_f": {"w": np.ones((Hd,), np.float32)},
              "lm_head": {"w_q": rng.integers(-127, 128, (Hd, V)).astype(
                  np.int8), "w_scale": np.full((V,), 2e-3, np.float32)}}
    state = {f"llm.{n}": {"act": ("qp", np.full((L,), 0.05, np.float32),
                                  None)} for n in TLLM.LLM_SITES}
    state["llm.lm_head"] = {"act": ("qp", np.float32(0.05), None)}
    return params, state


def _jstate(state):
    return {k: {"act": JQP(jnp.asarray(v["act"][1]))}
            for k, v in state.items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's references, then the four ranks' outputs."""
    ref, pl = {}, {"fp": {}, "w4": {}, "families": {}}
    toks = np.asarray(jax.random.randint(jax.random.key(1), (4, 8), 0, 64))
    for kv in (4, 2):
        cfg = JLLM.DecoderConfig(**FP_CFG, n_kv_heads=kv, dtype=jnp.float32)
        params = JLLM.init_decoder_params(cfg, jax.random.key(0))
        ref[f"fp/kv{kv}"] = np.asarray(JLLM.decoder_forward(cfg, params,
                                                            toks)[0])
        pl["fp"][f"kv{kv}"] = dict(cfg={**FP_CFG, "n_kv_heads": kv},
                                   params=_np_tree(params), toks=toks)

    # W8A8 real with dynamic scales (JAX's test_quantized_params_sharding)
    cfg = JLLM.DecoderConfig(**FP_CFG, n_kv_heads=4, dtype=jnp.float32)
    params = JLLM.init_decoder_params(cfg, jax.random.key(0))
    jspecs = {f"llm.{n}": JL.SiteSpec(w_bits=8, a_bits=8)
              for n in JLLM.LLM_SITES}
    qp = JR.realize_decoder_weights(params, jspecs)
    ref["w8"] = np.asarray(JLLM.decoder_forward(cfg, qp, toks, specs=jspecs,
                                                mode="real")[0])
    pl["w8"] = dict(cfg={**FP_CFG, "n_kv_heads": 4}, params=_np_tree(qp),
                    fparams=_np_tree(params), toks=toks,
                    specs={k: _tspec(v) for k, v in jspecs.items()})
    # the same sites fake-quantized (float weights, dynamic scales)
    ref["w8fake"] = np.asarray(JLLM.decoder_forward(
        cfg, params, toks, specs=jspecs, mode="fake")[0])

    # the main path's W4A8 storages: JAX's Generator tokens
    from mquant_tpu_torch import random_init as RI

    wtoks = np.random.default_rng(7).integers(0, 250, (2, 12))
    for name, (had, split, tps) in W4_PATHS.items():
        params, state = _w4_tree(3, split)
        specs = RI.llm_specs(had, split=split)
        jcfg = JLLM.DecoderConfig(**W4_CFG, dtype=jnp.float32)
        g = JGenerator(jcfg, jax.tree.map(jnp.asarray, params),
                       specs={k: _jspec(v) for k, v in specs.items()},
                       state=_jstate(state), mode="real", max_len=64)
        ref[f"w4/{name}"] = np.asarray(g.generate_on_device(
            jnp.asarray(wtoks[:1]), max_new_tokens=NEW_TOKENS))
        pl["w4"][name] = dict(cfg=W4_CFG, params=params, state=state,
                              had=had, split=split, toks=wtoks, tps=tps,
                              new=NEW_TOKENS)

    # prefill + 3 decode steps (JAX's test_tp_prefill_decode)
    cfg = JLLM.DecoderConfig(**FP_CFG, n_kv_heads=4, dtype=jnp.float32)
    params = JLLM.init_decoder_params(cfg, jax.random.key(0))
    stoks = jax.random.randint(jax.random.key(1), (2, 8), 0, cfg.vocab)
    cache = JLLM.init_cache(cfg, 2, 16)
    logits, cache, _ = JLLM.decoder_forward(cfg, params, stoks, cache=cache,
                                            prefill_fresh=True)
    tok = jnp.argmax(logits[:, -1:], axis=-1)
    steps = []
    for _ in range(3):
        logits, cache, _ = JLLM.decoder_forward(cfg, params, tok, cache=cache)
        tok = jnp.argmax(logits[:, -1:], axis=-1)
        steps.append(np.asarray(tok))
    ref["steps"] = steps
    pl["steps"] = dict(cfg={**FP_CFG, "n_kv_heads": 4},
                       params=_np_tree(params), toks=np.asarray(stoks))

    # every family's tiny model (JAX's TestAllFamiliesTP)
    for fname in FAMILIES:
        fam = j_family(fname)
        cfg = fam.tiny_fn()
        params = fam.init_fn(cfg, jax.random.key(0))
        specs = j_build_specs(fam, JQC(llm_static=False,
                                       visual_static=False))
        batch = synthetic_calib_batches(fam, cfg, 1, jax.random.key(1))[0]
        extra = {k: v for k, v in batch.items()
                 if k not in ("tokens", "patches")}
        ref[f"family/{fname}"] = np.asarray(fam.forward_fn(
            cfg, params, batch["tokens"], batch.get("patches"), mode="fp",
            **extra)[0], np.float32)
        pl["families"][fname] = dict(
            params=_np_tree(params), tokens=np.asarray(batch["tokens"]),
            patches=np.asarray(batch["patches"]),
            extra={k: v if isinstance(v, tuple) else np.asarray(v)
                   for k, v in extra.items()},
            specs={k: _tspec(v) for k, v in specs.items()})

    pl["gptq"], ref["gptq"] = _gptq_inputs()
    out = R.spawn("forward_jobs", pl, 4, tmp_path_factory.mktemp("tp"))
    return ref, out


def _gptq_problem(n_in=192, n_out=48, ns=256):
    rng = np.random.default_rng(3)
    X = rng.standard_normal((8, ns // 8, n_in)).astype(np.float32)
    W = (rng.standard_normal((n_in, n_out)) * 0.05).astype(np.float32)
    return X, W


def _gptq_inputs():
    X, W = _gptq_problem()
    mesh = JS.make_mesh(8, tp=4)
    ref = {"H_dp": np.asarray(j_hessian_dp(jnp.asarray(X), mesh))}
    H = np.asarray(JG.accumulate_hessian(None, jnp.asarray(X)))
    cases = []
    for i, (act_order, gs, sym) in enumerate(GPTQ_CASES):
        perm = (np.argsort(-np.diag(H), kind="stable") if act_order
                else None)
        Hp = H if perm is None else H[perm][:, perm]
        Uj = np.asarray(JG._hinv_cholesky(jnp.asarray(Hp), 0.01))
        rj = JG.gptq_quantize_matrix(jnp.asarray(W), jnp.asarray(H), bits=4,
                                     act_order=act_order, group_size=gs,
                                     sym=sym)
        ref[f"walk{i}"] = {"w": np.asarray(rj.w),
                           "scale": np.asarray(rj.scale),
                           "zero": None if rj.zero is None
                           else np.asarray(rj.zero)}
        cases.append(dict(act_order=act_order, group_size=gs, sym=sym,
                          Uj=Uj, perm=None if perm is None
                          else perm.astype(np.int64),
                          diag=np.ascontiguousarray(np.diag(Hp))))
    real = jax.jit(lambda w: JQ.quantize_weights_real(w, 4, pack=True))(
        jnp.asarray(W))
    ref["realize"] = {k: np.asarray(v) for k, v in real.items()}
    return dict(X=X.reshape(-1, X.shape[-1]), W=W, cases=cases), ref


# ---------------------------------------------------------------------------
# specs and slices (no process group)
# ---------------------------------------------------------------------------


def _realized_trees(pack: bool):
    cfg = JLLM.DecoderConfig(**FP_CFG, n_kv_heads=4, dtype=jnp.float32)
    params = JLLM.init_decoder_params(cfg, jax.random.key(0))
    specs = {f"llm.{n}": JL.SiteSpec(w_bits=4, a_bits=8, a_static=True)
             for n in JLLM.LLM_SITES}
    return cfg, JR.realize_decoder_weights(params, specs, pack_int4=pack)


@pytest.mark.parametrize("fname", FAMILIES + ["decoder_w4", "decoder_w8"])
def test_spec_trees_equal_jax(fname):
    """Every leaf's spec (its tp axis, or replication) equals JAX's, for
    every family's tiny tree and for realized decoders (``w_q`` /
    ``w_scale`` inherit ``w``'s cut)."""
    if fname.startswith("decoder"):
        cfg = JLLM.DecoderConfig(**FP_CFG, n_kv_heads=4, dtype=jnp.float32)
        params = JLLM.init_decoder_params(cfg, jax.random.key(0))
        bits = 4 if fname.endswith("w4") else 8
        specs = {f"llm.{n}": JL.SiteSpec(w_bits=bits, a_bits=8)
                 for n in JLLM.LLM_SITES}
        jp = JR.realize_decoder_weights(params, specs, pack_int4=bits == 4)
        jspec, tp = JS.decoder_param_specs(jp), TS.decoder_param_specs(
            interop.to_torch(jp, device="cpu"))
    else:
        fam = j_family(fname)
        jp = fam.init_fn(fam.tiny_fn(), jax.random.key(0))
        jspec = JS.vlm_param_specs(jp)
        tp = TS.vlm_param_specs(interop.to_torch(jp, device="cpu"))
    fj = jax.tree_util.tree_flatten_with_path(
        jspec, is_leaf=lambda x: isinstance(x, JP) or x is None)[0]
    fj = {jax.tree_util.keystr(k): v for k, v in fj}
    ft = {}

    def walk(t, path):
        for k, v in t.items():
            p = f"{path}['{k}']"
            if isinstance(v, dict):
                walk(v, p)
            else:
                ft[p] = v

    walk(tp, "")
    assert set(fj) == set(ft)
    for k in fj:
        assert (None if fj[k] is None else tuple(fj[k])) == (
            None if ft[k] is None else tuple(ft[k])), k


def _jax_shards(tree, r):
    """Leaf → JAX's shard on the device at (dp 0, tp r) of the (2, 4) mesh."""
    mesh = JS.make_mesh(8, tp=4)
    dev = mesh.devices[0, r]
    sp = JS.shard_params(tree, mesh, JS.vlm_param_specs(tree) if "llm" in tree
                         else JS.decoder_param_specs(tree))
    out = {}
    for k, v in _flat(sp).items():
        if v is None:
            continue
        (sh,) = [s for s in v.addressable_shards if s.device == dev]
        out[k] = np.asarray(sh.data)
    return out


@pytest.mark.parametrize("what", ["decoder", "realized_w8", "realized_w4",
                                  "qwen2vl", "glm4v", "qwenvl"])
def test_slices_equal_jax_shards(what):
    """Rank r's slice of every leaf equals JAX's tp shard r bit for bit;
    packed W4 rows of a row-parallel site compared as unpacked codes (the
    port cuts the code rows, JAX the packed byte rows)."""
    if what == "decoder":
        cfg = JLLM.DecoderConfig(**FP_CFG, n_kv_heads=4, dtype=jnp.float32)
        jp = JLLM.init_decoder_params(cfg, jax.random.key(0))
    elif what.startswith("realized"):
        cfg = JLLM.DecoderConfig(**FP_CFG, n_kv_heads=4, dtype=jnp.float32)
        params = JLLM.init_decoder_params(cfg, jax.random.key(0))
        bits = 4 if what.endswith("w4") else 8
        specs = {f"llm.{n}": JL.SiteSpec(w_bits=bits, a_bits=8)
                 for n in JLLM.LLM_SITES}
        jp = JR.realize_decoder_weights(params, specs, pack_int4=bits == 4)
    else:
        fam = j_family(what)
        cfg = fam.tiny_fn()
        jp = fam.init_fn(cfg, jax.random.key(0))
    tp_tree = interop.to_torch(jp, device="cpu")
    tcfg = (t_family(what).tiny_fn() if what in FAMILIES
            else TLLM.DecoderConfig(**FP_CFG, n_kv_heads=4,
                                    dtype=torch.float32))
    full = {k: np.asarray(v) for k, v in _flat(jp).items() if v is not None}
    for r in range(4):
        mine = TS.shard_params(tp_tree, TS.slice_mesh(r, 4), cfg=None
                               if what in FAMILIES else tcfg)
        theirs = _jax_shards(jp, r)
        flat = _flat(mine)
        assert set(flat) == set(theirs) | {k for k, v in flat.items()
                                           if v is None}
        for k, v in theirs.items():
            m = flat[k].numpy()
            packed_row = (what == "realized_w4" and k.endswith("w_q")
                          and (".o." in k or ".down." in k))
            if packed_row:
                u = np.asarray(JQ.unpack_int4_weights({"w_q": jnp.asarray(
                    full[k])}))
                n = u.shape[-2] // 4
                np.testing.assert_array_equal(
                    TQMM.unpack_int4_weights({"w_q": flat[k]}).numpy(),
                    u[..., r * n:(r + 1) * n, :], err_msg=k)
            else:
                np.testing.assert_array_equal(m, v, err_msg=k)


def test_kv_heads_replicate_past_n_kv():
    """tp = 4 over 2 KV heads: rank r holds KV head r // 2 whole (q heads
    [r, r + 1) read it), where JAX's even cut would give half a head."""
    cfg = TLLM.DecoderConfig(**FP_CFG, n_kv_heads=2, dtype=torch.float32)
    params = TLLM.init_decoder_params(cfg, torch.Generator().manual_seed(0),
                                      device="cpu")
    hd = cfg.head_dim
    lc = TS.local_config(cfg, TS.slice_mesh(0, 4))
    assert (lc.n_heads, lc.n_kv_heads, lc.intermediate) == (1, 1, 16)
    # attn_decode plans a rank's splits for the whole model's 2 KV heads
    assert TS.whole_kv_heads(lc, TS.slice_mesh(0, 4)) == 2
    for r in range(4):
        sp = TS.shard_params(params, TS.slice_mesh(r, 4), cfg=cfg)
        h = r // 2
        for n in ("k", "v"):
            np.testing.assert_array_equal(
                sp["layers"][n]["w"].numpy(),
                params["layers"][n]["w"][..., h * hd:(h + 1) * hd].numpy())
        np.testing.assert_array_equal(
            sp["layers"]["q"]["w"].numpy(),
            params["layers"]["q"]["w"][..., r * hd:(r + 1) * hd].numpy())


def test_split_and_vocab_cuts():
    """The RMS split's ``down`` cuts over the original K (rank 0 holds
    channel 0 as ``w_col0``, K / tp − 1 rows; the others K / tp), every rank
    keeps ``w_col0``; an uneven vocabulary pads to 16 · tp columns (zero
    codes, unit scales)."""
    params, _ = _w4_tree(3, split=True)
    tree = R.tree_to_torch(params)
    I = W4_CFG["intermediate"]
    cfg = TLLM.DecoderConfig(**W4_CFG, dtype=torch.float32)
    for tp in (2, 4):
        n = I // tp
        rows = []
        for r in range(tp):
            d = TS.shard_params(tree, TS.slice_mesh(r, tp), cfg=cfg)
            dn = d["layers"]["down"]
            rows.append(dn["w_q"])
            assert dn["w_q"].shape[-2] == (n - 1 if r == 0 else n)
            np.testing.assert_array_equal(dn["w_col0"].numpy(),
                                          params["layers"]["down"]["w_col0"])
            head = d["lm_head"]
            assert head["w_q"].shape[-1] == TS.vocab_padded(250, tp) // tp
        np.testing.assert_array_equal(torch.cat(rows, -2).numpy(),
                                      params["layers"]["down"]["w_q"])
        last = TS.shard_params(tree, TS.slice_mesh(tp - 1, tp), cfg=cfg)
        pad = TS.vocab_padded(250, tp) - 250
        assert (last["lm_head"]["w_q"][:, -pad:] == 0).all()
        assert (last["lm_head"]["w_scale"][-pad:] == 1).all()


def test_72b_local_config_and_shapes_divide_tp8():
    """Qwen2-VL-72B at tp = 8 without its memory (meta tensors, as JAX's
    test traces it abstractly): every cut width divides, the local shapes
    are the whole's over 8, one KV head a rank."""
    from mquant_tpu_torch.models.qwen2vl import Qwen2VLConfig

    cfg = Qwen2VLConfig.qwen2vl_72b()
    c = cfg.llm
    assert c.hidden == 8192 and c.n_layers == 80
    mesh = TS.slice_mesh(3, 8)
    lc = TS.local_config(cfg, mesh)
    assert (lc.llm.n_heads, lc.llm.n_kv_heads, lc.llm.intermediate) == (
        c.n_heads // 8, c.n_kv_heads // 8, c.intermediate // 8)
    assert lc.vit.n_heads * 8 == cfg.vit.n_heads
    Lx, Hd, I, hd = c.n_layers, c.hidden, c.intermediate, c.head_dim

    def st(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")

    params = {"embed": {"w": st(c.vocab, Hd)},
              "layers": {"q": {"w": st(Lx, Hd, c.n_heads * hd)},
                         "k": {"w": st(Lx, Hd, c.n_kv_heads * hd)},
                         "o": {"w": st(Lx, c.n_heads * hd, Hd)},
                         "down": {"w": st(Lx, I, Hd)}},
              "lm_head": {"w": st(Hd, c.vocab)}}
    sp = TS.shard_params(params, mesh, cfg=c)
    lay = sp["layers"]
    assert lay["q"]["w"].shape[-1] == lc.llm.n_heads * hd
    assert lay["k"]["w"].shape[-1] == hd
    assert lay["o"]["w"].shape[-2] == lc.llm.n_heads * hd
    assert lay["down"]["w"].shape[-2] == lc.llm.intermediate
    assert sp["lm_head"]["w"].shape[-1] * 8 == TS.vocab_padded(c.vocab, 8)
    assert sp["embed"]["w"].shape == (c.vocab, Hd)


# ---------------------------------------------------------------------------
# what raises
# ---------------------------------------------------------------------------


def test_widths_tp_does_not_divide_raise():
    """The tiny ViT's 2 heads at tp = 4, and a width 3 ∤ 64, name what."""
    cfg = t_family("qwen2vl").tiny_fn()
    with pytest.raises(ValueError, match="vit.n_heads = 2"):
        TS.local_config(cfg, TS.slice_mesh(0, 4))
    with pytest.raises(ValueError, match="not divisible by tp = 3"):
        TS.local_config(cfg.llm, TS.slice_mesh(0, 3))
    params = {"layers": {"gate": {"w": torch.zeros((1, 4, 6))}}}
    with pytest.raises(ValueError, match="llm.layers.gate width = 6"):
        TS.shard_params(params, TS.slice_mesh(0, 4))


def test_paths_refused_under_a_mesh():
    """Calibration, the group-blocked storage of path A and int8 / int4 KV
    raise under a mesh, before any collective."""
    cfg = TLLM.DecoderConfig(**FP_CFG, n_kv_heads=4, dtype=torch.float32)
    params = TLLM.init_decoder_params(cfg, torch.Generator().manual_seed(0),
                                      device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    mesh = TS.slice_mesh(0, 2)
    with TS.set_mesh(mesh):
        with pytest.raises(NotImplementedError, match="calibration"):
            TLLM.decoder_forward(cfg, params, toks, mode="calib",
                                 collect_stats=True)
        for kv in (8, 4):
            with pytest.raises(NotImplementedError, match="K8 / K4"):
                TLLM.init_cache(cfg, 1, 16, device="cpu", quantized=kv)
        spec = TL.SiteSpec(w_bits=4, a_bits=8)
        p = {"w_q": torch.zeros((1, 8, 4), dtype=torch.int8),
             "w_scale": torch.ones((1, 2, 4)),
             "w_zp": torch.zeros((1, 2, 4))}
        for name in ("llm.q", "llm.o"):
            with pytest.raises(NotImplementedError, match="path A"):
                TL.qlinear(torch.zeros((1, 2, 8)), TLLM.layer_views(p, 0),
                           name, spec, None, "real")
        with pytest.raises(NotImplementedError, match="path A"):
            TL.qlinear_group(torch.zeros((1, 2, 8)),
                             [TLLM.layer_views(p, 0)] * 2,
                             ["llm.gate", "llm.up"],
                             {"llm.gate": spec, "llm.up": spec}, None,
                             "real")


# ---------------------------------------------------------------------------
# the spawned ranks against JAX
# ---------------------------------------------------------------------------


def test_make_mesh_shapes(run):
    """Four ranks: tp = 4 is one row, tp = 2 two rows of two (JAX's
    ``make_mesh(8, tp=4)`` / ``(8)`` shapes, at four ranks); rank 0 sits
    at (0, 0) of both."""
    _, out = run
    assert out["mesh_shapes"] == {4: {"dp": 1, "tp": 4},
                                  2: {"dp": 2, "tp": 2}}
    assert out["mesh_index"] == {4: (0, 0), 2: (0, 0)}


@pytest.mark.parametrize("kv", [4, 2])
def test_fp_decoder_tp4_matches_jax(run, kv):
    ref, out = run
    np.testing.assert_allclose(out[f"fp/kv{kv}"], ref[f"fp/kv{kv}"],
                               rtol=2e-4, atol=2e-4)


def test_w8a8_dynamic_tp4_matches_jax_and_single_rank(run):
    """Per-token dynamic scales at the row-parallel sites: the local row's
    min / max maximized across ranks, so the codes are the single rank's."""
    ref, out = run
    np.testing.assert_array_equal(out["w8/tp"], out["w8/solo"])
    np.testing.assert_allclose(out["w8/tp"], ref["w8"], rtol=2e-3,
                               atol=2e-3)


def test_w8a8_dynamic_fake_tp4_matches_jax_and_single_rank(run):
    """Fake mode at the row-parallel sites: the whole row's dynamic scales
    on the local columns, the float partials summed in f32 (JAX's
    tolerance, against JAX and the single rank)."""
    ref, out = run
    np.testing.assert_allclose(out["w8fake/tp"], out["w8fake/solo"],
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out["w8fake/tp"], ref["w8fake"], rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("name", list(W4_PATHS))
def test_w4a8_main_path_bit_equal_and_jax_tokens(run, name):
    """Block (+ RMS split) at tp = 2 and 4, path F's full Hadamard and path
    S's split at tp = 2, the int8 head over 250 → 256 padded columns:
    logits bit-equal to the single rank, greedy tokens JAX's."""
    ref, out = run
    for tp in W4_PATHS[name][2]:
        np.testing.assert_array_equal(out[f"w4/{name}/tp{tp}"],
                                      out[f"w4/{name}/solo"])
        assert out[f"w4/{name}/tp{tp}"].shape[-1] == 250
        np.testing.assert_array_equal(out[f"w4/{name}/tokens{tp}"],
                                      ref[f"w4/{name}"])


def test_prefill_decode_tp4_matches_jax(run):
    ref, out = run
    for a, b in zip(out["steps"], ref["steps"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fname", FAMILIES)
def test_families_tp2_match_jax(run, fname):
    """Every family's whole tree (tower, merger / resampler / projector,
    decoder) at tp = 2: fp within 2e-4 of JAX single-device, fake mode
    finite."""
    ref, out = run
    np.testing.assert_allclose(out[f"family/{fname}"], ref[f"family/{fname}"],
                               rtol=2e-4, atol=2e-4)
    assert out[f"family/{fname}/fake_finite"]


def test_hessian_dp_matches_jax(run):
    ref, out = run
    H = ref["gptq"]["H_dp"]
    np.testing.assert_allclose(out["H_dp"], H, rtol=1e-5,
                               atol=1e-5 * np.abs(H).max())


@pytest.mark.parametrize("i", range(len(GPTQ_CASES)))
def test_sharded_walk_equals_solo_and_jax(run, i):
    """The column-sharded walk over 4 ranks is bit-equal to the single-rank
    walk on the same H; on JAX's U it holds to JAX's walk by
    ``tests/test_torch_gptq.py``'s rule."""
    ref, out = run
    shd, solo = out[f"walk{i}"], out[f"solo{i}"]
    assert not shd["fallback"]
    for k in ("w", "scale", "zero", "perm"):
        if solo[k] is None:
            assert shd[k] is None
        else:
            np.testing.assert_array_equal(shd[k], solo[k], err_msg=k)
    rj, rt = ref["gptq"][f"walk{i}"], out[f"walkU{i}"]
    np.testing.assert_array_equal(rt["scale"], rj["scale"])
    if rj["zero"] is not None:
        np.testing.assert_array_equal(rt["zero"], rj["zero"])

    def codes(w, s, z):
        s = np.repeat(s, w.shape[0] // s.shape[0], axis=0)
        q = np.round(np.asarray(w, np.float64) / s)
        return q if z is None else q + np.repeat(z, w.shape[0] // z.shape[0],
                                                 0)

    act_order = GPTQ_CASES[i][0]
    wj, wt = rj["w"], rt["w"]
    if act_order:
        perm = out[f"solo{i}"]["perm"]
        wj, wt = wj[perm], wt[perm]
    cj, ct = codes(wj, rj["scale"], rj["zero"]), codes(wt, rt["scale"],
                                                       rt["zero"])
    assert (cj == ct).mean() >= 0.999
    assert np.abs(cj - ct).max() <= 1


def test_realize_under_mesh_equals_solo_and_jax(run):
    ref, out = run
    for k, v in out["realize_solo"].items():
        np.testing.assert_array_equal(out["realize_tp"][k], v, err_msg=k)
    np.testing.assert_array_equal(out["realize_tp"]["w_q"],
                                  ref["gptq"]["realize"]["w_q"])
