"""The RMS first-column split and the full online Hadamard before ``down``
in the port, against the JAX package (CPU; numpy weights from fixed seeds,
handed to both packages).

Split storage keeps channel 0 of ``down``'s rotated input in floating point:
``w_col0`` (…, 1, out) in f32 and the W4 codes of rows 1..n−1 in int8
storage (n − 1 rows, odd, so they stay unpacked). Tolerances: the integer
products are exact in both packages, the float ops around them sum in other
orders, so outputs are held to 1e-5 of their largest magnitude and greedy
tokens must be equal (as ``tests/test_torch_slice.py``).
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mquant_tpu.core.quant import QuantParams as JQP
from mquant_tpu.models import layers as JL
from mquant_tpu.models import llm as JLLM
from mquant_tpu.models import qwen2vl as JQ2
from mquant_tpu.serve.generate import Generator as JGenerator
from mquant_tpu_torch import interop
from mquant_tpu_torch import random_init as R
from mquant_tpu_torch.core.quant import QuantParams as TQP
from mquant_tpu_torch.models import layers as TL
from mquant_tpu_torch.models import llm as TLLM
from mquant_tpu_torch.models import qwen2vl as TQ2
from mquant_tpu_torch.serve.generate import Generator as TGenerator

RTOL = 1e-5


def _t(a):
    return interop.array_to_torch(a, device="cpu")


def _close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=0,
                               atol=RTOL * np.abs(j).max())


def _site(rng, n, out, split, bias=True):
    d = {"w_q": rng.integers(-7, 8, size=(n - split, out)).astype(np.int8),
         "w_scale": (rng.uniform(0.5, 1.5, size=(out,)) * 0.03
                     ).astype(np.float32)}
    if bias:
        d["b"] = (rng.normal(size=(out,)) * 0.1).astype(np.float32)
    if split:
        d["w_col0"] = (rng.integers(-7, 8, size=(1, out)) * 0.03
                       ).astype(np.float32)
    return d


@pytest.mark.parametrize("had", [None, "full"])
def test_qlinear_split_matches_jax(had):
    """Real mode: Hadamard → split → int8 → GEMM at K = n − 1 → + x0·w_col0
    in f32 → bias."""
    rng = np.random.default_rng(1)
    n, out = 96, 40
    x = rng.normal(size=(2, 5, n)).astype(np.float32)
    p = _site(rng, n, out, split=True)
    kw = dict(w_bits=4, a_bits=8, a_static=True, online_had=had, split=True)
    yj = JL.qlinear(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                    "llm.down", JL.SiteSpec(**kw),
                    {"llm.down": {"act": JQP(jnp.float32(0.02))}}, "real")
    yt = TL.qlinear(_t(x), {k: _t(v) for k, v in p.items()}, "llm.down",
                    TL.SiteSpec(**kw),
                    {"llm.down": {"act": TQP(torch.tensor(0.02))}}, "real")
    assert yt.shape == (2, 5, out)
    _close(yt, yj)


def test_qlinear_split_padded_codes_match_jax(monkeypatch):
    """Path S at a prefill (more than 32 tokens): the split's codes (K =
    n − 1 = 95) are written into rows padded to 96 bytes, which the GEMM
    takes in place (no copy), and they are JAX's codes: the int32 product
    bit-equal to JAX's codes against the weight, the output within RTOL."""
    from mquant_tpu.kernels import qmm as JK
    from mquant_tpu_torch.kernels import qmm as TK

    rng = np.random.default_rng(4)
    n, out, T = 96, 40, 77
    x = rng.normal(size=(1, T, n)).astype(np.float32)
    p = _site(rng, n, out, split=True)
    kw = dict(w_bits=4, a_bits=8, a_static=True, online_had="full",
              split=True)
    seen_j, seen_t = [], []
    jpre = JK.quantized_matmul_pre
    monkeypatch.setattr(JK, "quantized_matmul_pre", lambda xq, *a, **k: (
        seen_j.append(np.asarray(xq)), jpre(xq, *a, **k))[1])
    tgemm = TK.KERNELS["int8_gemm"]
    monkeypatch.setitem(TK.KERNELS, "int8_gemm", lambda xq, *a, **k: (
        seen_t.append(xq), tgemm(xq, *a, **k))[1])
    yj = JL.qlinear(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                    "llm.down", JL.SiteSpec(**kw),
                    {"llm.down": {"act": JQP(jnp.float32(0.02))}}, "real")
    yt = TL.qlinear(_t(x), {k: _t(v) for k, v in p.items()}, "llm.down",
                    TL.SiteSpec(**kw),
                    {"llm.down": {"act": TQP(torch.tensor(0.02))}}, "real")
    (xq,), (xj,) = seen_t, seen_j
    assert xq.shape == (T, n - 1) and xq.stride() == (96, 1)
    acc = TK.int8_gemm_ref(xq, torch.ones(T), _t(p["w_q"]), torch.ones(out),
                           torch.int32)
    np.testing.assert_array_equal(
        acc.numpy(), xj.reshape(T, n - 1).astype(np.int64)
        @ p["w_q"].astype(np.int64))
    _close(yt, yj)


def test_qlinear_split_fp_recombine_matches_jax():
    """fp mode: w_col0 rejoins ``w`` as its first input row."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 24)).astype(np.float32)
    p = {"w": rng.normal(size=(23, 8)).astype(np.float32),
         "w_col0": rng.normal(size=(1, 8)).astype(np.float32),
         "b": rng.normal(size=(8,)).astype(np.float32)}
    spec = dict(w_bits=4, a_bits=8, split=True)
    yj = JL.qlinear(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                    "s", JL.SiteSpec(**spec), None, "fp")
    yt = TL.qlinear(_t(x), {k: _t(v) for k, v in p.items()}, "s",
                    TL.SiteSpec(**spec), None, "fp")
    _close(yt, yj)


def test_split_storage_needs_split_spec():
    """Integer split storage with ``split`` off: the JAX function fails on
    the missing float ``w`` it would rejoin; the port says why."""
    rng = np.random.default_rng(3)
    p = _site(rng, 16, 8, split=True)
    spec = dict(w_bits=4, a_bits=8, a_static=True, split=False)
    x = rng.normal(size=(2, 16)).astype(np.float32)
    with pytest.raises(KeyError):
        JL.qlinear(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                   "s", JL.SiteSpec(**spec), None, "real")
    with pytest.raises(NotImplementedError, match="split"):
        TL.qlinear(_t(x), {k: _t(v) for k, v in p.items()}, "s",
                   TL.SiteSpec(**spec), None, "real")


def _specs(Spec, split):
    s = {f"llm.{n}": Spec(w_bits=4, a_bits=8, a_static=True)
         for n in JLLM.LLM_SITES}
    s["llm.down"] = dataclasses.replace(s["llm.down"], online_had="full",
                                        split=split)
    s["llm.lm_head"] = Spec(w_bits=8, a_bits=8, a_static=True)
    return s


def _llm(split, seed=0):
    """numpy params of the tiny Qwen2-VL decoder (W4 codes in int8 storage,
    int8 head; ``down`` split or not) and its JAX quant state."""
    c = JQ2.Qwen2VLConfig.tiny().llm
    rng = np.random.default_rng(seed)
    L, Hd, I, hd = c.n_layers, c.hidden, c.inter_eff, c.head_dim
    f32 = np.float32

    def stack(din, dout, bias, split_=False):
        sites = [_site(rng, din, dout, split_, bias) for _ in range(L)]
        return {k: np.stack([s[k] for s in sites]) for k in sites[0]}

    def ln(*shape):
        return {"w": (1 + 0.1 * rng.normal(size=shape)).astype(f32)}

    down = stack(I, Hd, False, split)
    down["b"] = None
    params = {
        "embed": {"w": rng.normal(size=(c.vocab, Hd)).astype(f32)},
        "layers": {
            "ln1": ln(L, Hd),
            "q": stack(Hd, c.n_heads * hd, True),
            "k": stack(Hd, c.n_kv_heads * hd, True),
            "v": stack(Hd, c.n_kv_heads * hd, True),
            "o": {**stack(c.n_heads * hd, Hd, False), "b": None},
            "ln2": ln(L, Hd),
            "gate": {**stack(Hd, I, False), "b": None},
            "up": {**stack(Hd, I, False), "b": None},
            "down": down,
        },
        "ln_f": ln(Hd),
        "lm_head": {"w_q": rng.integers(-127, 128, size=(Hd, c.vocab)
                                        ).astype(np.int8),
                    "w_scale": np.full((c.vocab,), 0.002, f32)},
    }
    state = {f"llm.{n}": {"act": JQP(jnp.full((L,), 0.03, jnp.float32))}
             for n in JLLM.LLM_SITES}
    state["llm.lm_head"] = {"act": JQP(jnp.float32(0.03))}
    return c, params, state


@pytest.fixture(scope="module", params=[False, True], ids=["full", "split"])
def tiny(request):
    split = request.param
    cfg_j, params_np, state_j = _llm(split)
    return dict(split=split, cfg_j=cfg_j, cfg_t=TQ2.Qwen2VLConfig.tiny().llm,
                params_j=jax.tree.map(jnp.asarray, params_np),
                params_t=interop.to_torch(params_np, device="cpu"),
                state_j=state_j,
                state_t=interop.to_torch(jax.tree.map(np.asarray, state_j),
                                         device="cpu"),
                specs_j=_specs(JL.SiteSpec, split),
                specs_t=_specs(TL.SiteSpec, split))


def test_tiny_decoder_full_mode_matches_jax(tiny):
    """decoder_forward over a 13-token prompt (below 256: the chain, in
    both packages) with the full Hadamard before ``down``."""
    toks = np.random.default_rng(4).integers(0, tiny["cfg_j"].vocab,
                                             size=(2, 13))
    lj, _, _ = JLLM.decoder_forward(tiny["cfg_j"], tiny["params_j"],
                                    jnp.asarray(toks), specs=tiny["specs_j"],
                                    state=tiny["state_j"], mode="real")
    lt, _, _ = TLLM.decoder_forward(tiny["cfg_t"], tiny["params_t"],
                                 torch.from_numpy(toks), specs=tiny["specs_t"],
                                 state=tiny["state_t"], mode="real")
    assert lt.shape == (2, 13, tiny["cfg_j"].vocab)
    _close(lt, lj)


def test_tiny_generator_full_mode_matches_jax(tiny):
    """8 greedy tokens through each package's Generator."""
    toks = np.random.default_rng(5).integers(0, tiny["cfg_j"].vocab,
                                             size=(1, 19))
    gj = JGenerator(tiny["cfg_j"], tiny["params_j"], specs=tiny["specs_j"],
                    state=tiny["state_j"], mode="real", max_len=64)
    gt = TGenerator(tiny["cfg_t"], tiny["params_t"], specs=tiny["specs_t"],
                    state=tiny["state_t"], mode="real", max_len=64)
    oj = gj.generate_on_device(jnp.asarray(toks), 8)
    ot = gt.generate_on_device(torch.from_numpy(toks), 8)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    down = gt.params["layers"]["down"]
    I = tiny["cfg_t"].inter_eff
    if tiny["split"]:  # odd rows stay int8, w_col0 passes through
        assert down["w_q"].shape[-2] == I - 1
        assert torch.equal(down["w_col0"],
                           tiny["params_t"]["layers"]["down"]["w_col0"])
    else:  # packed W4 bytes
        assert down["w_q"].shape[-2] == I // 2
    assert "w_q_fused" in gt.params["layers"]["gate"]


def test_interop_carries_w_col0_exactly():
    rng = np.random.default_rng(6)
    tree = {"down": _site(rng, 17, 5, split=True)}
    out = interop.to_torch(tree, device="cpu")
    for k, v in tree["down"].items():
        assert out["down"][k].dtype == torch.from_numpy(v).dtype
        np.testing.assert_array_equal(out["down"][k].numpy(), v)


def test_entry_points_default_to_card():
    """interop and init_cache put tensors on the card unless asked for the
    CPU; without a card the default raises instead of falling back."""
    for fn in (interop.to_torch, interop.array_to_torch, TLLM.init_cache):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    cfg = TQ2.Qwen2VLConfig.tiny().llm
    if torch.cuda.is_available():
        assert interop.array_to_torch(np.ones(3)).is_cuda
        assert TLLM.init_cache(cfg, 1, 4)["k"].is_cuda
        return
    with pytest.raises((RuntimeError, AssertionError)):
        interop.array_to_torch(np.ones(3))
    with pytest.raises((RuntimeError, AssertionError)):
        TLLM.init_cache(cfg, 1, 4)
    assert TLLM.init_cache(cfg, 1, 4, device="cpu")["k"].device.type == "cpu"


def test_random_init_full_and_split_specs():
    base = R.llm_specs()
    assert base["llm.down"].online_had == "block"
    assert base["llm.down"].head_dim == 128 and not base["llm.down"].split
    full = R.llm_specs("full")
    assert full["llm.down"].online_had == "full" and not full["llm.down"].split
    s = R.llm_specs("full", split=True)["llm.down"]
    assert s.online_had == "full" and s.split and s.a_static
    assert all(full[k] == base[k] for k in base if k != "llm.down")
    with pytest.raises(ValueError):
        R.llm_specs("head")
    cfg = TQ2.Qwen2VLConfig.tiny().llm
    d = R.init_split_down(cfg, torch.Generator().manual_seed(0), "cpu")
    L, Hd, I = cfg.n_layers, cfg.hidden, cfg.inter_eff
    assert d["w_q"].shape == (L, I - 1, Hd) and d["w_q"].dtype == torch.int8
    assert int(d["w_q"].abs().max()) <= 7
    assert d["w_col0"].shape == (L, 1, Hd)
    assert d["w_col0"].dtype == torch.float32
    # one more dequantized W4 row: codes times the per-channel scale
    assert float(d["w_col0"].abs().max()) <= 0.07 + 1e-7
    assert d["w_scale"].shape == (L, Hd)
