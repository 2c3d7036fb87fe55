"""The port's fused MLP tail and online Hadamard against the JAX package (CPU;
numpy inputs from fixed seeds for both packages).

* ``fused_swiglu_had_quant_ref`` (the plain version of the CUDA tail kernel)
  against JAX ``fused_swiglu_had_quant(interpret=True)``: int8 codes within
  ±1 and under 1% of them differing (the two sum the same f32 products in
  other orders and take sigmoid from other libraries, so a code on a
  rounding tie may land one step apart); and against JAX's unfused chain
  within ``TestFusedTail``'s own bound (±1, under 8%: the chain rounds
  swiglu to bf16 twice).
* ``_mlp_tail``'s fused branch at T = 256 against JAX's fused composition
  ``quantized_matmul_pre(fused_swiglu_had_quant(…), …)``: equal to the
  integer GEMM of its own codes, and within the bound that the differing
  codes allow.
* The routing of ``_mlp_tail``: which sites and prefill lengths take the
  fused kernel, recorded through a monkeypatched ``KERNELS`` entry. The
  fused branch is JAX's opt-in route (``MQUANT_FUSED_TAIL=1``), which these
  tests set; the default route is held in ``test_torch_tail_route.py``.
* ``online_hadamard`` on bf16 inputs against JAX within one bf16 ulp.
* f32 rows: the plain versions of the fused tail and ``had_quant`` against
  the JAX kernels on f32 inputs (the same rule), and the tail kernel's
  launch plan (``_tail_plan``): every token and sub-row once, the ring
  inside a block's shared memory.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mquant_tpu.core.formats import INT8
from mquant_tpu.core.quant import QuantParams as JQP
from mquant_tpu.core.quant import quantize as jquantize
from mquant_tpu.kernels import fwht as JF
from mquant_tpu.kernels import qmm as JK
from mquant_tpu.models import layers as JL
from mquant_tpu_torch import interop
from mquant_tpu_torch.core.quant import QuantParams as TQP
from mquant_tpu_torch.kernels import fwht as TF
from mquant_tpu_torch.models import layers as TL
from mquant_tpu_torch.models import llm as TLLM

SCALE = 0.05


def _t(a):
    return interop.array_to_torch(a, device="cpu")


def _bf16_pair(seed, T, n):
    """g, u (1, T, n) as bf16 numpy arrays (the same bits for both)."""
    rng = np.random.default_rng(seed)
    return [np.asarray(jnp.asarray(rng.normal(size=(1, T, n)), jnp.bfloat16))
            for _ in range(2)]


def _code_diff(a, b):
    d = np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
    return d.max(), (d > 0).mean()


# (18944, 256): the main path's n (hadK 148 ⊗ H₁₂₈) in two 128-token tiles
@pytest.mark.parametrize("n,T", [(96, 256), (512, 256), (2368, 512),
                                 (18944, 256)])
def test_tail_plain_matches_jax_kernel(n, T):
    g, u = _bf16_pair(n + T, T, n)
    ref = JF.fused_swiglu_had_quant(jnp.asarray(g), jnp.asarray(u),
                                    jnp.float32(SCALE), interpret=True)
    got = TF.fused_swiglu_had_quant_ref(_t(g), _t(u), torch.tensor(SCALE))
    assert got.dtype == torch.int8 and got.shape == (1, T, n)
    worst, frac = _code_diff(got.numpy(), ref)
    assert worst <= 1 and frac < 0.01, (worst, frac)
    # CPU tensors: the wrapper is the plain version, and launches nothing
    before = TF.LAUNCHES["fused_swiglu_had_quant"]
    np.testing.assert_array_equal(
        TF.fused_swiglu_had_quant(_t(g), _t(u), SCALE).numpy(), got.numpy())
    assert TF.LAUNCHES["fused_swiglu_had_quant"] == before


# f32 rows (ROADMAP B-c2): the JAX kernels cast g and u to f32 (an f32 g
# enters silu unrounded) and x to bf16; the port's kernel reads f32 rows
# the same way, so its plain version is held to JAX's on f32 inputs
@pytest.mark.parametrize("name", ["fused_swiglu_had_quant", "had_quant"])
@pytest.mark.parametrize("n,T", [(512, 256), (18944, 256)])
def test_tail_plain_matches_jax_kernel_f32(name, n, T):
    rng = np.random.default_rng(n + T + len(name))
    g, u = (rng.normal(size=(1, T, n)).astype(np.float32) for _ in range(2))
    if name == "had_quant":
        ref = JF.had_quant(jnp.asarray(g), jnp.float32(SCALE), interpret=True)
        got = TF.had_quant(_t(g), SCALE)
    else:
        ref = JF.fused_swiglu_had_quant(jnp.asarray(g), jnp.asarray(u),
                                        jnp.float32(SCALE), interpret=True)
        got = TF.fused_swiglu_had_quant(_t(g), _t(u), SCALE)
    assert got.dtype == torch.int8 and got.shape == (1, T, n)
    worst, frac = _code_diff(got.numpy(), ref)
    assert worst <= 1 and frac < 0.01, (worst, frac)


SMS = 132  # the H100's SMs


# sub-row bytes: one bf16 input (had_quant), a bf16 pair or one f32 input,
# an int32 or f32 pair
@pytest.mark.parametrize("sub_bytes", [256, 512, 1024])
@pytest.mark.parametrize("T", [1, 5, 255, 256, 1024, 4096])
@pytest.mark.parametrize("K", [148, 28, 4, 128, 160])
def test_tail_plan_covers_every_token_and_sub_row_once(K, T, sub_bytes):
    """``_tail_plan``: block b of the persistent grid takes tokens b,
    b + blocks, ... (the kernel's count: ceil((T − b) / blocks)), which
    covers every token once; a token's chunks of cs sub-rows cover its K
    sub-rows once; the ring's slots and the resident tiles fit a block's
    shared memory."""
    blocks, cs, slots = TF._tail_plan(T, K, sub_bytes, SMS)
    assert blocks == min(T, SMS)
    seen = np.zeros(T, np.int64)
    for b in range(blocks):
        ntok = (T - b + blocks - 1) // blocks
        assert ntok >= 1
        toks = b + blocks * np.arange(ntok)
        assert toks.max() < T
        seen[toks] += 1
    assert (seen == 1).all()
    nch = -(-K // cs)
    rows = np.zeros(K, np.int64)
    for c in range(nch):
        rows[c * cs:min(K, (c + 1) * cs)] += 1
    assert (rows == 1).all()
    assert 1 <= slots <= min(nch, TF.TAIL_MAX_SLOTS)
    assert slots * cs * sub_bytes <= TF.TAIL_STAGE_BYTES
    assert (TF.TAIL_FIXED_BYTES + 1024 + slots * cs * sub_bytes
            + 8 * slots) <= 232448


def test_tail_plan_at_the_main_path_width():
    """n = 18944 (K = 148): one slot holds a whole bf16 g, u row (the next
    token's row loads under this token's products); int32 or f32 pairs
    take 8 chunks through 5 slots."""
    assert TF._tail_plan(1024, 148, 512, SMS) == (132, 148, 1)
    assert TF._tail_plan(1024, 148, 256, SMS) == (132, 148, 1)
    assert TF._tail_plan(1024, 148, 1024, SMS) == (132, 19, 5)
    assert TF._tail_plan(5, 148, 512, SMS) == (5, 148, 1)


@pytest.mark.parametrize("n,T", [(512, 256), (2368, 512)])
def test_tail_plain_matches_jax_chain(n, T):
    """Against quantize(online_hadamard(swiglu(g, u))) of the JAX package,
    the bound of tests/test_kernels.py::TestFusedTail."""
    g, u = _bf16_pair(n * T, T, n)
    ref = jquantize(JF.online_hadamard(JL.swiglu(jnp.asarray(g),
                                                 jnp.asarray(u))),
                    JQP(scale=jnp.float32(SCALE)), INT8)
    got = TF.fused_swiglu_had_quant_ref(_t(g), _t(u), SCALE)
    worst, frac = _code_diff(got.numpy(), ref)
    assert worst <= 1 and frac < 0.08, (worst, frac)


def test_tail_plain_takes_strided_halves():
    """g and u as the two halves of one fused gate|up output (the layout
    qlinear_group hands the tail): the same codes as contiguous copies."""
    g, u = _bf16_pair(7, 4, 512)
    gu = torch.cat([_t(g), _t(u)], dim=-1)
    half = TF.fused_swiglu_had_quant(gu[..., :512], gu[..., 512:], SCALE)
    np.testing.assert_array_equal(
        half.numpy(), TF.fused_swiglu_had_quant(_t(g), _t(u), SCALE).numpy())


def _down_site(rng, n, hidden, split=False):
    d = {"w_q": rng.integers(-7, 8, size=(n - split, hidden)).astype(np.int8),
         "w_scale": rng.uniform(0.5, 1.5, size=(hidden,)).astype(np.float32)
         * 0.03,
         "b": (rng.normal(size=(hidden,)) * 0.1).astype(np.float32)}
    if split:
        d["w_col0"] = (rng.integers(-7, 8, size=(1, hidden)) * 0.03
                       ).astype(np.float32)
    return d


def _spec(Spec, mode="full", split=False):
    return Spec(w_bits=4, a_bits=8, a_static=True, online_had=mode,
                head_dim=0 if mode == "full" else 32, split=split)


def test_mlp_tail_fused_matches_jax_composition(monkeypatch):
    """T = 256 (f32 activations): the port's fused branch against JAX's
    quantized_matmul_pre(fused_swiglu_had_quant(interpret=True), …) + b."""
    monkeypatch.setenv("MQUANT_FUSED_TAIL", "1")
    rng = np.random.default_rng(11)
    n, hidden, T = 512, 64, 256
    g = rng.normal(size=(1, T, n)).astype(np.float32)
    u = rng.normal(size=(1, T, n)).astype(np.float32)
    dp = _down_site(rng, n, hidden)
    sc = jnp.float32(SCALE)
    q_j = JF.fused_swiglu_had_quant(jnp.asarray(g), jnp.asarray(u), sc,
                                    interpret=True)
    dpj = {k: jnp.asarray(v) for k, v in dp.items()}
    y_j = JK.quantized_matmul_pre(q_j, sc, dpj, jnp.float32) + dpj["b"]
    dpt = {k: _t(v) for k, v in dp.items()}
    lstate = {"llm.down": {"act": TQP(torch.tensor(SCALE))}}
    y_t = TLLM._mlp_tail(_spec(TL.SiteSpec), "real", _t(g), _t(u), dpt,
                         lstate)
    # the GEMM of the port's own codes is JAX's, bit for bit
    q_t = TF.fused_swiglu_had_quant_ref(_t(g), _t(u), SCALE)
    y_jt = JK.quantized_matmul_pre(jnp.asarray(q_t.numpy()), sc, dpj,
                                   jnp.float32) + dpj["b"]
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_jt))
    # codes within one step, and the outputs within what the differing
    # codes move: xs · ws · Σ |w| over the differing positions (+ f32 slack)
    dq = q_t.numpy().astype(np.int32) - np.asarray(q_j, np.int32)
    assert np.abs(dq).max() <= 1 and (dq != 0).mean() < 0.01
    room = (SCALE * np.abs(dq[0]).astype(np.float64)
            @ (np.abs(dp["w_q"]) * dp["w_scale"]))
    err = np.abs(y_t.numpy()[0].astype(np.float64) - np.asarray(y_j)[0])
    assert (err <= room + 1e-5 * np.abs(np.asarray(y_j)).max()).all()


@pytest.mark.parametrize("mode,T,split,fused", [
    ("full", 256, False, True),
    ("full", 512, False, True),
    ("full", 1, False, False),
    ("full", 128, False, False),
    ("full", 300, False, False),
    ("full", 256, True, False),  # w_col0: the RMS split takes the chain
    ("block", 256, False, False),
])
def test_mlp_tail_routing(mode, T, split, fused, monkeypatch):
    monkeypatch.setenv("MQUANT_FUSED_TAIL", "1")
    rng = np.random.default_rng(T)
    n, hidden = 512, 64
    g = torch.from_numpy(rng.normal(size=(1, T, n)).astype(np.float32))
    u = torch.from_numpy(rng.normal(size=(1, T, n)).astype(np.float32))
    dp = {k: _t(v) for k, v in _down_site(rng, n, hidden, split).items()}
    spec = _spec(TL.SiteSpec, mode, split)
    lstate = {"llm.down": {"act": TQP(torch.tensor(SCALE))}}
    calls = []
    kern = TF.KERNELS["fused_swiglu_had_quant"]
    monkeypatch.setitem(TF.KERNELS, "fused_swiglu_had_quant",
                        lambda *a: calls.append(a[0].shape) or kern(*a))
    y = TLLM._mlp_tail(spec, "real", g, u, dp, lstate)
    assert len(calls) == int(fused)
    assert y.shape == (1, T, hidden)
    if not fused:  # the unfused chain of qlinear
        np.testing.assert_array_equal(
            y.numpy(), TL.qlinear(TL.swiglu(g, u), dp, "llm.down", spec,
                                  lstate, "real").numpy())


def test_mlp_tail_needs_static_per_tensor_scale(monkeypatch):
    """Per-layer (L,) scales seen unsliced, zero points and dynamic scales
    keep the chain."""
    monkeypatch.setenv("MQUANT_FUSED_TAIL", "1")
    calls = []
    monkeypatch.setitem(TF.KERNELS, "fused_swiglu_had_quant",
                        lambda *a: calls.append(1))
    spec = _spec(TL.SiteSpec)
    dp = {"w_q": torch.zeros((512, 64), dtype=torch.int8)}
    for act in (TQP(torch.full((2,), SCALE)),
                TQP(torch.tensor(SCALE), torch.tensor(3.0)), None):
        assert not TLLM._use_fused_tail(spec, "real", 256, dp, act)
    assert not TLLM._use_fused_tail(
        dataclasses.replace(spec, a_static=False), "real", 256, dp,
        TQP(torch.tensor(SCALE)))
    assert TLLM._use_fused_tail(spec, "real", 256, dp,
                                TQP(torch.tensor(SCALE)))
    assert not TLLM._use_fused_tail(spec, "fp", 256, dp,
                                    TQP(torch.tensor(SCALE)))
    assert not calls


@pytest.mark.parametrize("n", [96, 18944 // 64, 512])
def test_online_hadamard_bf16_matches_jax(n):
    """bf16 operands, f32 sums, bf16 between the products: within one bf16
    ulp of JAX's (the sums run in other orders)."""
    rng = np.random.default_rng(n)
    x = np.asarray(jnp.asarray(rng.normal(size=(3, 5, n)), jnp.bfloat16))
    ref = np.asarray(JF.online_hadamard(jnp.asarray(x))).astype(np.float32)
    got = TF.online_hadamard(_t(x))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    mag = np.maximum(np.abs(ref), np.abs(got)).clip(min=2.0**-126)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    assert (np.abs(got - ref) <= ulp).all()


def test_port_sums_bf16_products_in_f32(monkeypatch):
    """The online Hadamard's bf16 matmuls run with cuBLAS's reduced-precision
    reduction off, so they sum in f32 as the JAX dots do, whatever the flag
    was; the caller's flag is restored after."""
    flags = torch.backends.cuda.matmul
    monkeypatch.setattr(flags, "allow_bf16_reduced_precision_reduction", True)
    seen = []
    matmul = torch.matmul
    monkeypatch.setattr(torch, "matmul", lambda *a: seen.append(
        flags.allow_bf16_reduced_precision_reduction) or matmul(*a))
    x = torch.ones((2, 2368), dtype=torch.bfloat16)
    TF.online_hadamard(x)
    assert seen == [False, False]
    assert flags.allow_bf16_reduced_precision_reduction


# (port function, JAX kernel call); inputs x ~ N(0, 3²) (…, 512), so that
# codes reach past ±127 at scale 0.05 and every range clips some
_RANGED = {
    "fused_swiglu_had_quant": (
        lambda x, r: TF.fused_swiglu_had_quant(_t(x), _t(x) * 0.5, SCALE,
                                               *r),
        lambda x, r: JF.fused_swiglu_had_quant(
            jnp.asarray(x), jnp.asarray(x) * 0.5, jnp.float32(SCALE), *r,
            interpret=True)),
    "had_quant": (
        lambda x, r: TF.had_quant(_t(x), SCALE, *r),
        lambda x, r: JF.had_quant(jnp.asarray(x), jnp.float32(SCALE), *r,
                                  interpret=True)),
    "rms_norm_quant": (
        lambda x, r: TF.rms_norm_quant(_t(x), _t(x[0, 0]), SCALE, 1e-6, *r),
        lambda x, r: JF.rms_norm_quant(jnp.asarray(x), jnp.asarray(x[0, 0]),
                                       jnp.float32(SCALE), 1e-6, *r,
                                       interpret=True)),
}


@pytest.mark.parametrize("qrange", [(-127, 127), (-8, 7)])
@pytest.mark.parametrize("name", list(_RANGED))
def test_code_range_plain_matches_jax_kernel(name, qrange):
    """ROADMAP C-w9: the three quantizers take the JAX kernels' code range
    [qmin, qmax]. Codes within ±1 of JAX's, under 1% differing (the tail's
    rule), every code inside the range, and the range reached."""
    port, jax_fn = _RANGED[name]
    rng = np.random.default_rng(len(name) + qrange[1])
    x = np.asarray(jnp.asarray(rng.normal(size=(1, 256, 512)) * 3.0,
                               jnp.bfloat16))
    got = port(x, qrange).numpy()
    ref = np.asarray(jax_fn(x, qrange))
    worst, frac = _code_diff(got, ref)
    assert worst <= 1 and frac < 0.01, (worst, frac)
    assert got.min() == qrange[0] and got.max() == qrange[1]


@pytest.mark.parametrize("qrange", [(-129, 0), (0, 128), (5, 4)])
def test_code_range_raises(qrange):
    x = torch.zeros((2, 512), dtype=torch.bfloat16)
    for fn in (lambda: TF.had_quant(x, SCALE, *qrange),
               lambda: TF.fused_swiglu_had_quant(x, x, SCALE, *qrange),
               lambda: TF.rms_norm_quant(x, x[0], SCALE, 1e-6, *qrange)):
        with pytest.raises(ValueError):
            fn()
