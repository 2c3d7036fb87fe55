"""The routers' kernel contracts (ROADMAP C-w10), on the CPU.

Each kernel module states its contract once, as a predicate beside its
wrapper (``attn_decode.supports``, ``fwht.tail_supports``,
``flash_attn.supports``, ``qmm.tma_supports``). On the card the wrapper
raises outside it and the router declines it, sending the work where JAX
sends it when its own gate says no (the einsum, the unfused chain); on a CPU
tensor every plain version takes everything, so the CPU route stays JAX's.
The card is simulated by making ``models.layers._on_card`` answer True for
CPU tensors; the kernels' slots are spies, so nothing launches.
"""

import numpy as np
import pytest
import torch

from mquant_tpu_torch.core.quant import QuantParams as TQP
from mquant_tpu_torch.kernels import attn_decode as TA
from mquant_tpu_torch.kernels import flash_attn as TF
from mquant_tpu_torch.kernels import fwht
from mquant_tpu_torch.kernels import qmm
from mquant_tpu_torch.models import layers as TL
from mquant_tpu_torch.models import llm as TLLM

BF16, F32, F16 = torch.bfloat16, torch.float32, torch.float16


@pytest.fixture
def on_card(monkeypatch):
    """Every tensor counts as lying on the card."""
    monkeypatch.setattr(TL, "_on_card", lambda t: True)


# ---------------------------------------------------------------------------
# the predicates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hd,G,dtype,ok", [
    (128, 7, BF16, True),     # Qwen2-VL-7B: 28 / 4 heads
    (128, 8, BF16, True), (128, 1, BF16, True),
    (128, 16, BF16, True),    # GLM-4V: 32 / 2 heads
    (128, 17, BF16, False),   # beyond one m16 tile
    (64, 4, BF16, False), (256, 4, BF16, False),
    (128, 7, F32, False), (128, 7, F16, False)])
def test_attn_decode_supports(hd, G, dtype, ok):
    assert TA.supports(hd, G, dtype) is ok


@pytest.mark.parametrize("n,dtype,ok", [
    (18944, BF16, True),      # 148 · 128, Qwen2-VL-7B
    (3584, BF16, True), (512, BF16, True), (16384, BF16, True),
    (29568, BF16, False),     # Qwen2-VL-72B: n / 128 = 231 > 160
    (96, BF16, False),        # 12 · 8: m != 128
    (32768, BF16, False),     # pow2 that splits with m = 256
    (2368, BF16, False),      # 148 · 16
    (18944, F32, True),       # f32 rows: the TPU kernels' f32 casts
    (3584, F32, True), (29568, F32, False), (18944, F16, False)])
def test_tail_supports(n, dtype, ok):
    assert fwht.tail_supports(n, dtype) is ok


@pytest.mark.parametrize("hd,dtype,T,ok", [
    (128, BF16, 4096, True), (128, BF16, 2048, True),
    (128, BF16, 4224, True), (128, BF16, 192, True),
    (128, F32, 4096, False), (128, F16, 4096, False),
    (256, BF16, 2048, False), (64, BF16, 2048, False),
    (128, BF16, 96, False)])
def test_flash_supports(hd, dtype, T, ok):
    assert TF.supports(hd, dtype, T) is ok


# the main path's GEMM shapes (7B prefill W4, ViT and merger W8, the probes'
# W8 products, the RMS split's K = 18943) take the TMA kernel, and so does
# any other K on int8 weights (TMA zero-fills past K); the ragged-N edges of
# tests/test_torch_cuda.py and packed W4 with (K/2) % 16 != 0 go to the
# ragged kernel
_GEMM_SHAPES = [
    (3584, 4608, True, True), (3584, 3584, True, True),
    (3584, 37888, True, True), (18944, 3584, True, True),
    (1280, 1280, False, True), (1280, 5120, False, True),
    (5120, 1280, False, True), (5120, 5120, False, True),
    (5120, 3584, False, True), (3584, 512, False, True),
    (3584, 19968, False, True), (18944, 3584, False, True),
    (18943, 3584, False, True), (3584, 4100, True, False),
    (1280, 1000, False, False), (1001, 1000, False, False),
    (3, 64, False, True), (3586, 4100, True, False),
    (1001, 1024, False, True), (18943, 3584, True, False),
    (3586, 64, True, False),  # K/2 = 1793
    (1040, 64, True, False),  # K/2 = 520: 16-byte rows, high plane off
    # the full-logit lm_heads of InternVL2-8B and MiniCPM-V-2.6, N odd,
    # N % 4 == 2, W4 with (K/2) % 16 == 4
    (4096, 92553, False, False), (3584, 151666, False, False),
    (1001, 1003, False, False), (1000, 1002, False, False),
    (1000, 1024, True, False)]


@pytest.mark.parametrize("K,N,packed,ok", _GEMM_SHAPES)
def test_gemm_tma_supports(K, N, packed, ok):
    assert qmm.tma_supports(K, N, packed) is ok


# the ragged kernel takes every shape the wrappers let through: any K and
# N >= 1, K even for packed W4
@pytest.mark.parametrize("K,N,packed,ok", [
    (4096, 92553, False, True), (3584, 151666, False, True),
    (1001, 1003, False, True), (1, 1, False, True), (2, 1, True, True),
    (18943, 3584, False, True), (3584, 4608, True, True),
    (1001, 1003, True, False), (0, 64, False, False), (64, 0, False, False)])
def test_gemm_ragged_supports(K, N, packed, ok):
    assert qmm.ragged_supports(K, N, packed) is ok


@pytest.mark.parametrize("K,N,packed,ok", _GEMM_SHAPES)
def test_gemm_route_on_card_by_predicate(K, N, packed, ok):
    """On the card ``int8_gemm`` launches the TMA kernel exactly inside
    ``tma_supports`` with a 16-byte aligned weight and the ragged kernel
    everywhere else, which ``ragged_supports`` takes (packed W4 of an odd
    K is refused by the wrappers' checks before any route)."""
    for aligned in (True, False):
        route = qmm._gemm_route(K, N, packed, aligned)
        assert route == ("int8_gemm" if ok and aligned else
                         "int8_gemm_ragged")
    assert qmm.ragged_supports(K, N, packed) is (not packed or K % 2 == 0)


# the int8 GEMV takes every int8 site at M <= 32: any K and N (the
# published lm_heads' N = 92553 / 151666, N % 16 = 8, N odd, K tails)
_I8_GEMV_KN = [(4096, 92553), (3584, 151666), (1001, 1000), (1001, 1003),
               (18943, 3584), (3584, 152064), (1, 1)]


@pytest.mark.parametrize("K,N", _I8_GEMV_KN)
def test_int8_gemv_supports(K, N):
    for M in range(1, 33):
        assert qmm.int8_gemv_supports(M, K, N)
    assert not qmm.int8_gemv_supports(33, K, N)
    assert not qmm.int8_gemv_supports(0, K, N)
    assert not qmm.int8_gemv_supports(1, 0, N)
    assert not qmm.int8_gemv_supports(1, K, 0)


# the route depends on M and the packing only: the published heads' N at a
# short K (the plain version's float64 product stays small)
@pytest.mark.parametrize("K,N", [(64, 92553), (64, 151666), (1001, 1000),
                                 (1001, 1003), (18943, 16), (1, 1)])
def test_quantized_matmul_pre_routes_int8_rows_to_the_gemv(K, N,
                                                           monkeypatch):
    """``quantized_matmul_pre`` sends every int8 site of M <= 32 rows to
    ``int8_gemv`` (whose contract takes any N, so the route raises on none)
    and M = 33 to ``int8_gemm``; the wrapper's plain version on the CPU."""
    rng = np.random.default_rng(K + N)
    w = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8))
    ws = torch.from_numpy(rng.uniform(1e-3, 1e-2, N).astype(np.float32))
    calls = []
    for name in ("int8_gemv", "int8_gemm"):
        fn = qmm.KERNELS[name]
        monkeypatch.setitem(qmm.KERNELS, name,
                            lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    for M in (1, 8, 17, 32, 33):
        x = torch.from_numpy(rng.integers(-127, 128, (M, K)).astype(np.int8))
        xs = torch.from_numpy(rng.uniform(0.01, 0.1, M).astype(np.float32))
        calls.clear()
        y = qmm.quantized_matmul_pre(x, xs[:, None], {"w_q": w,
                                                      "w_scale": ws},
                                     torch.bfloat16)
        assert calls == ["int8_gemv" if M <= 32 else "int8_gemm"]
        assert torch.equal(y, qmm.int8_gemv_ref(x, xs, w, ws))


def test_int8_gemv_raises_on_rows_and_devices():
    """The wrapper raises on M > 32 (any device) and on a device that is
    neither the CPU nor CUDA (the meta device: no data, no kernel)."""
    x = torch.zeros((33, 64), dtype=torch.int8)
    with pytest.raises(ValueError, match="M=33"):
        qmm.int8_gemv(x, torch.ones(33), torch.zeros((64, 8), dtype=torch.int8),
                      torch.ones(8))
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        qmm.int8_gemv(torch.zeros((2, 64), dtype=torch.int8, **meta),
                      torch.ones(2, **meta),
                      torch.zeros((64, 8), dtype=torch.int8, **meta),
                      torch.ones(8, **meta))


@pytest.mark.parametrize("K", [1000, 1002, 64])
def test_w4_planes_layout(K):
    """The ragged GEMM's x for packed W4 with (K/2) % 16 != 0: the low plane
    at columns [0, K/2), the high plane from H (K/2 rounded up to 16), zeros
    between and after, rows at a 16-byte stride: its two plane products
    against W's nibble planes are x · unpack(W)."""
    rng = np.random.default_rng(K)
    x = torch.from_numpy(rng.integers(-127, 128, (5, K)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (K // 2, 7)).astype(np.int8))
    half, H = K // 2, -(-(K // 2) // 16) * 16
    x2 = qmm._w4_planes(x)
    assert x2.shape == (5, 2 * H) and x2.stride(0) % 16 == 0
    assert torch.equal(x2[:, :half], x[:, :half])
    assert torch.equal(x2[:, H:H + half], x[:, half:])
    assert not x2[:, half:H].any() and not x2[:, H + half:].any()
    planes = qmm.unpack_int4_weights({"w_q": w})
    lo, hi = planes[:half].double(), planes[half:].double()
    got = x2[:, :half].double() @ lo + x2[:, H:H + half].double() @ hi
    assert torch.equal(got.to(torch.int32), qmm.int8_gemm_ref(
        x, torch.ones(5), w, torch.ones(7), torch.int32, packed=True))


@pytest.mark.parametrize("M,K,N,packed", [(40, 1000, 1003, False),
                                          (40, 1000, 1002, True),
                                          (33, 64, 4096, True)])
def test_gemm_cpu_route_is_the_plain_version(M, K, N, packed):
    """On CPU tensors ``int8_gemm`` and ``int8_gemm_ragged`` are the plain
    version (exact), whatever the shape, and launch nothing."""
    rng = np.random.default_rng(M + N)
    x = torch.from_numpy(rng.integers(-127, 128, (M, K)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (K // 2 if packed else K,
                                                   N)).astype(np.int8))
    xs = torch.from_numpy(rng.uniform(0.01, 0.1, M).astype(np.float32))
    ws = torch.from_numpy(rng.uniform(1e-3, 1e-2, N).astype(np.float32))
    before = dict(qmm.LAUNCHES)
    ref = qmm.int8_gemm_ref(x, xs, w, ws, torch.int32, packed)
    for fn in (qmm.int8_gemm, qmm.int8_gemm_ragged):
        assert torch.equal(fn(x, xs, w, ws, torch.int32, packed), ref)
        assert torch.equal(fn(x, xs, w, ws, torch.bfloat16, packed),
                           qmm.int8_gemm_ref(x, xs, w, ws, torch.bfloat16,
                                             packed))
    assert qmm.LAUNCHES == before


# ---------------------------------------------------------------------------
# each wrapper's check raises exactly where its predicate says no (called
# directly: it is what the wrapper runs on a CUDA tensor, before a launch)
# ---------------------------------------------------------------------------


def _z(*shape, dtype=BF16):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("hd,H,KVH,dtype", [
    (128, 28, 4, BF16), (128, 32, 2, BF16), (64, 4, 2, BF16),
    (256, 4, 2, BF16), (128, 4, 2, F32), (128, 4, 2, F16)])
def test_attn_decode_check_agrees_with_supports(hd, H, KVH, dtype):
    ops = (_z(1, 1, H, hd, dtype=dtype), _z(1, 1, KVH, hd, dtype=dtype),
           _z(1, 1, KVH, hd, dtype=dtype), _z(1, 16, KVH, hd, dtype=dtype),
           _z(1, 16, KVH, hd, dtype=dtype))
    if TA.supports(hd, H // KVH, dtype):
        TA._check_card(*ops)
    else:
        with pytest.raises(ValueError):
            TA._check_card(*ops)


@pytest.mark.parametrize("hd,T,dtype", [
    (128, 256, BF16), (128, 192, BF16), (256, 256, BF16), (64, 256, BF16),
    (128, 256, F32), (128, 256, F16), (128, 96, BF16)])
def test_flash_check_agrees_with_supports(hd, T, dtype):
    q, kv = _z(1, T, 4, hd, dtype=dtype), _z(1, T, 2, hd, dtype=dtype)
    if TF.supports(hd, dtype, T):
        TF._check_card(q, kv, kv)
    else:
        with pytest.raises(ValueError):
            TF._check_card(q, kv, kv)


@pytest.mark.parametrize("n,dtype", [
    (18944, BF16), (3584, BF16), (29568, BF16), (96, BF16), (32768, BF16),
    (18944, F32), (18944, F16)])
def test_tail_check_agrees_with_supports(n, dtype):
    if fwht.tail_supports(n, dtype):
        assert fwht._check_tail("t", n, dtype) * fwht.TAIL_M == n
    else:
        with pytest.raises(ValueError):
            fwht._check_tail("t", n, dtype)


# ---------------------------------------------------------------------------
# the routers
# ---------------------------------------------------------------------------


def _dcfg(H, KVH, hd, dtype):
    return TLLM.DecoderConfig(vocab=8, hidden=64, n_layers=1, n_heads=H,
                              n_kv_heads=KVH, intermediate=8, head_dim=hd,
                              dtype=dtype)


def _decode_route(H, KVH, hd, dtype):
    cfg = _dcfg(H, KVH, hd, dtype)
    cache = TLLM.init_cache(cfg, 1, 8, device="cpu")
    return TLLM._use_fused_decode_attn(cfg, cache, 1, False, None)


# (heads, kv heads, hd, cache dtype): the 7B configuration, then those
# outside the kernel's contract that JAX's own gate lets through (G = 17:
# beyond one m16 tile; GLM-4V's G = 16 is inside it)
_DECODE_OUT = [(34, 2, 128, BF16), (4, 2, 256, BF16), (4, 2, 128, F32),
               (4, 2, 128, F16)]


def test_decode_router_on_card(on_card):
    assert _decode_route(28, 4, 128, BF16)
    for case in _DECODE_OUT:
        assert not _decode_route(*case), case


def test_decode_router_on_cpu_keeps_jax_route():
    assert _decode_route(28, 4, 128, BF16)
    for case in _DECODE_OUT:
        assert _decode_route(*case), case


def test_declined_decode_step_takes_the_einsum(on_card, monkeypatch):
    """An f32 cache on the card (outside the kernel's bf16 contract): the
    decode step runs the einsum path, and its logits are those of the
    fused plain version on the CPU."""
    cfg = _dcfg(32, 2, 128, F32)
    rng = np.random.default_rng(0)
    w = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32) * 0.1)
    params = {
        "embed": {"w": w(8, 64)}, "ln_f": {"w": torch.ones(64)},
        "lm_head": {"w": w(64, 8)},
        "layers": {"ln1": {"w": torch.ones(1, 64)},
                   "ln2": {"w": torch.ones(1, 64)},
                   **{n: {"w": w(1, i, o)} for n, i, o in (
                       ("q", 64, 4096), ("k", 64, 256), ("v", 64, 256),
                       ("o", 4096, 64), ("gate", 64, 8), ("up", 64, 8),
                       ("down", 8, 64))}}}
    calls = []
    monkeypatch.setitem(TA.KERNELS, "attn_decode",
                        lambda *a, **k: calls.append(1))
    cache = TLLM.init_cache(cfg, 1, 8, device="cpu")
    _, cache, _ = TLLM.decoder_forward(cfg, params, torch.tensor([[1, 2, 3]]),
                                    cache=cache, prefill_fresh=True)
    out, _, _ = TLLM.decoder_forward(cfg, params, torch.tensor([[4]]),
                                  cache=dict(cache))
    assert not calls
    monkeypatch.setattr(TL, "_on_card", lambda t: False)
    monkeypatch.setitem(TA.KERNELS, "attn_decode", TA.attn_decode_ref)
    cache2 = TLLM.init_cache(cfg, 1, 8, device="cpu")
    _, cache2, _ = TLLM.decoder_forward(cfg, params, torch.tensor([[1, 2, 3]]),
                                     cache=cache2, prefill_fresh=True)
    ref, _, _ = TLLM.decoder_forward(cfg, params, torch.tensor([[4]]),
                                  cache=cache2)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


SCALE = 0.05


def _tail_spec():
    return TL.SiteSpec(w_bits=4, a_bits=8, a_static=True, online_had="full")


@pytest.fixture
def fused_tail(monkeypatch):
    """The fused tail's opt-in flag, as JAX's ``MQUANT_FUSED_TAIL=1``."""
    monkeypatch.setenv("MQUANT_FUSED_TAIL", "1")


def _tail_route(n, dtype):
    dp = {"w_q": torch.zeros((n, 64), dtype=torch.int8)}
    g = torch.zeros((256, n), dtype=dtype)
    return TLLM._use_fused_tail(_tail_spec(), "real", 256, dp,
                                TQP(torch.tensor(SCALE)), g)


_TAIL_OUT = [(29568, BF16), (96, BF16), (18944, F16)]


def test_tail_router_on_card(on_card, fused_tail):
    assert _tail_route(18944, BF16) and _tail_route(18944, F32)
    for case in _TAIL_OUT:
        assert not _tail_route(*case), case


def test_tail_router_on_cpu_keeps_jax_route(fused_tail):
    assert _tail_route(18944, BF16)
    for case in _TAIL_OUT:
        assert _tail_route(*case), case


def test_declined_tail_takes_the_unfused_chain(on_card, fused_tail,
                                               monkeypatch):
    """n = 96 on the card: ``_mlp_tail`` runs qlinear(swiglu(g, u)) (the
    online Hadamard, the quantizer, the integer GEMM), never the kernel."""
    monkeypatch.setitem(fwht.KERNELS, "fused_swiglu_had_quant",
                        lambda *a: pytest.fail("the kernel's slot was taken"))
    rng = np.random.default_rng(1)
    n, N = 96, 32
    g = torch.from_numpy(rng.normal(size=(1, 256, n)).astype(np.float32))
    u = torch.from_numpy(rng.normal(size=(1, 256, n)).astype(np.float32))
    dp = qmm.quantize_weights_real(
        torch.from_numpy(rng.normal(size=(n, N)).astype(np.float32)), 4)
    lstate = {"llm.down": {"act": TQP(torch.tensor(SCALE))}}
    spec = _tail_spec()
    y = TLLM._mlp_tail(spec, "real", g, u, dp, lstate)
    ref = TL.qlinear(TL.swiglu(g, u), dp, "llm.down", spec, lstate, "real")
    assert torch.equal(y, ref)


def _qkv(T, hd, dtype, H=4, KVH=2):
    return (_z(1, T, H, hd, dtype=dtype), _z(1, T, KVH, hd, dtype=dtype),
            _z(1, T, KVH, hd, dtype=dtype))


_FLASH_OUT = [(128, F32), (128, F16), (256, BF16)]


def _flash_routes(monkeypatch, cases):
    calls = []

    def spy(q, k, v, scale):
        calls.append((q.shape[-1], q.dtype))
        return torch.zeros_like(q)

    monkeypatch.setitem(TF.KERNELS, "flash_attn_causal", spy)
    for hd, dtype in cases:
        TL.attention(*_qkv(TL.FLASH_MIN_T, hd, dtype), causal=True)
    return calls


def test_flash_router_on_card(on_card, monkeypatch):
    assert _flash_routes(monkeypatch, [(128, BF16)] + _FLASH_OUT) == [
        (128, BF16)]


def test_flash_router_on_cpu_keeps_jax_route(monkeypatch):
    cases = [(128, BF16)] + _FLASH_OUT
    assert _flash_routes(monkeypatch, cases) == cases


def test_declined_flash_takes_the_einsum(on_card, monkeypatch):
    monkeypatch.setitem(TF.KERNELS, "flash_attn_causal",
                        lambda *a: pytest.fail("the kernel's slot was taken"))
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((1, TL.FLASH_MIN_T, 2, 128),
                         (1, TL.FLASH_MIN_T, 1, 128),
                         (1, TL.FLASH_MIN_T, 1, 128)))
    out = TL.attention(q, k, v, causal=True)
    assert torch.equal(out, TL.einsum_attention(q, k, v, None, 128**-0.5,
                                                causal=True))


def test_on_card_is_the_device_test():
    assert not TL._on_card(torch.zeros(1))
    assert not TL._on_card(torch.zeros(1, device="meta"))
