"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: they skip where no CUDA device is present (CUDA kernels have
no CPU mode). On the card: ``python -m pytest tests/test_torch_cuda.py``.
Tolerances: int32 accumulators bit-equal; bf16 outputs within 1 bf16 ulp
(the GEMMs' bit-equal: their epilogue is the plain version's).
Attention: written cache rows bit-equal; outputs within 1e-2 of their
largest magnitude (the kernels round the probabilities to bf16 at other
points than the plain versions and sum in other orders). Fused tail: int8
codes within ±1 and at most 1% of them differing (f32 sums in other orders
and another exp may move a code on a rounding tie by one step); had_quant
the same, in all three input modes (bf16 or f32 x, bf16 or f32 g and u,
int32 g and u); rms_norm_quant within ±1 and at most 1e-3 differing (another sum
order of the squares). fwht in f32: max |Δ| ≤ 1e-5 of the plain version's
largest magnitude (f32 sums against its float64 ones); bf16 output within one
bf16 ulp plus that bound (near zero, cancellation decides the f32 value).
The probes' kernels: w8_bf16_gemv bf16 within one ulp plus 1e-5 of the
largest magnitude (f32 sums against float64 ones, as fwht) and the same bits
on every call; w4_unpack_gemv
int32 bit-equal (P1-P3 also to w4a8_gemv's); dequant_swiglu_had_quant the
tail's rule; the quantizers' code range [qmin, qmax] likewise.
"""

import pytest
import torch

from mquant_tpu_torch.kernels import attn_decode as TA
from mquant_tpu_torch.kernels import flash_attn as TF
from mquant_tpu_torch.kernels import fwht
from mquant_tpu_torch.kernels import qmm

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _operands(dev, M, K, N, packed, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = K // 2 if packed else K
    x = torch.randint(-127, 128, (M, K), generator=g, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-128 if packed else -127, 128, (rows, N), generator=g,
                      device=dev, dtype=torch.int8)
    xs = torch.rand((M,), generator=g, device=dev) * 0.1 + 1e-3
    ws = torch.rand((N,), generator=g, device=dev) * 0.01 + 1e-4
    return x, xs, w, ws


def _counter(name, K, N, packed):
    """The launch count a call adds to: ``int8_gemm`` routes shapes outside
    the TMA kernel's contract to the ragged kernel's own count."""
    if name == "int8_gemm" and not qmm.tma_supports(K, N, packed):
        return "int8_gemm_ragged"
    return name


def _check(name, dev, M, K, N, packed):
    x, xs, w, ws = _operands(dev, M, K, N, packed)
    gemm = name.startswith("int8_gemm")
    extra = {"packed": packed} if gemm else {}
    kern, plain = qmm.KERNELS[name], qmm.PLAIN[name]
    counter = _counter(name, K, N, packed)
    before = qmm.LAUNCHES[counter]
    acc = kern(x, xs, w, ws, torch.int32, **extra)
    assert qmm.LAUNCHES[counter] == before + 1
    torch.testing.assert_close(acc, plain(x, xs, w, ws, torch.int32, **extra),
                               rtol=0, atol=0)
    y = kern(x, xs, w, ws, torch.bfloat16, **extra).float()
    r = plain(x, xs, w, ws, torch.bfloat16, **extra).float()
    if gemm or name == "int8_gemv":
        # the GEMMs' and the int8 GEMV's epilogue is the plain version's:
        # bit-equal, in bf16 and in f32
        assert torch.equal(y, r)
        assert torch.equal(kern(x, xs, w, ws, torch.float32, **extra),
                           plain(x, xs, w, ws, torch.float32, **extra))
    mag = torch.maximum(y.abs(), r.abs()).clamp(min=2.0**-126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert bool(((y - r).abs() <= ulp).all())


@pytest.mark.parametrize("M,K,N", [(1, 3584, 4608), (1, 18944, 3584),
                                   (5, 256, 4096), (32, 512, 160)])
def test_w4a8_gemv(cuda, M, K, N):
    _check("w4a8_gemv", cuda, M, K, N, True)


# every token-row count of the one-launch tensor-core GEMV (one to four n8
# tiles, partial tiles) at the decode shapes q|k|v and down and at a K whose
# packed rows are no multiple of 4 (K/2 = 1793: x words read unaligned)
@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 8, 16, 31, 32])
@pytest.mark.parametrize("K,N", [(3584, 4608), (18944, 3584), (3586, 160)])
def test_w4a8_gemv_rows(cuda, M, K, N):
    _check("w4a8_gemv", cuda, M, K, N, True)


def test_w4a8_gemv_unaligned_x_and_layer_view(cuda):
    """x rows 2 bytes off 4-byte alignment, and a stacked weight's layer
    view (the decoder's ``w[l]``): int32 bit-equal to the plain version."""
    x, xs, w, ws = _operands(cuda, 3, 3586, 4608, True)
    xo = torch.cat([x.reshape(-1), x.reshape(-1)[:6]])[2:2 + 3 * 3584]
    xo = xo.reshape(3, 3584)
    stack = torch.stack([w[:1792], w[1:1793]])
    for layer in (0, 1):
        acc = qmm.w4a8_gemv(xo, xs, stack[layer], ws, torch.int32)
        assert torch.equal(acc, qmm.w4a8_gemv_ref(xo, xs, stack[layer], ws,
                                                  torch.int32))


def test_w4a8_gemv_cuda_graph(cuda):
    """One launch, capturable: a CUDA graph of the GEMV replayed on two
    inputs equals eager calls and the plain version, int32 bit for bit."""
    x, xs, w, ws = _operands(cuda, 8, 3584, 4608, True)
    qmm.w4a8_gemv(x, xs, w, ws, torch.int32)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = qmm.w4a8_gemv(x, xs, w, ws, torch.int32)
    for seed in (1, 2):
        x.copy_(_operands(cuda, 8, 3584, 4608, True, seed=seed)[0])
        graph.replay()
        eager = qmm.w4a8_gemv(x, xs, w, ws, torch.int32)
        torch.cuda.synchronize()
        assert torch.equal(y, eager)
        assert torch.equal(y, qmm.w4a8_gemv_ref(x, xs, w, ws, torch.int32))


def test_w4a8_gemv_raises_outside_contract(cuda):
    x, xs, w, ws = _operands(cuda, 2, 64, 40, True)  # N % 16 != 0
    assert not qmm.gemv_supports(2, 64, 40)
    with pytest.raises(ValueError):
        qmm.w4a8_gemv(x, xs, w, ws)
    x, xs, w, ws = _operands(cuda, 33, 64, 64, True)  # M > 32
    with pytest.raises(ValueError):
        qmm.w4a8_gemv(x, xs, w, ws)
    x, xs, w, ws = _operands(cuda, 2, 64, 64, True)
    wo = torch.cat([w.reshape(-1), w.reshape(-1)[:8]])[8:].reshape(32, 64)
    assert wo.data_ptr() % 16 == 8  # a view 8 bytes off 16
    with pytest.raises(ValueError):
        qmm.w4a8_gemv(x, xs, wo, ws)


# K = 18943: the RMS split's int8 rows of ``down`` (8 rows: the engine's
# pool step, 32: the contract's last n8 tile); the int8 lm_head at 1 and 8
# rows; the published lm_heads of InternVL2-8B (N = 92553, odd) and
# MiniCPM-V-2.6 (N = 151666 = 2 mod 16), whose rows no TMA box or 8-byte
# copy addresses; Qwen-VL-Chat's split `down` (K = 11007) and its head
# (N = 151936); other ragged K tails, N % 16 = 8 and N odd
@pytest.mark.parametrize("M,K,N", [(1, 3584, 152064), (7, 384, 2048),
                                   (1, 18943, 3584), (3, 18943, 3584),
                                   (5, 1001, 2048), (2, 6, 16),
                                   (8, 18943, 3584), (32, 18943, 3584),
                                   (8, 3584, 152064), (1, 4096, 92553),
                                   (8, 4096, 92553), (1, 3584, 151666),
                                   (8, 3584, 151666), (3, 1001, 1000),
                                   (5, 1001, 1003), (5, 3584, 1024),
                                   (1, 11007, 4096), (8, 11007, 4096),
                                   (1, 4096, 151936)])
def test_int8_gemv(cuda, M, K, N):
    _check("int8_gemv", cuda, M, K, N, False)


# every token-row count of the one-launch int8 GEMV (one to four n8 tiles,
# partial tiles) through each W load path: TMA (N % 16 == 0), cp.async
# (N % 16 == 8), the producer's words (N odd, N = 2 mod 16), with and
# without a K tail
@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 8, 9, 16, 17, 31, 32])
@pytest.mark.parametrize("K,N", [(18943, 3584), (3584, 1024), (1001, 1000),
                                 (1001, 1003), (96, 151666), (4096, 77)])
def test_int8_gemv_rows(cuda, M, K, N):
    _check("int8_gemv", cuda, M, K, N, False)


def test_int8_gemv_unaligned_x_and_weight(cuda):
    """x rows 1-3 bytes off 4-byte alignment (the predicated x words) and
    weight views 1, 2 and 8 bytes off 16-byte alignment (the word producer
    and cp.async where TMA cannot take the base): bit-equal, int32 and
    bf16."""
    for M, K, N in ((3, 3584, 1024), (5, 1001, 1000), (8, 18943, 3584)):
        x, xs, w, ws = _operands(cuda, M, K, N, False)
        flat = torch.cat([x.reshape(-1), x.reshape(-1)[:4]])
        wflat = torch.cat([w.reshape(-1), w.reshape(-1)[:16]])
        for xo in (1, 2, 3):
            xv = flat[xo:xo + x.numel()].reshape(M, K)
            assert xv.data_ptr() % 4 == xo
            for wo in (0, 1, 2, 8):
                wv = wflat[wo:wo + w.numel()].reshape(K, N)
                for dt in (torch.int32, torch.bfloat16):
                    assert torch.equal(qmm.int8_gemv(xv, xs, wv, ws, dt),
                                       qmm.int8_gemv_ref(xv, xs, wv, ws, dt))


@pytest.mark.parametrize("M,K,N", [(8, 18943, 3584), (1, 3584, 152064),
                                   (5, 1001, 1003), (8, 1001, 1000)])
def test_int8_gemv_one_launch_and_graph(cuda, M, K, N):
    """One device operation per call (the profiler's count: no memset,
    workspace or second kernel; a call captured in a CUDA graph is one
    kernel node), and a CUDA graph replayed on two inputs equal to eager
    calls and the plain version, bit for bit."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, xs, w, ws = _operands(cuda, M, K, N, False)
    qmm.int8_gemv(x, xs, w, ws)
    torch.cuda.synchronize()
    # the first profiler run of a process may miss its first kernel while
    # the tracer starts: one run first, then the one counted
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                qmm.int8_gemv(x, xs, w, ws)
            torch.cuda.synchronize()
    ops = {e.key: e.count for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA}
    assert sum(ops.values()) == 3, ops
    assert all("gemv_tc_kernel" in k for k in ops), ops
    before = qmm.LAUNCHES["int8_gemv"]
    assert _graph_node_types(lambda: qmm.int8_gemv(x, xs, w, ws)) == [0]
    assert qmm.LAUNCHES["int8_gemv"] == before + 1
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = qmm.int8_gemv(x, xs, w, ws)
    for seed in (1, 2):
        x.copy_(_operands(cuda, M, K, N, False, seed=seed)[0])
        graph.replay()
        eager = qmm.int8_gemv(x, xs, w, ws)
        torch.cuda.synchronize()
        assert torch.equal(y, eager)
        assert torch.equal(y, qmm.int8_gemv_ref(x, xs, w, ws))


def test_int8_gemv_raises_outside_contract(cuda):
    x, xs, w, ws = _operands(cuda, 33, 64, 64, False)  # M > 32
    assert not qmm.int8_gemv_supports(33, 64, 64)
    with pytest.raises(ValueError):
        qmm.int8_gemv(x, xs, w, ws)


def test_quantized_matmul_pre_int8_any_n(cuda):
    """An int8 site of N % 16 != 0 at M <= 32 on the card: served by the
    int8 GEMV (one launch), bit-equal to the plain version."""
    for M, K, N in ((1, 4096, 92553), (8, 3584, 151666), (4, 1001, 1003)):
        x, xs, w, ws = _operands(cuda, M, K, N, False)
        before = qmm.LAUNCHES["int8_gemv"]
        y = qmm.quantized_matmul_pre(x, xs[:, None], {"w_q": w,
                                                      "w_scale": ws},
                                     torch.bfloat16)
        assert qmm.LAUNCHES["int8_gemv"] == before + 1
        assert torch.equal(y, qmm.int8_gemv_ref(x, xs, w, ws))


# the main path's products (7B prefill W4, ViT and merger W8, the prefill
# probe's W8 products, path S's K = 18943 `down`), then ragged M on a W4 and
# a W8 shape, then the edges: outside the TMA contract (N = 4100 / 1000,
# W4 K/2 = 1793; N odd, N % 4 == 2, W4 (K/2) % 16 != 0 at N % 16 == 0),
# which run the ragged kernel, and K = 3 on int8 weights, which the TMA
# kernel takes from a padded copy of x
_MAIN_GEMM = [(1024, 3584, 4608, True), (1024, 3584, 3584, True),
              (1024, 3584, 37888, True), (1024, 18944, 3584, True),
              (1024, 1280, 1280, False), (1024, 1280, 5120, False),
              (1024, 5120, 1280, False), (256, 5120, 5120, False),
              (256, 5120, 3584, False), (1024, 3584, 512, False),
              (1024, 3584, 18944, False), (1024, 18944, 3584, False),
              (1024, 18943, 3584, False), (4096, 3584, 4608, True)]
_RAGGED_M = [(m, 3584, 4608, True) for m in (33, 77, 256, 300, 1025, 4096)] \
    + [(m, 1280, 1280, False) for m in (33, 77, 256, 300, 1025, 4096)]
_EDGES = [(77, 3584, 4100, True), (333, 1280, 1000, False),
          (77, 1001, 1000, False), (40, 3, 64, False), (100, 3586, 4100, True),
          (77, 1001, 1003, False), (77, 1000, 1002, False),
          (77, 1000, 1024, True), (300, 64, 1001, True)]


@pytest.mark.parametrize("M,K,N,packed", _MAIN_GEMM + _RAGGED_M + _EDGES)
def test_int8_gemm(cuda, M, K, N, packed):
    _check("int8_gemm", cuda, M, K, N, packed)


# both block widths of the TMA kernel, whichever the wrapper picks
@pytest.mark.parametrize("tokens", [128, 256])
@pytest.mark.parametrize("M,K,N,packed", [(1024, 3584, 4608, True),
                                          (300, 1280, 1280, False),
                                          (77, 3584, 512, False)])
def test_int8_gemm_block_widths(cuda, M, K, N, packed, tokens):
    x, xs, w, ws = _operands(cuda, M, K, N, packed)
    ref = qmm.int8_gemm_ref(x, xs, w, ws, torch.int32, packed)
    assert torch.equal(qmm._gemm_tma(x, xs, w, ws, torch.int32, packed,
                                     tokens), ref)


# the ragged kernel on its own: at main-path shapes of the TMA kernel (timed
# beside it), an unaligned-K edge, N odd, N % 4 == 2, W4 with
# (K/2) % 16 != 0, one token row, and the lm_heads' N at a short K
@pytest.mark.parametrize("M,K,N,packed", [(1024, 3584, 4608, True),
                                          (256, 5120, 3584, False),
                                          (77, 1001, 1000, False),
                                          (77, 1001, 1003, False),
                                          (300, 3584, 4102, False),
                                          (77, 1000, 1024, True),
                                          (1, 66, 5, False),
                                          (1024, 64, 92553, False),
                                          (40, 128, 151666, True)])
def test_int8_gemm_ragged(cuda, M, K, N, packed):
    _check("int8_gemm_ragged", cuda, M, K, N, packed)


def test_int8_gemm_ragged_unaligned_weight(cuda):
    """A weight view 1 and 2 bytes off 4-byte alignment (the word producer
    at N % 4 == 0) and x rows at a padded stride: bit-equal."""
    x, xs, w, ws = _operands(cuda, 77, 300, 1024, False)
    flat = torch.cat([w.reshape(-1), w.reshape(-1)[:4]])
    for off in (1, 2):
        wo = flat[off:off + w.numel()].reshape(w.shape)
        assert wo.data_ptr() % 4 == off
        acc = qmm.int8_gemm_ragged(_padded(x), xs, wo, ws, torch.int32)
        assert torch.equal(acc, qmm.int8_gemm_ref(x, xs, wo, ws, torch.int32))


def _graph_node_types(fn):
    """The node types (CUgraphNodeType: 0 kernel, 1 memcpy, 2 memset, ...)
    of ``fn()`` captured in a CUDA graph, read through the driver API."""
    import ctypes

    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    drv = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert drv.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert drv.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0
    types = []
    for node in nodes:
        t = ctypes.c_int(-1)
        assert drv.cuGraphNodeGetType(ctypes.c_void_p(node),
                                      ctypes.byref(t)) == 0
        types.append(t.value)
    return types


@pytest.mark.parametrize("M,K,N,packed", [(77, 1001, 1003, False),
                                          (77, 1024, 1002, True)])
def test_int8_gemm_ragged_one_launch_and_graph(cuda, M, K, N, packed):
    """One device operation per call (x in 16-byte rows: no copy; a call
    captured in a CUDA graph is one kernel node), and a CUDA graph replayed
    on two inputs equal to eager calls and the plain version, int32 bit for
    bit."""
    x, xs, w, ws = _operands(cuda, M, K, N, packed)
    xp = _padded(x)
    qmm.int8_gemm_ragged(xp, xs, w, ws, torch.int32, packed)
    torch.cuda.synchronize()
    before = qmm.LAUNCHES["int8_gemm_ragged"]
    assert _graph_node_types(lambda: qmm.int8_gemm_ragged(
        xp, xs, w, ws, torch.int32, packed)) == [0]
    assert qmm.LAUNCHES["int8_gemm_ragged"] == before + 1
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = qmm.int8_gemm_ragged(xp, xs, w, ws, torch.int32, packed)
    for seed in (1, 2):
        x.copy_(_operands(cuda, M, K, N, packed, seed=seed)[0])
        xp.copy_(x)
        graph.replay()
        eager = qmm.int8_gemm_ragged(xp, xs, w, ws, torch.int32, packed)
        torch.cuda.synchronize()
        assert torch.equal(y, eager)
        assert torch.equal(y, qmm.int8_gemm_ref(x, xs, w, ws, torch.int32,
                                                packed))


def test_gemm_route_follows_tma_contract(cuda):
    """Every main-path shape takes the TMA kernel (path S's K = 18943
    too), the ragged-N and W4 (K/2) % 16 != 0 edges the ragged one; an x
    that is not 16-byte aligned takes the TMA kernel through a padded
    copy."""
    for M, K, N, packed in _MAIN_GEMM + _EDGES:
        assert _counter("int8_gemm", K, N, packed) == (
            "int8_gemm" if N % 16 == 0 and not packed or (
                M, K, N, packed) in _MAIN_GEMM else "int8_gemm_ragged")
    x, xs, w, ws = _operands(cuda, 64, 1296, 256, False)
    xo = x.reshape(-1)[8:8 + 64 * 1280].reshape(64, 1280)  # 8 bytes off
    before = dict(qmm.LAUNCHES)
    y = qmm.int8_gemm(xo, xs, w[:1280].contiguous(), ws, torch.int32)
    assert qmm.LAUNCHES["int8_gemm"] == before["int8_gemm"] + 1
    assert qmm.LAUNCHES["int8_gemm_ragged"] == before["int8_gemm_ragged"]
    assert torch.equal(y, qmm.int8_gemm_ref(xo, xs, w[:1280].contiguous(), ws,
                                            torch.int32))


def _padded(x):
    """x's values in rows padded to a multiple of 16 bytes (the layout of
    ``qmm._codes_out``); the pad bytes hold garbage that must not count."""
    M, K = x.shape
    buf = torch.full((M, -(-K // 16) * 16), 99, dtype=torch.int8,
                     device=x.device)
    buf[:, :K] = x
    return buf[:, :K]


# the K tail of the TMA kernel on int8 weights: the RMS split's K = 18943
# and K = 1001, at ragged and full token counts, with x in padded rows (the
# served layout) and contiguous (the wrapper pads it by one copy)
@pytest.mark.parametrize("padded", [True, False])
@pytest.mark.parametrize("M", [33, 77, 1024, 4096])
@pytest.mark.parametrize("K,N", [(18943, 3584), (1001, 1024)])
def test_int8_gemm_k_tail(cuda, M, K, N, padded):
    x, xs, w, ws = _operands(cuda, M, K, N, False)
    xin = _padded(x) if padded else x
    assert xin.stride(0) % 16 == 0 or not padded
    before = dict(qmm.LAUNCHES)
    acc = qmm.int8_gemm(xin, xs, w, ws, torch.int32)
    y = qmm.int8_gemm(xin, xs, w, ws, torch.bfloat16)
    assert qmm.LAUNCHES["int8_gemm"] == before["int8_gemm"] + 2
    assert qmm.LAUNCHES["int8_gemm_ragged"] == before["int8_gemm_ragged"]
    torch.cuda.synchronize()
    assert torch.equal(acc, qmm.int8_gemm_ref(x, xs, w, ws, torch.int32))
    assert torch.equal(y, qmm.int8_gemm_ref(x, xs, w, ws, torch.bfloat16))


def test_wrapper_raises_on_unsupported_shape(cuda):
    # N % 4 != 0 is no longer refused: the ragged kernel takes any N
    x, xs, w, ws = _operands(cuda, 40, 96, 66, False)
    assert torch.equal(qmm.int8_gemm(x, xs, w, ws),
                       qmm.int8_gemm_ref(x, xs, w, ws))
    assert torch.equal(qmm.int8_gemm_ragged(x, xs, w, ws),
                       qmm.int8_gemm_ref(x, xs, w, ws))
    x, xs, w, ws = _operands(cuda, 40, 96, 64, True)
    with pytest.raises(ValueError):  # packed rows of another K
        qmm.int8_gemm(x, xs, w[:40].contiguous(), ws, packed=True)
    with pytest.raises(ValueError):
        qmm.int8_gemm_ragged(x, xs, w[:40].contiguous(), ws, packed=True)
    # the C entry refuses what the TMA kernel does not take, whatever the
    # wrapper sends (an x row stride that is no multiple of 16 bytes; packed
    # W4 with (K/2) % 16 != 0)
    from mquant_tpu_torch.kernels._build import load

    x, xs, w, ws = _operands(cuda, 40, 40, 64, False)
    out = torch.empty((40, 64), dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    assert load().mq_int8_gemm(
        x.data_ptr(), 40, w.data_ptr(), xs.data_ptr(), ws.data_ptr(),
        out.data_ptr(), 40, 40, 64, 0, 2, 128, stream) != 0
    assert load().mq_int8_gemm(
        x.data_ptr(), 48, w.data_ptr(), xs.data_ptr(), ws.data_ptr(),
        out.data_ptr(), 40, 40, 64, 1, 2, 128, stream) != 0
    # the ragged entry takes that W4, but no x row stride off 16 bytes and
    # no odd K for packed W4
    assert load().mq_int8_gemm_ragged(
        x.data_ptr(), 40, w.data_ptr(), xs.data_ptr(), ws.data_ptr(),
        out.data_ptr(), 40, 40, 64, 0, 2, 128, stream) != 0
    assert load().mq_int8_gemm_ragged(
        x.data_ptr(), 48, w.data_ptr(), xs.data_ptr(), ws.data_ptr(),
        out.data_ptr(), 40, 39, 64, 1, 2, 128, stream) != 0


def _tail_inputs(dev, T, n, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((T, n), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2)]


def _check_codes(q, ref):
    d = (q.int() - ref.int()).abs()
    assert int(d.max()) <= 1
    assert float((d > 0).float().mean()) <= 0.01


@pytest.mark.parametrize("T,n", [(1024, 18944), (256, 18944), (5, 18944),
                                 (3, 512), (2, 16384)])
def test_fused_swiglu_had_quant(cuda, T, n):
    g, u = _tail_inputs(cuda, T, n)
    s = torch.tensor(0.05, device=cuda)
    before = fwht.LAUNCHES["fused_swiglu_had_quant"]
    q = fwht.fused_swiglu_had_quant(g, u, s)
    assert fwht.LAUNCHES["fused_swiglu_had_quant"] == before + 1
    ref = fwht.fused_swiglu_had_quant_ref(g, u, s)
    torch.cuda.synchronize()
    assert q.dtype == torch.int8 and q.shape == (T, n)
    _check_codes(q, ref)


def test_fused_tail_takes_fused_gate_up_halves(cuda):
    """g and u as the two halves of one (T, 2n) gate|up output, as
    qlinear_group hands them over: the codes of contiguous copies."""
    g, u = _tail_inputs(cuda, 256, 18944, seed=1)
    gu = torch.cat([g, u], dim=-1)[None]
    s = torch.tensor(0.05, device=cuda)
    q = fwht.fused_swiglu_had_quant(gu[..., :18944], gu[..., 18944:], s)
    assert torch.equal(q[0], fwht.fused_swiglu_had_quant(g, u, s))


def test_fused_tail_raises_on_unsupported(cuda):
    g, u = _tail_inputs(cuda, 4, 2368)  # 148 · 16: m != 128
    with pytest.raises(ValueError):
        fwht.fused_swiglu_had_quant(g, u, 0.05)
    g, u = _tail_inputs(cuda, 4, 18944)
    with pytest.raises(ValueError):  # f16 (bf16 and f32 are the contract)
        fwht.fused_swiglu_had_quant(g.half(), u.half(), 0.05)
    with pytest.raises(ValueError):  # per-token scale
        fwht.fused_swiglu_had_quant(g, u, torch.ones(4, device=cuda))
    wide = torch.cat([g, g[:, :8]], dim=-1)
    with pytest.raises(ValueError):  # rows 2 bytes off 16-byte alignment
        fwht.fused_swiglu_had_quant(wide[:, 1:18945], wide[:, 1:18945], 0.05)


def _bf16(dev, *shape, sd=1.0, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * sd).to(torch.bfloat16)


# the probe's (1024, 3584) and the edges T = 1, T = 333; a narrow row
@pytest.mark.parametrize("T,n", [(1024, 3584), (1, 3584), (333, 3584),
                                 (7, 128)])
def test_rms_norm_quant(cuda, T, n):
    x, w = _bf16(cuda, T, n, sd=3.0), _bf16(cuda, n, sd=0.5, seed=1)
    s = torch.tensor(0.05, device=cuda)
    before = fwht.LAUNCHES["rms_norm_quant"]
    q = fwht.rms_norm_quant(x, w, s)
    assert fwht.LAUNCHES["rms_norm_quant"] == before + 1
    ref = fwht.rms_norm_quant_ref(x, w, s)
    torch.cuda.synchronize()
    assert q.dtype == torch.int8 and q.shape == (T, n)
    d = (q.int() - ref.int()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3


# the probe's (1024, 18944); K = 28, 4 (pow2 512) and 128 (pow2 16384)
@pytest.mark.parametrize("T,n", [(1024, 18944), (256, 3584), (3, 512),
                                 (2, 16384)])
def test_had_quant(cuda, T, n):
    x = _bf16(cuda, T, n)
    s = torch.tensor(0.05, device=cuda)
    before = fwht.LAUNCHES["had_quant"]
    q = fwht.had_quant(x, s)
    assert fwht.LAUNCHES["had_quant"] == before + 1
    ref = fwht.had_quant_ref(x, s)
    torch.cuda.synchronize()
    assert q.dtype == torch.int8 and q.shape == (T, n)
    _check_codes(q, ref)


def _check_fwht(y, ref, dtype, T, n):
    assert y.dtype == dtype and y.shape == (T, n)
    y, ref = y.float(), ref.float()
    mag = float(ref.abs().max())
    if dtype == torch.float32:
        assert float((y - ref).abs().max()) <= 1e-5 * mag
    else:  # one bf16 ulp, plus the f32 bound for outputs near zero
        m = torch.maximum(y.abs(), ref.abs()).clamp(min=2.0**-126)
        ulp = torch.exp2(torch.floor(torch.log2(m)) - 7)
        assert bool(((y - ref).abs() <= ulp + 1e-5 * mag).all())


# K = 148, pow2 n (K = 32, 128), K = 1, K = 28; K = 156 (n = 19968: the
# random orthogonal block, no scaled sign matrix: the dense route)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,n", [(1024, 18944), (64, 4096), (5, 128),
                                 (3, 16384), (9, 3584), (64, 19968)])
def test_fwht_two_matmul(cuda, T, n, dtype):
    x = _bf16(cuda, T, n).to(dtype)
    before = fwht.LAUNCHES["fwht_two_matmul"]
    y = fwht.fwht_two_matmul(x)
    assert fwht.LAUNCHES["fwht_two_matmul"] == before + 1
    ref = fwht.fwht_two_matmul_ref(x)
    torch.cuda.synchronize()
    _check_fwht(y, ref, dtype, T, n)


# the wgmma kernel at token counts below, at and above the persistent grid,
# K = 148, pow2 n (K = 32) and K = 1: two calls bit-equal (the f32 sums run
# in a fixed order), both within the bounds above
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [18944, 4096, 128])
@pytest.mark.parametrize("T", [1, 5, 133, 1024])
def test_fwht_two_matmul_deterministic(cuda, T, n, dtype):
    x = (_bf16(cuda, T, n, seed=T).float()
         * torch.rand((T, n), device=cuda) * 4).to(dtype)
    y = fwht.fwht_two_matmul(x)
    assert torch.equal(y, fwht.fwht_two_matmul(x))
    _check_fwht(y, fwht.fwht_two_matmul_ref(x), dtype, T, n)


def test_probe_kernels_raise_on_unsupported(cuda):
    s = torch.tensor(0.05, device=cuda)
    x = _bf16(cuda, 4, 2368)  # 148 · 16: m != 128
    for fn in (fwht.had_quant, lambda t, _s: fwht.fwht_two_matmul(t)):
        with pytest.raises(ValueError):
            fn(x, s)
        with pytest.raises(ValueError):  # pow2 n = 32768 splits m = 256
            fn(_bf16(cuda, 2, 32768), s)
    x = _bf16(cuda, 4, 3584)
    with pytest.raises(ValueError):  # f16 (bf16 and f32 are had_quant's)
        fwht.had_quant(x.half(), s)
    with pytest.raises(ValueError):
        fwht.rms_norm_quant(x.float(), x[0], s)
    with pytest.raises(ValueError):  # fp16 into fwht
        fwht.fwht_two_matmul(x.half())
    with pytest.raises(ValueError):  # per-token scale
        fwht.had_quant(x, torch.ones(4, device=cuda))
    with pytest.raises(ValueError):  # w of another width
        fwht.rms_norm_quant(x, x[0, :128], s)
    with pytest.raises(ValueError):  # n % 16 != 0
        fwht.rms_norm_quant(x[:, :3576].contiguous(), x[0, :3576], s)
    with pytest.raises(ValueError):  # column stride 2
        fwht.rms_norm_quant(x[:, ::2], x[0, ::2].contiguous(), s)
    wide = torch.cat([x, x[:, :8]], dim=-1)
    with pytest.raises(ValueError):  # rows 2 bytes off 16-byte alignment
        fwht.fwht_two_matmul(wide[:, 1:3585])


ATTN_RTOL = 1e-2


def _close(out, ref):
    out, ref = out.float(), ref.float()
    assert bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= ATTN_RTOL * float(ref.abs().max())


def _decode_operands(dev, B, S, H, KVH, pos, start, seed=0):
    """bf16 operands; cache columns outside [start, pos) poisoned."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *sh: torch.randn(sh, generator=g, device=dev).to(  # noqa: E731
        torch.bfloat16)
    q, kn, vn = r(B, 1, H, 128), r(B, 1, KVH, 128), r(B, 1, KVH, 128)
    kc, vc = r(B, S, KVH, 128), r(B, S, KVH, 128)
    cols = torch.arange(S, device=dev)[None]
    p = torch.as_tensor(pos, device=dev).reshape(-1, 1)
    st = torch.as_tensor(0 if start is None else start, device=dev).reshape(-1, 1)
    bad = ((cols < st) | (cols >= p))[..., None, None]
    kc.masked_fill_(bad, 50.0)
    vc.masked_fill_(bad, 3e4)
    return q, kn, vn, kc, vc


@pytest.mark.parametrize("B,S,H,KVH,pos,start", [
    (1, 8192, 28, 4, 4223, None),
    (1, 8192, 28, 4, 1024, None),
    (4, 1088, 28, 4, 1030, [0, 37, 500, 724]),
    (4, 1088, 28, 4, [3, 700, 1087, 1], [0, 37, 500, 0]),
    (2, 64, 4, 2, 40, [0, 5]),
    (3, 96, 8, 8, [5, 37, 95], [0, 10, 33]),
    (1, 8192, 28, 4, 40, 5),  # host ints: by value, every column weighs
    # GLM-4V's G = 16 (32 / 2 heads): the CPU test's shape, one request's
    # decode and the engine's 8 rows per row
    (2, 96, 32, 2, [37, 90], [5, 20]),
    (1, 1280, 32, 2, 1200, None),
    (8, 1280, 32, 2, [1200, 77, 300, 513, 1000, 1279, 1, 640], None),
    # Qwen-VL-Chat's G = 1 (32 / 32 heads): one request's last decode
    # step and the engine burst's 4 rows
    (1, 1280, 32, 32, 1151, None),
    (4, 1280, 32, 32, [92, 315, 528, 1015], None),
])
def test_attn_decode(cuda, B, S, H, KVH, pos, start):
    q, kn, vn, kc, vc = _decode_operands(cuda, B, S, H, KVH, pos, start)
    kc_p, vc_p = kc.clone(), vc.clone()
    pos_a = pos if isinstance(pos, int) else torch.tensor(pos, device=cuda)
    st_a = torch.tensor(start, device=cuda) if isinstance(start, list) \
        else start
    before = TA.LAUNCHES["attn_decode"]
    out, kc2, vc2 = TA.attn_decode(q, kn, vn, kc, vc, pos_a, 128**-0.5,
                                   start=st_a)
    assert TA.LAUNCHES["attn_decode"] == before + 1 and kc2 is kc
    ref, _, _ = TA.attn_decode_ref(q, kn, vn, kc_p, vc_p, pos_a, 128**-0.5,
                                   start=st_a)
    torch.cuda.synchronize()
    assert torch.equal(kc, kc_p) and torch.equal(vc, vc_p)
    _close(out, ref)


# the document prefill (T 4096, 28 / 4 heads), T = 2048; T = 128 / 1024 /
# 4224 (33 tiles); G = 1 / 4 / 7; B = 2; T = 192, which is no multiple of
# the 128-row tile (its last tile is half zero-filled)
@pytest.mark.parametrize("B,T,H,KVH", [(1, 2048, 28, 4), (1, 4096, 28, 4),
                                       (2, 128, 4, 2), (1, 192, 8, 8),
                                       (1, 128, 28, 4), (1, 1024, 28, 4),
                                       (1, 4224, 28, 4), (2, 1024, 8, 8),
                                       (2, 1024, 28, 7), (2, 4224, 8, 2)])
def test_flash_attn_causal(cuda, B, T, H, KVH):
    g = torch.Generator(device=cuda).manual_seed(1)
    r = lambda *sh: torch.randn(sh, generator=g, device=cuda).to(  # noqa: E731
        torch.bfloat16)
    q, k, v = r(B, T, H, 128), r(B, T, KVH, 128), r(B, T, KVH, 128)
    before = TF.LAUNCHES["flash_attn_causal"]
    out = TF.flash_attention_causal(q, k, v, 128**-0.5)
    assert TF.LAUNCHES["flash_attn_causal"] == before + 1
    ref = TF.flash_attention_causal_ref(q, k, v, 128**-0.5)
    torch.cuda.synchronize()
    _close(out, ref)


# the contract's edges of the one-launch kernel, with the columns outside
# [start, pos) poisoned: G = 1, 4, 7, 8, 9, 12; a per-row pos with an empty row
# (pos == start, pos == 0) and a row of pos 1; device indices (33 splits a
# row on the cache length) with a short row, so most of its splits are empty
@pytest.mark.parametrize("B,S,H,KVH,pos,start", [
    (1, 4096, 4, 4, 3000, 17),
    (2, 512, 8, 2, [300, 5], [0, 5]),
    (1, 8192, 28, 4, 1, None),
    (3, 256, 16, 2, [200, 0, 255], [10, 0, 3]),
    (1, 8192, 28, 4, [10], [0]),
    (2, 2048, 28, 4, [2047, 3], [1000, 3]),
    (2, 512, 18, 2, [300, 5], [0, 5]),
    (1, 1024, 24, 2, 700, 3),
])
def test_attn_decode_edges(cuda, B, S, H, KVH, pos, start):
    test_attn_decode(cuda, B, S, H, KVH, pos, start)


def test_attn_decode_cuda_graph(cuda):
    """One launch, capturable with device-side pos: a CUDA graph replayed at
    two positions equals eager calls (written cache rows equal, outputs
    bit-equal) and the plain version within the bound; the arrival counters
    are back at zero after every call."""
    B, S, H, KVH = 2, 2048, 28, 4
    q, kn, vn, kc, vc = _decode_operands(cuda, B, S, H, KVH, S, None)
    kc0, vc0 = kc.clone(), vc.clone()
    pos = torch.tensor([100, 700], dtype=torch.int32, device=cuda)
    start = torch.tensor([0, 3], dtype=torch.int32, device=cuda)
    TA.attn_decode(q, kn, vn, kc.clone(), vc.clone(), pos, 128**-0.5,
                   start=start)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, _, _ = TA.attn_decode(q, kn, vn, kc, vc, pos, 128**-0.5,
                                   start=start)
    for p in ([100, 700], [1500, 2]):
        kc.copy_(kc0)
        vc.copy_(vc0)
        pos.copy_(torch.tensor(p, dtype=torch.int32, device=cuda))
        graph.replay()
        kc_e, vc_e = kc0.clone(), vc0.clone()
        eager, _, _ = TA.attn_decode(q, kn, vn, kc_e, vc_e, pos.clone(),
                                     128**-0.5, start=start)
        kc_p, vc_p = kc0.clone(), vc0.clone()
        ref, _, _ = TA.attn_decode_ref(q, kn, vn, kc_p, vc_p, pos.clone(),
                                       128**-0.5, start=start)
        torch.cuda.synchronize()
        assert torch.equal(kc, kc_e) and torch.equal(vc, vc_e)
        assert torch.equal(kc, kc_p) and torch.equal(vc, vc_p)
        assert torch.equal(out, eager)
        _close(out, ref)
        assert int(TA._COUNTERS[cuda.index or 0].abs().sum()) == 0


def test_attention_wrappers_raise_on_unsupported(cuda):
    q, kn, vn, kc, vc = _decode_operands(cuda, 1, 64, 4, 2, 10, None)
    with pytest.raises(ValueError):  # non-bf16 cache
        TA.attn_decode(q, kn, vn, kc.float(), vc.float(), 10, 0.1)
    with pytest.raises(ValueError):  # head_dim != 128
        TA.attn_decode(q[..., :64].contiguous(), kn[..., :64].contiguous(),
                       vn[..., :64].contiguous(), kc[..., :64].contiguous(),
                       vc[..., :64].contiguous(), 10, 0.1)
    q17, kn17, vn17, kc17, vc17 = _decode_operands(cuda, 1, 64, 34, 2, 10,
                                                   None)
    with pytest.raises(ValueError):  # G = 17: beyond one m16 tile
        TA.attn_decode(q17, kn17, vn17, kc17, vc17, 10, 0.1)
    x = torch.zeros((1, 128, 2, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):  # head_dim != 128
        TF.flash_attention_causal(x, x, x, 0.1)
    for dt in (torch.float32, torch.float16):
        with pytest.raises(ValueError):  # non-bf16
            TF.flash_attention_causal(*(torch.zeros(
                (1, 128, 2, 128), dtype=dt, device=cuda),) * 3, 0.1)
    x = torch.zeros((1, 96, 2, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):  # T % 64 != 0
        TF.flash_attention_causal(x, x, x, 0.1)
    x = torch.zeros((1, 128, 2, 256), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):  # head_dim 256
        TF.flash_attention_causal(x, x, x, 0.1)


def _within_ulp_slack(y, ref):
    """One bf16 ulp at max(|y|, |ref|), plus 1e-5 of max |ref|."""
    y, ref = y.float(), ref.float()
    m = torch.maximum(y.abs(), ref.abs()).clamp(min=2.0**-126)
    ulp = torch.exp2(torch.floor(torch.log2(m)) - 7)
    return bool(((y - ref).abs() <= ulp + 1e-5 * ref.abs().max()).all())


# the probe's (8, 3584, 19968); one and five rows; N = 1040 (a partial
# 128-column block); a K that is no multiple of 4 at N % 16 == 8 (cp.async
# rows, the x tail); N % 16 == 8 at an aligned K, many K splits (18944
# rows) and one short K
@pytest.mark.parametrize("M,K,N", [(8, 3584, 19968), (1, 3584, 19968),
                                   (5, 3584, 1040), (3, 2051, 136),
                                   (8, 3584, 1032), (7, 18944, 3592),
                                   (2, 5, 8)])
def test_w8_bf16_gemv(cuda, M, K, N):
    g = torch.Generator(device=cuda).manual_seed(M + N)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    w = torch.randint(-127, 127, (K, N), generator=g, device=cuda,
                      dtype=torch.int8)
    ws = torch.rand((N,), generator=g, device=cuda) * 0.01 + 1e-3
    before = qmm.LAUNCHES["w8_bf16_gemv"]
    y = qmm.w8_bf16_gemv(x, w, ws)
    assert qmm.LAUNCHES["w8_bf16_gemv"] == before + 1
    ref = qmm.w8_bf16_gemv_ref(x, w, ws)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and y.shape == (M, N)
    assert _within_ulp_slack(y, ref)
    assert torch.equal(y, qmm.w8_bf16_gemv(x, w, ws))  # deterministic sums


@pytest.mark.parametrize("M,K,N", [(8, 3584, 19968), (5, 2051, 1032)])
def test_w8_bf16_gemv_one_launch_and_graph(cuda, M, K, N):
    """One device operation per call (TMA and cp.async rows: a call captured
    in a CUDA graph is one kernel node, no memset), and a CUDA graph
    replayed on two inputs equal to eager calls, bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(N)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    w = torch.randint(-127, 127, (K, N), generator=g, device=cuda,
                      dtype=torch.int8)
    ws = torch.rand((N,), generator=g, device=cuda) * 0.01 + 1e-3
    qmm.w8_bf16_gemv(x, w, ws)
    torch.cuda.synchronize()
    before = qmm.LAUNCHES["w8_bf16_gemv"]
    assert _graph_node_types(lambda: qmm.w8_bf16_gemv(x, w, ws)) == [0]
    assert qmm.LAUNCHES["w8_bf16_gemv"] == before + 1
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = qmm.w8_bf16_gemv(x, w, ws)
    for seed in (1, 2):
        x.copy_(torch.randn((M, K), generator=g, device=cuda))
        graph.replay()
        eager = qmm.w8_bf16_gemv(x, w, ws)
        torch.cuda.synchronize()
        assert torch.equal(y, eager)
        assert _within_ulp_slack(y, qmm.w8_bf16_gemv_ref(x, w, ws))


# the probe's (8, 18944, 3584); one row; K/2 odd (the predicated tail)
@pytest.mark.parametrize("variant", [0, 1, 2, 3])
@pytest.mark.parametrize("M,K,N", [(8, 18944, 3584), (1, 3584, 4608),
                                   (3, 1002, 1040)])
def test_w4_unpack_gemv(cuda, M, K, N, variant):
    x, xs, w, ws = _operands(cuda, M, K, N, True)
    before = qmm.LAUNCHES["w4_unpack_gemv"]
    acc = qmm.w4_unpack_gemv(x, w, variant)
    assert qmm.LAUNCHES["w4_unpack_gemv"] == before + 1
    assert torch.equal(acc, qmm.w4_unpack_gemv_ref(x, w, variant))
    if variant:
        ones_m, ones_n = torch.ones(M, device=cuda), torch.ones(N, device=cuda)
        assert torch.equal(acc, qmm.w4a8_gemv_ref(x, ones_m, w, ones_n,
                                                  torch.int32))
        if (K // 2) % 4 == 0:  # the served kernel's contract
            assert torch.equal(acc, qmm.w4a8_gemv(x, ones_m, w, ones_n,
                                                  torch.int32))


@pytest.mark.parametrize("variant", [0, 1, 2, 3])
def test_w4_unpack_gemv_cuda_graph(cuda, variant):
    """One launch, capturable: the variant's CUDA graph replayed on two
    inputs equals eager calls and the plain version, int32 bit for bit."""
    x, _, w, _ = _operands(cuda, 8, 18944, 3584, True)
    qmm.w4_unpack_gemv(x, w, variant)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = qmm.w4_unpack_gemv(x, w, variant)
    for seed in (1, 2):
        x.copy_(_operands(cuda, 8, 18944, 3584, True, seed=seed)[0])
        graph.replay()
        eager = qmm.w4_unpack_gemv(x, w, variant)
        torch.cuda.synchronize()
        assert torch.equal(y, eager)
        assert torch.equal(y, qmm.w4_unpack_gemv_ref(x, w, variant))


@pytest.mark.parametrize("variant", [0, 1, 2, 3])
def test_w4_unpack_gemv_one_device_op(cuda, variant):
    """One device operation per call, the tensor-core GEMV (the profiler's
    count): no memset, workspace or second kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, _, w, _ = _operands(cuda, 1, 3584, 4608, True)
    qmm.w4_unpack_gemv(x, w, variant)
    torch.cuda.synchronize()
    # the first profiler run of a process may miss its first kernel while
    # the tracer starts: one run first, then the one counted
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                qmm.w4_unpack_gemv(x, w, variant)
            torch.cuda.synchronize()
    ops = {e.key: e.count for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA}
    assert sum(ops.values()) == 3, ops
    assert all("gemv_tc_kernel" in k for k in ops), ops


def _int32_pair(dev, T, n, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randint(-2**20, 2**20, (T, n), generator=g, device=dev,
                          dtype=torch.int32) for _ in range(2)]


# the probe's (1024, 18944); T = 5; K = 28 (n = 3584)
@pytest.mark.parametrize("T,n", [(1024, 18944), (5, 18944), (64, 3584)])
def test_dequant_swiglu_had_quant(cuda, T, n):
    gi, ui = _int32_pair(cuda, T, n)
    gs = torch.rand((n,), device=cuda) * 2e-6 + 1e-7
    us = torch.rand((n,), device=cuda) * 2e-6 + 1e-7
    s = torch.tensor(0.05, device=cuda)
    before = fwht.LAUNCHES["dequant_swiglu_had_quant"]
    q = fwht.dequant_swiglu_had_quant(gi, ui, gs, us, s, -127, 127)
    assert fwht.LAUNCHES["dequant_swiglu_had_quant"] == before + 1
    ref = fwht.dequant_swiglu_had_quant_ref(gi, ui, gs, us, s, -127, 127)
    torch.cuda.synchronize()
    assert q.dtype == torch.int8 and q.shape == (T, n)
    assert int(q.min()) >= -127 and int(q.max()) <= 127
    _check_codes(q, ref)
    gu = torch.cat([gi, ui], dim=-1)  # the halves of one gate|up output
    assert torch.equal(q, fwht.dequant_swiglu_had_quant(
        gu[:, :n], gu[:, n:], gs, us, s, -127, 127))


# the persistent tail kernel in its three input modes over token counts
# below, at and above a block per SM (T = 1, 5, 255, 256, 1024, 4096 at
# 132 SMs: 1-32 tokens a block, ragged), each on the two halves of one
# (T, 2n) row (g and u at the fused gate|up stride); bf16 and f32 rows
# (whole-row ring slots) and int32 rows (5 slots of 6 chunks a token)
_TAIL_MODES = [("fused_swiglu_had_quant", torch.bfloat16),
               ("fused_swiglu_had_quant", torch.float32),
               ("had_quant", torch.bfloat16), ("had_quant", torch.float32),
               ("dequant_swiglu_had_quant", torch.int32)]


@pytest.mark.parametrize("name,dtype", _TAIL_MODES)
@pytest.mark.parametrize("T", [1, 5, 255, 256, 1024, 4096])
def test_tail_modes_strided(cuda, name, dtype, T):
    n = 18944
    gen = torch.Generator(device=cuda).manual_seed(T)
    if dtype == torch.int32:
        gu = torch.randint(-2**20, 2**20, (T, 2 * n), generator=gen,
                           device=cuda, dtype=torch.int32)
    else:
        gu = (torch.randn((T, 2 * n), generator=gen, device=cuda)
              * (3.0 if name == "had_quant" else 1.0)).to(dtype)
    g, u = gu[:, :n], gu[:, n:]
    s = torch.tensor(0.05, device=cuda)
    sc = [torch.rand((n,), generator=gen, device=cuda) * 2e-6 + 1e-7
          for _ in range(2)]
    args = {"fused_swiglu_had_quant": (g, u, s), "had_quant": (u, s),
            "dequant_swiglu_had_quant": (g, u, *sc, s)}[name]
    before = fwht.LAUNCHES[name]
    q = fwht.KERNELS[name](*args)
    assert fwht.LAUNCHES[name] == before + 1
    ref = fwht.PLAIN[name](*args)
    torch.cuda.synchronize()
    assert q.dtype == torch.int8 and q.shape == (T, n)
    _check_codes(q, ref)
    assert torch.equal(q, fwht.KERNELS[name](*(
        a.contiguous() if a.ndim == 2 else a for a in args)))


@pytest.mark.parametrize("qrange", [(-127, 127), (-8, 7)])
@pytest.mark.parametrize("name", ["fused_swiglu_had_quant", "had_quant",
                                  "rms_norm_quant"])
def test_code_range(cuda, name, qrange):
    x = _bf16(cuda, 256, 3584, sd=3.0)
    s = torch.tensor(0.05, device=cuda)
    args = {"fused_swiglu_had_quant": (x, x * 0.5, s),
            "had_quant": (x, s), "rms_norm_quant": (x, x[0], s, 1e-6)}[name]
    q = fwht.KERNELS[name](*args, *qrange)
    ref = fwht.PLAIN[name](*args, *qrange)
    torch.cuda.synchronize()
    assert int(q.min()) == qrange[0] and int(q.max()) == qrange[1]
    _check_codes(q, ref)


def test_probe_kernels_raise_outside_contract(cuda):
    x = _bf16(cuda, 2, 64)
    w = torch.zeros((64, 36), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):  # N % 8 != 0
        qmm.w8_bf16_gemv(x, w[:, :33].contiguous(), torch.ones(33,
                                                               device=cuda))
    xq = torch.zeros((2, 64), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):  # N % 16 != 0
        qmm.w4_unpack_gemv(xq, w[:32].contiguous(), 1)
    gi, ui = _int32_pair(cuda, 2, 512)
    one = torch.ones(512, device=cuda)
    with pytest.raises(ValueError):  # bf16 g, u
        fwht.dequant_swiglu_had_quant(gi.bfloat16(), ui.bfloat16(), one, one,
                                      0.05)
    with pytest.raises(ValueError):  # a scale vector of another width
        fwht.dequant_swiglu_had_quant(gi, ui, one[:256], one, 0.05)
    with pytest.raises(ValueError):  # qmin > qmax
        fwht.dequant_swiglu_had_quant(gi, ui, one, one, 0.05, 3, 2)


# ---------------------------------------------------------------------------
# the decode loop as a CUDA graph (serve.generate.DecodeLoop)
# ---------------------------------------------------------------------------


def _small_w4a8(cuda, max_len=128):
    """A 2-layer W4A8 decoder at widths inside every kernel's contract
    (head_dim 128, block Hadamard 128 before ``down``, int8 lm_head)."""
    from mquant_tpu_torch import random_init as R
    from mquant_tpu_torch.models.llm import DecoderConfig
    from mquant_tpu_torch.serve.generate import Generator

    cfg = DecoderConfig(vocab=1024, hidden=512, n_layers=2, n_heads=4,
                        n_kv_heads=2, intermediate=1024, head_dim=128)
    g = torch.Generator(device=cuda).manual_seed(0)
    params, state = R.init_w4a8(cfg, g, cuda)
    return Generator(cfg, params, specs=R.llm_specs(), state=state,
                     mode="real", max_len=max_len)


def _eager(gen, x, n, eos=None):
    logits, cache = gen.prefill(x)
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    return gen._decode_loop(tok, cache, n, eos, with_logits=True)


def _prompt(cuda, B, T, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randint(0, 1024, (B, T), generator=g, device=cuda)


@torch.no_grad()
def test_decode_graph_tokens_equal_eager(cuda):
    gen = _small_w4a8(cuda)
    x = _prompt(cuda, 2, 37, 1)
    out = gen.generate_on_device(x, 24)
    ref, ref_logits = _eager(gen, x, 24)
    loop = gen._loop(2, None, False)
    assert loop.steps.graph is not None
    assert torch.equal(out, ref)
    assert torch.equal(loop.logits, ref_logits)
    # with an eos that one row meets: the same tokens as the eager loop
    eos = int(ref[0, 5])
    out = gen.generate_on_device(x, 24, eos_id=eos)
    assert torch.equal(out, _eager(gen, x, 24, eos)[0])
    # a ragged batch through generate_batch
    seqs = [_prompt(cuda, 1, n, 2 + n)[0] for n in (40, 9)]
    got = gen.generate_batch(seqs, max_new_tokens=16)
    logits, cache, starts = gen.prefill_batch(seqs)
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    assert got == gen._decode_loop(tok, cache, 16, None,
                                   attn_start=starts).tolist()


@torch.no_grad()
def test_decode_graph_one_replay_a_step(cuda):
    """n tokens: n − 1 replays of the captured step, and the kernels'
    launch counts grow by one captured step's launches a replay (the
    capture itself counts none)."""
    gen = _small_w4a8(cuda)
    x = _prompt(cuda, 1, 20, 3)
    gen.generate_on_device(x, 4)  # capture
    loop = gen._loop(1, None, False)
    graph = loop.steps.graph
    replays = []
    replay = graph.replay
    graph.replay = lambda: replays.append(1) or replay()
    before = dict(TA.LAUNCHES), dict(qmm.LAUNCHES)
    logits, cache = gen.prefill(x, kv=(loop.k, loop.v))
    mid = dict(TA.LAUNCHES), dict(qmm.LAUNCHES)
    loop.run(logits.argmax(-1).to(torch.int32)[:, None], cache, 17)
    assert len(replays) == 16
    assert TA.LAUNCHES["attn_decode"] - mid[0]["attn_decode"] == 16 * 2
    # per step: q|k|v, o, gate|up, down W4 GEMVs a layer, the int8 head
    assert qmm.LAUNCHES["w4a8_gemv"] - mid[1]["w4a8_gemv"] == 16 * 2 * 4
    assert qmm.LAUNCHES["int8_gemv"] - mid[1]["int8_gemv"] == 16
    assert mid[0]["attn_decode"] == before[0]["attn_decode"]


@torch.no_grad()
def test_decode_graph_ignores_a_poisoned_stale_tail(cuda):
    """The loop's cache outlives a request: NaN in every row before the
    second request (the prefill rewrites its own rows, each step its row
    pos) changes no token (ROADMAP C-w1)."""
    gen = _small_w4a8(cuda)
    gen.generate_on_device(_prompt(cuda, 1, 60, 4), 30)
    loop = gen._loop(1, None, False)
    loop.k.fill_(float("nan"))
    loop.v.fill_(float("nan"))
    x = _prompt(cuda, 1, 21, 5)
    out = gen.generate_on_device(x, 30)
    ref, ref_logits = _eager(gen, x, 30)
    assert torch.equal(out, ref)
    assert torch.equal(loop.logits, ref_logits)


@torch.no_grad()
def test_decode_graph_recaptured_when_the_cache_grows(cuda):
    gen = _small_w4a8(cuda, max_len=64)
    x = _prompt(cuda, 1, 20, 6)
    gen.generate_on_device(x, 8)
    small = gen._loop(1, None, False)
    long_x = _prompt(cuda, 1, 100, 7)
    out = gen.generate_on_device(long_x, 12)  # grows max_len to 128
    big = gen._loop(1, None, False)
    assert gen.max_len == 128 and big is not small
    assert big.k.shape[2] == 128 and big.steps.graph is not small.steps.graph
    assert torch.equal(out, _eager(gen, long_x, 12)[0])


@torch.no_grad()
def test_chained_prefill_graph_runs(cuda):
    from mquant_tpu_torch.serve.generate import measure_ttft_chained

    gen = _small_w4a8(cuda)
    before = qmm.LAUNCHES["int8_gemm"]
    t = measure_ttft_chained(gen, _prompt(cuda, 1, 64, 8), chain=4, iters=2)
    assert 0 < t < 1.0
    # eager run + (1 + 2) chains of 4 replays, 2 layers × 4 GEMMs each
    assert qmm.LAUNCHES["int8_gemm"] - before == (1 + 3 * 4) * 2 * 4


def test_cpu_drawn_init_equals_on_the_card(cuda):
    from mquant_tpu_torch.models.llm import DecoderConfig, init_decoder_params

    cfg = DecoderConfig(vocab=64, hidden=128, n_layers=2, n_heads=2,
                        n_kv_heads=1, intermediate=256)
    a = init_decoder_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    b = init_decoder_params(cfg, torch.Generator().manual_seed(0),
                            device=cuda)
    assert torch.equal(a["layers"]["down"]["w"], b["layers"]["down"]["w"].cpu())
    assert torch.equal(a["lm_head"]["w"], b["lm_head"]["w"].cpu())


# ---------------------------------------------------------------------------
# the serving engine on the card (serve.engine.ServingEngine)
# ---------------------------------------------------------------------------


def _engine(cuda, **kw):
    """The small W4A8 decoder behind a slot pool with every KV row poisoned
    with NaN (ROADMAP C-w1), the pool grown to 256 rows."""
    from mquant_tpu_torch.serve.engine import ServingEngine

    gen = _small_w4a8(cuda)
    eng = ServingEngine(gen.cfg, gen.params, specs=gen.specs, state=gen.state,
                        mode="real", slots=4, max_len=256, **kw)
    for site in ("q", "gate", "o"):  # the packed W4 bytes are shared
        key = "w_q_fused" if site != "o" else "w_q"
        assert (eng.params["layers"][site][key].data_ptr()
                == gen.params["layers"][site][key].data_ptr())
    eng.cache["k"].fill_(float("nan"))
    eng.cache["v"].fill_(float("nan"))
    return eng


_REQS = [dict(max_new_tokens=20), dict(max_new_tokens=13, temperature=0.8,
                                       top_p=0.9, seed=11),
         dict(max_new_tokens=17, frequency_penalty=0.5, temperature=1.1,
              seed=3), dict(max_new_tokens=9)]


def _serve(cuda, eng, lens=(37, 9, 64, 20)):
    rids = [eng.submit(_prompt(cuda, 1, n, 40 + n)[0].cpu().numpy(), **r)
            for n, r in zip(lens, _REQS)]
    outs = eng.run()
    return [outs[r] for r in rids], [eng.logprobs_of(r) for r in rids]


@torch.no_grad()
def test_engine_graph_block_equals_eager_block(cuda):
    """The captured decode block (greedy and sampled rows, penalties, one
    replay a step) against the same engine with the step run eagerly:
    tokens and logprobs equal; ``attn_decode`` launched with per-row
    positions; one graph."""
    eng = _engine(cuda, sample_top_k=8, steps_per_block=4)
    before = TA.LAUNCHES["attn_decode"]
    got = _serve(cuda, eng)
    assert TA.LAUNCHES["attn_decode"] > before
    assert eng.stats()["graphs"] == 1
    blk = next(iter(eng._blocks.values()))
    assert blk.graph.graph is not None
    ref = _engine(cuda, sample_top_k=8, steps_per_block=4)
    ref._grow(256)
    ref._block(False).graph.graph = None  # the step runs eagerly
    assert _serve(cuda, ref) == got


@torch.no_grad()
def test_engine_rows_equal_alone(cuda):
    """Each request equals itself served alone by the same engine (the same
    pool shape), greedy and sampled by seed."""
    eng = _engine(cuda, sample_top_k=8, steps_per_block=4)
    toks, lps = _serve(cuda, eng)
    for i, n in enumerate((37, 9, 64, 20)):
        rid = eng.submit(_prompt(cuda, 1, n, 40 + n)[0].cpu().numpy(),
                         **_REQS[i])
        assert eng.run()[rid] == toks[i], i
        assert eng.logprobs_of(rid) == lps[i]


@torch.no_grad()
def test_engine_speculative_graph_equals_eager(cuda):
    """spec_k rounds (the (B, k+1) verify, ``attn_decode`` one window row
    at a time, the acceptance and the rollback) captured against the same
    rounds run eagerly: tokens and logprobs equal."""
    res = []
    for eager in (False, True):
        eng = _engine(cuda, steps_per_block=2, spec_k=3)
        if eager:
            eng._grow(256)
            eng._block(True).graph.graph = None
        rids = [eng.submit(_prompt(cuda, 1, n, 60 + n)[0].cpu().numpy(),
                           max_new_tokens=20) for n in (30, 7, 50, 12)]
        outs = eng.run()
        res.append([(outs[r], eng.logprobs_of(r)) for r in rids])
        assert eng.stats()["spec_accept_per_round"] > 0
    assert res[0] == res[1]


@torch.no_grad()
def test_engine_speculative_against_the_greedy_engine(cuda):
    """spec_k = 3 rounds against the same requests on the engine without
    speculation, on pools of one shape (4 slots, 256 rows): every token and
    every logprob equal. The verify forward gives each window row the
    decode step's logits (``decoder_forward``'s ``verify``: ``attn_decode``
    one query row at a time, the norms, the Hadamard and float products on
    each step's rows), so the rounds emit the greedy step's bits (ROADMAP
    C-w18, closed)."""
    lens = (30, 7, 50, 12)
    res = []
    for k in (0, 3):
        eng = _engine(cuda, steps_per_block=2, spec_k=k)
        assert eng._cache_S() == 256
        rids = [eng.submit(_prompt(cuda, 1, n, 60 + n)[0].cpu().numpy(),
                           max_new_tokens=20) for n in lens]
        outs = eng.run()
        res.append([(outs[r], eng.logprobs_of(r)) for r in rids])
        if k:
            assert eng.stats()["spec_accept_per_round"] > 0
    for (tg, lg), (ts, ls) in zip(*res):
        assert len(tg) == len(ts) == 20
        assert ts == tg
        assert ls == lg


# ---------------------------------------------------------------------------
# the group-blocked epilogue and quantized KV caches
# ---------------------------------------------------------------------------


def _group_operands(dev, M, K, N, Gw, ags, wz, xz, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    xq = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                       dtype=torch.int8)
    w = torch.randint(-8, 8, (K, N), generator=g, device=dev,
                      dtype=torch.int8)
    ws = (rand(Gw, N) + 0.5) * 0.01
    ga = K // ags if ags else 1
    xs = (rand(M, ga) + 0.5) * 0.02
    return (xq, xs, torch.round(rand(*xs.shape) * 40 - 20) if xz else None,
            ags, w, ws[0] if Gw == 1 else ws,
            torch.round(rand(Gw, N) * 16 - 8) if wz else None)


@pytest.mark.parametrize("M", [1, 5, 8, 32, 33, 300])
@pytest.mark.parametrize("Gw,ags,wz,xz", [(28, None, True, True),
                                          (1, None, True, True),
                                          (4, 128, False, True),
                                          (28, None, False, False)])
def test_grouped_epilogue_equals_plain(cuda, M, Gw, ags, wz, xz):
    """``_grouped_epilogue`` on the card (int32 group accumulators from the
    integer kernels, block-diagonal at M ≤ 32 or one product a group above,
    then ``group_epilogue``) against the same function on CPU copies (the
    plain versions): bf16 and f32 outputs bit-equal; the kernels launched."""
    K, N = 3584, 512
    ops = _group_operands(cuda, M, K, N, Gw, ags, wz, xz)
    cpu = [o.cpu() if isinstance(o, torch.Tensor) else o for o in ops]
    before = dict(qmm.LAUNCHES)
    for dt in (torch.bfloat16, torch.float32):
        got = qmm._grouped_epilogue(*ops, dt)
        ref = qmm._grouped_epilogue(*cpu, dt)
        assert torch.equal(got.cpu(), ref), dt
    assert qmm.LAUNCHES["group_epilogue"] > before["group_epilogue"]
    if M <= 32:
        G = max(Gw, K // ags if ags else 1)
        name = "int8_gemv" if (M + xz) * G <= 32 else "int8_gemm"
        assert qmm.LAUNCHES[name] == before[name] + 2  # one a call


def test_blockdiag_partials_exact(cuda):
    """One product of the block-diagonal x gives every group's int32
    accumulator and W's group sums bit-equal to the exact plain dots."""
    xq, _, _, _, w, _, _ = _group_operands(cuda, 8, 3584, 512, 28, None,
                                           True, True)
    P, wsum = qmm._blockdiag_partials(xq, w, 28, ones=True)
    u = 128
    for g in range(28):
        sl = slice(g * u, (g + 1) * u)
        assert torch.equal(P[g].cpu(), qmm._exact_dot(xq[:, sl].cpu(),
                                                      w[sl].cpu()))
        assert torch.equal(wsum[g].cpu(), w[sl].cpu().sum(0,
                                                          dtype=torch.int32))


def test_group_epilogue_kernel_raises_outside_contract(cuda):
    P = torch.zeros((2, 3, 16), dtype=torch.int32, device=cuda)
    acc = torch.zeros((3, 16), device=cuda)
    xs = torch.ones((3, 1), device=cuda)
    ws = torch.ones((2, 16), device=cuda)
    with pytest.raises(ValueError):
        qmm.group_epilogue(P.float(), None, None, xs, None, ws, None, acc, 0,
                           2, 8)
    with pytest.raises(RuntimeError):  # xz without the group sums of W
        qmm.group_epilogue(P, None, None, xs, xs, ws, None, acc, 0, 2, 8)


@torch.no_grad()
@pytest.mark.parametrize("kvq", [8, 4])
def test_quantized_kv_decode_graph(cuda, kvq):
    """An int8 / int4 cache through the decode loop's CUDA graph: tokens and
    last logits equal to the eager loop, no ``attn_decode`` launch, and the
    written codes and scales bit-equal to the quantizer on the card's K/V
    copied to the CPU."""
    from mquant_tpu_torch.models import llm as TLLM
    from mquant_tpu_torch.serve.generate import Generator

    base = _small_w4a8(cuda)
    gen = Generator(base.cfg, base.params, specs=base.specs,
                    state=base.state, mode="real", max_len=128,
                    kv_quant=kvq)
    x = _prompt(cuda, 2, 37, 7)
    before = TA.LAUNCHES["attn_decode"]
    out = gen.generate_on_device(x, 24)
    loop = gen._loop(2, None, False)
    assert loop.steps.graph is not None
    ref, ref_logits = _eager(gen, x, 24)
    assert torch.equal(out, ref) and torch.equal(loop.logits, ref_logits)
    assert TA.LAUNCHES["attn_decode"] == before
    g = torch.Generator(device=cuda).manual_seed(3)
    kv = torch.randn((2, 5, 2, 128), generator=g, device=cuda) * 3
    for a, b in zip(TLLM._kv_entries(kvq, kv, kv).values(),
                    TLLM._kv_entries(kvq, kv.cpu(), kv.cpu()).values()):
        assert torch.equal(a.cpu(), b)


@torch.no_grad()
def test_quantized_pool_rows_equal_alone(cuda):
    """An int8 pool with NaN-poisoned scales: each request equal to itself
    served alone, the graph block equal to the eager block."""
    from mquant_tpu_torch.serve.engine import ServingEngine

    base = _small_w4a8(cuda)
    lens = (30, 7, 50)

    def engine():
        eng = ServingEngine(base.cfg, base.params, specs=base.specs,
                            state=base.state, mode="real", slots=4,
                            max_len=256, steps_per_block=4, kv_quant=8)
        eng.cache["k_scale"].fill_(float("nan"))
        eng.cache["v_scale"].fill_(float("nan"))
        return eng

    eng = engine()
    rids = [eng.submit(_prompt(cuda, 1, n, 80 + n)[0].cpu().numpy(),
                       max_new_tokens=12) for n in lens]
    outs = eng.run()
    for r, n in zip(rids, lens):
        one = engine()
        rr = one.submit(_prompt(cuda, 1, n, 80 + n)[0].cpu().numpy(),
                        max_new_tokens=12)
        assert one.run()[rr] == outs[r]
