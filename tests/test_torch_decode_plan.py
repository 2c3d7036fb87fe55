"""The launch plans of the two one-launch decode kernels, and the algebra
their blocks carry out, on the CPU (the kernels run only on the card).

* ``qmm._gemv_plan``: the GEMVs' channel tiles and K splits (one thread
  block cluster of at most 8 per tile) cover every packed row (W4) or int8
  row (``int8_gemv``, ``w8_bf16_gemv``) exactly once, in whole 32-row
  steps, and give every SM a block at the decode shapes.
* ``attn_decode._plan`` / ``_split_ranges``: the decode attention's column
  splits cover [start, pos) exactly once (empty splits where the row is
  short, pos == start or pos == 1) and give every SM a block at the main
  path's shapes.
* A split-and-merge reference in this file does the kernels' algebra on
  those ranges: online-softmax partials per split (an empty split gives
  m = −inf, l = 0), merged with the new token's separate term, in natural
  units with f32 probabilities (the earlier two-kernel design) and in log2
  units with each probability carried into P·V as the sum of three bf16
  terms (the one-launch kernel's tensor-core P·V). Both are held against
  ``attn_decode_ref`` and against JAX ``attn_decode_fused`` (interpret
  mode, f32 operands) at G = 1, 7 and 8 within 1e-5 of the largest
  magnitude (f32 sums in other orders against float64 here), and against
  each other within 1e-6 (three bf16 terms carry a probability's 24 bits).
* ``w4a8_gemv_ref`` against JAX ``_qmm_pallas_w4`` at M = 2, 8, 16, 32:
  int32 accumulators equal.
* Each wrapper's contract predicate and its raise agree, with no launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mquant_tpu.kernels import qmm as JK
from mquant_tpu.kernels.attn_decode import attn_decode_fused
from mquant_tpu_torch.kernels import attn_decode as TA
from mquant_tpu_torch.kernels import qmm as TK

SMS = 132  # the H100's SMs
# the decode GEMV shapes (K, N) of Qwen2-VL-7B: q|k|v, o, gate|up, down
DECODE_GEMV = [(3584, 4608), (3584, 3584), (3584, 37888), (18944, 3584)]


# ---------------------------------------------------------------------------
# the W4 GEMV's plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K,N", DECODE_GEMV + [
    (2, 16), (66, 160), (3586, 4608), (18946, 3584), (512, 256),
    (6400, 16), (40000, 128), (3584, 152064)])
def test_gemv_plan_covers_every_packed_row_once(K, N):
    R = K // 2
    tiles, splits, rps = TK._gemv_plan(K, N, SMS)
    assert tiles * TK.GEMV_TILE_N >= N > (tiles - 1) * TK.GEMV_TILE_N
    assert 1 <= splits <= TK.GEMV_MAX_CLUSTER
    assert rps % TK.GEMV_STEP_ROWS == 0
    seen = np.zeros(R, np.int64)
    for s in range(splits):
        lo, hi = s * rps, min(R, (s + 1) * rps)
        assert lo < hi  # no split is empty
        seen[lo:hi] += 1
    assert (seen == 1).all()


# the plan over K int8 rows (w8_bf16_gemv's and int8_gemv's): gemv_bench's
# shape, N % 16 == 8 at the split's K, a K tail, a K below one step; the RMS
# split's `down` (K = 18943), the int8 lm_head, the published lm_heads of
# N = 92553 and 151666, N odd, one row
@pytest.mark.parametrize("K,N", [(3584, 19968), (18944, 3592), (2051, 136),
                                 (5, 8), (18943, 3584), (3584, 152064),
                                 (4096, 92553), (3584, 151666), (1001, 1003),
                                 (1, 1)])
def test_gemv_plan_covers_every_int8_row_once(K, N):
    tiles, splits, rps = TK._gemv_plan(K, N, SMS, packed=False)
    assert tiles * TK.GEMV_TILE_N >= N > (tiles - 1) * TK.GEMV_TILE_N
    assert 1 <= splits <= TK.GEMV_MAX_CLUSTER
    assert rps % TK.GEMV_STEP_ROWS == 0
    seen = np.zeros(K, np.int64)
    for s in range(splits):
        lo, hi = s * rps, min(K, (s + 1) * rps)
        assert lo < hi  # no split is empty
        seen[lo:hi] += 1
    assert (seen == 1).all()
    if K >= 3584:  # the probe's widths: every SM has a block
        assert tiles * splits >= SMS


@pytest.mark.parametrize("K,N", DECODE_GEMV)
def test_gemv_plan_gives_every_sm_a_block(K, N):
    tiles, splits, _ = TK._gemv_plan(K, N, SMS)
    assert tiles * splits >= SMS


@pytest.mark.parametrize("M,K,N,ok", [
    (1, 3584, 4608, True), (32, 18944, 3584, True), (31, 3586, 160, True),
    (0, 3584, 4608, False), (33, 3584, 4608, False), (1, 3585, 4608, False),
    (1, 3584, 4600, False), (1, 3584, 8, False), (1, 0, 16, False)])
def test_gemv_supports(M, K, N, ok):
    assert TK.gemv_supports(M, K, N) is ok


@pytest.mark.parametrize("M,K,N", [(2, 64, 40), (33, 64, 64), (4, 64, 64),
                                   (32, 512, 160), (1, 2, 16), (1, 66, 8)])
def test_gemv_check_agrees_with_supports(M, K, N):
    """``_check_gemv``, which the wrapper calls on a card tensor before any
    launch, raises exactly outside ``gemv_supports`` (and on a weight that
    is not 16-byte aligned)."""
    w = torch.zeros((K // 2, N), dtype=torch.int8)
    if TK.gemv_supports(M, K, N):
        TK._check_gemv("w4a8_gemv", M, K, N, w)
        with pytest.raises(ValueError):  # a view 8 bytes off 16
            TK._check_gemv("w4a8_gemv", M, K, N,
                           torch.zeros(K // 2 * N + 8, dtype=torch.int8)[8:])
    else:
        with pytest.raises(ValueError):
            TK._check_gemv("w4a8_gemv", M, K, N, w)


@pytest.mark.parametrize("M", [2, 8, 16, 32])
def test_w4a8_gemv_ref_matches_pallas_w4(rng, M):
    """The GEMV's plain version (what every token-row count of the kernel
    is held to on the card) against ``_qmm_pallas_w4``'s M ≤ 32 branch."""
    K, N = 512, 256
    x = rng.integers(-127, 128, size=(M, K)).astype(np.int8)
    w = rng.integers(-8, 8, size=(K, N)).astype(np.int8)
    lo = w[:K // 2].astype(np.uint8) & 0x0F
    hi = w[K // 2:].astype(np.uint8) & 0x0F
    packed = (lo | (hi << 4)).view(np.int8)
    ones_m, ones_n = np.ones((M, 1), np.float32), np.ones((N,), np.float32)
    acc_j = JK._qmm_pallas_w4(jnp.asarray(x), jnp.asarray(ones_m),
                              {"w_q": jnp.asarray(packed),
                               "w_scale": jnp.asarray(ones_n)},
                              jnp.float32, tm=16, tn=128, tk=128,
                              interpret=True)
    acc_t = TK.w4a8_gemv_ref(torch.from_numpy(x), torch.ones(M),
                             torch.from_numpy(packed), torch.ones(N),
                             torch.int32)
    np.testing.assert_array_equal(acc_t.numpy(),
                                  np.asarray(acc_j).astype(np.int32))
    np.testing.assert_array_equal(
        acc_t.numpy(), x.astype(np.int64) @ w.astype(np.int64))


# ---------------------------------------------------------------------------
# the decode attention's plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("start,pos,splits", [
    (0, 1024, 33), (0, 1151, 33), (0, 4223, 33), (37, 1030, 9),
    (5, 40, 3), (7, 7, 5), (0, 1, 33), (0, 0, 1), (3, 103, 7),
    (1000, 2047, 33), (0, 10, 33)])
def test_split_ranges_cover_every_column_once(start, pos, splits):
    ranges = TA._split_ranges(start, pos, splits)
    assert len(ranges) == splits
    seen = np.zeros(max(pos, 1), np.int64)
    for lo, hi in ranges:
        assert lo >= start
        if lo < hi:
            seen[lo:hi] += 1
    assert (seen[start:pos] == 1).all()
    assert (seen[:start] == 0).all() and (seen[pos:] == 0).all()


@pytest.mark.parametrize("B,n_cols", [(1, 1024), (1, 1151), (1, 4223),
                                      (4, 8192)])
def test_attn_plan_gives_every_sm_a_block(B, n_cols):
    splits = TA._plan(B, 4, n_cols, SMS)
    assert splits * B * 4 >= SMS
    assert 1 <= splits <= TA._MAX_SPLITS


@pytest.mark.parametrize("B,KVH,n_cols", [(1, 4, 0), (1, 4, 1), (1, 4, 35),
                                          (64, 8, 8192), (1, 1, 10**6)])
def test_attn_plan_edges(B, KVH, n_cols):
    splits = TA._plan(B, KVH, n_cols, SMS)
    assert 1 <= splits <= TA._MAX_SPLITS
    assert splits <= max(1, -(-n_cols // TA._MIN_COLS))


def test_per_row_plan_with_an_empty_row():
    """Device indices plan on the cache length: a row with pos == start
    gets only empty splits, a row of pos 1 one column."""
    splits = TA._plan(3, 4, 8192, SMS)
    rows = TA._split_ranges(5, 5, splits), TA._split_ranges(0, 1, splits)
    assert all(lo >= hi for lo, hi in rows[0])
    assert sum(hi - lo for lo, hi in rows[1] if hi > lo) == 1


# ---------------------------------------------------------------------------
# the split-and-merge algebra
# ---------------------------------------------------------------------------


def _bf16(a):
    return float(torch.tensor(a, dtype=torch.float32).to(torch.bfloat16))


def _three_bf16(p):
    """p (rounded to f32) as hi + mid + lo, each a bf16, the sum of the
    terms in float64: the kernel's A fragments of P·V."""
    rem, total = float(np.float32(p)), 0.0
    for _ in range(3):
        term = _bf16(rem)
        total += term
        rem = float(np.float32(rem - term))
    return total


def split_merge(q, kn, vn, kc, vc, pos, start, scale, splits, log2_bf16):
    """Decode attention by the kernels' algebra, in float64: per split an
    online-softmax partial (m, l, acc) over its columns (m = −inf, l = 0
    when it has none), then the merge with the new token's term. With
    ``log2_bf16`` the scores are in log2 units and each probability,
    relative to the split's running max, enters P·V as three bf16 terms
    (the one-launch kernel); else natural units and unrounded
    probabilities."""
    B, _, H, hd = q.shape
    KVH = kc.shape[2]
    G = H // KVH
    c = scale * (np.log2(np.e) if log2_bf16 else 1.0)
    ex = np.exp2 if log2_bf16 else np.exp
    out = np.zeros((B, 1, H, hd))
    for b in range(B):
        for kh in range(KVH):
            for g in range(G):
                qv = q[b, 0, kh * G + g].astype(np.float64)
                parts = []
                for lo, hi in TA._split_ranges(int(start[b]), int(pos[b]),
                                               splits):
                    m, l, acc = -np.inf, 0.0, np.zeros(hd)
                    for col in range(lo, hi):  # one column a step
                        s = c * qv @ kc[b, col, kh].astype(np.float64)
                        mn = max(m, s)
                        a = ex(m - mn)
                        p = ex(s - mn)
                        pv = _three_bf16(p) if log2_bf16 else p
                        l = l * a + p
                        acc = acc * a + pv * vc[b, col, kh]
                        m = mn
                    parts.append((m, l, acc))
                snew = c * qv @ kn[b, 0, kh].astype(np.float64)
                M = max([snew] + [m for m, _, _ in parts])
                pn = ex(snew - M)
                L = pn + sum(ex(m - M) * l for m, l, _ in parts)
                A = pn * vn[b, 0, kh] + sum(ex(m - M) * acc
                                            for m, _, acc in parts)
                out[b, 0, kh * G + g] = A / L
    return out


@pytest.mark.parametrize("log2_bf16", [False, True])
@pytest.mark.parametrize("H,KVH", [(2, 2), (7, 1), (8, 1)])
def test_split_merge_matches_ref_and_jax(H, KVH, log2_bf16):
    rng = np.random.default_rng(7)
    B, S, hd = 2, 48, 128
    f32 = np.float32
    q = rng.normal(size=(B, 1, H, hd)).astype(f32)
    kn = rng.normal(size=(B, 1, KVH, hd)).astype(f32)
    vn = rng.normal(size=(B, 1, KVH, hd)).astype(f32)
    kc = rng.normal(size=(B, S, KVH, hd)).astype(f32)
    vc = rng.normal(size=(B, S, KVH, hd)).astype(f32)
    pos, start = np.array([41, 9], np.int32), np.array([3, 9], np.int32)
    for b in range(B):  # poison outside [start, pos): the merge never reads it
        kc[b, :start[b]] = kc[b, pos[b]:] = 50.0
        vc[b, :start[b]] = vc[b, pos[b]:] = 3e4
    scale = hd**-0.5
    # 5 splits: row 0's 38 columns in 8s (a short last one), row 1 empty
    ours = split_merge(q, kn, vn, kc, vc, pos, start, scale, 5, log2_bf16)
    ref, _, _ = TA.attn_decode_ref(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()),
        torch.from_numpy(pos), scale, start=torch.from_numpy(start))
    oj, _, _ = attn_decode_fused(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(pos), scale, start=jnp.asarray(start),
        interpret=True)
    oj = np.asarray(oj, np.float64)
    tol = 1e-5 * np.abs(oj).max()
    np.testing.assert_allclose(ours, oj, rtol=0, atol=tol)
    np.testing.assert_allclose(ours, ref.numpy(), rtol=0, atol=tol)
    if log2_bf16:  # the two algebras agree to f32 precision
        f32_way = split_merge(q, kn, vn, kc, vc, pos, start, scale, 5, False)
        np.testing.assert_allclose(ours, f32_way, rtol=0,
                                   atol=1e-6 * np.abs(oj).max())
    # row 1 (pos == start) is the new token's v alone
    np.testing.assert_allclose(ours[1, 0], np.repeat(vn[1, 0], H // KVH, 0),
                               rtol=0, atol=1e-12)


def test_attn_decode_raise_agrees_with_supports():
    """``_check_card``, which the wrapper calls on a card tensor before any
    launch, raises exactly where ``supports`` says no, at G = 1..9."""
    for G in range(1, 10):
        ops = (torch.zeros(1, 1, G, 128, dtype=torch.bfloat16),
               *(torch.zeros(1, 1, 1, 128, dtype=torch.bfloat16),) * 2,
               *(torch.zeros(1, 16, 1, 128, dtype=torch.bfloat16),) * 2)
        if TA.supports(128, G, torch.bfloat16):
            TA._check_card(*ops)
        else:
            with pytest.raises(ValueError):
                TA._check_card(*ops)
