// Attention kernels for the serving path on Hopper (sm_90a). Plain C
// interface, loaded with ctypes by mquant_tpu_torch/kernels/_build.py.
// head_dim is 128 in both (the wrappers in attn_decode.py / flash_attn.py
// check it and raise otherwise).
//
// K4  attn_decode  replaces mquant_tpu/kernels/attn_decode.py::
//                  attn_decode_fused (body _kernel): one-token GQA decode
//                  attention of one layer. q (B, H, 128) attends to the cache
//                  columns start[b] <= col < pos[b] of its KV head plus the
//                  new token (k_new, v_new) as a separate softmax term, and
//                  the new token's K/V row is written into the cache at row
//                  pos[b] in place. Scores and softmax in f32.
//     Bound: bytes. One layer reads the K and V rows of [start, pos) once
//     (2 * 4 * 128 * 2 B per column for Qwen2-VL-7B's 4 KV heads) plus q,
//     the new row and the output: 8.6 MB at pos = 4223, 2.6 us at 3.35 TB/s.
//     With batch 1 and 4 KV heads there are only 4 (b, kv head) pairs for
//     132 SMs, so the column range is split across blocks ("split-S"):
//     grid (splits, KVH, B), one launch. The scores and P.V run on the
//     tensor cores (mma.sync m16n8k16 bf16, f32 accumulation: the G <= 16
//     query rows padded to 16) and the online softmax on the fragments in
//     f32; the last block of each (b, kv head) to finish merges the
//     splits' partials with the new-token term and writes the new row.
//     Details at K4 below.
//     Columns outside [start, pos) are never read: the cp.async of a column
//     at or past the split's end reads no byte and zero-fills its row
//     (stale KV of a reused slot or a left pad cannot leak in), and the
//     softmax masks those zero rows out.
//     Numerics: the JAX kernel normalizes the probabilities and rounds them
//     to bf16 before P.V; here P.V runs on the unnormalized probabilities
//     (relative to the running max) in f32 precision, as three bf16 terms
//     on the tensor cores, and the sum is divided out at the end, so
//     outputs agree with the plain version to bf16 rounding, not bit for
//     bit; and a batch row agrees with the row served alone, whatever the
//     split boundaries, as closely as f32 sums in other orders do. The
//     written cache rows are copies, bit-equal.
//
// K5  flash_attn_causal  replaces the library Pallas kernel
//                  jax.experimental.pallas.ops.tpu.flash_attention that
//                  mquant_tpu/models/layers.py:attention calls for causal
//                  prefill with T == S >= 2048: out = softmax(q k^T * scale,
//                  causal) v, q (B, T, H, 128), k / v (B, T, KVH, 128), bf16.
//     Bound: operations. 4 * B * H * 128 * T^2 / 2 FLOPs causal: 120 GFLOP a
//     layer at T = 4096, H = 28, 0.12 ms at 989 TFLOP/s dense bf16. The
//     (T, T) scores never reach device memory: grid (T/128, H, B), a block
//     owns 128 query rows and walks the 128-row K/V tiles up to the diagonal
//     (tiles above it are never loaded; the mask is applied only inside the
//     diagonal tile). Hopper-native: a producer warp keeps TMA loads of K/V
//     in flight through an mbarrier ring while two consumer warpgroups run
//     Q.K^T and P.V on wgmma (bf16, f32 accumulation); the softmax is online
//     in f32 (running row max and sum, the accumulator rescaled per tile)
//     and P is rounded to bf16 for the second product. GQA is native: query
//     head h reads KV head h / (H / KVH), and K/V are never repeated in
//     memory. Details at K5 below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int HD = 128;
constexpr unsigned FULL = 0xffffffffu;

// 2^x (ex2.approx: what __expf computes after its multiply by log2(e))
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// K4: decode attention, split-S, one launch, mma.sync bf16
// ---------------------------------------------------------------------------
//
// Grid (splits, KVH, B): block `split` of (b, kv head) owns the columns
// [lo, hi) of [start, pos), `chunk` = ceil((pos - start) / splits) each
// (attn_decode._split_ranges is the same rule). 4 warps. The G <= 16 query
// rows of the KV head are the A operand of mma.sync.m16n8k16 (rows < G of
// an m16 tile, the rest zero), held in registers: a thread's quad holds
// rows g and g + 8 of the fragments (a0 / a2 and a1 / a3 of A, c0 / c1 and
// c2 / c3 of S and O), so G > 8 (GLM-4V's 16) fills the tile's unused
// half at the same tensor-core work, with softmax state for both rows a
// thread (NH = 2 halves; G <= 8 compiles the one half it had). K / V
// tiles of 64 columns x 128 dims come through a 2-stage cp.async ring into
// padded rows (272 B: the fragment loads are free of bank conflicts); a
// column at or past hi is zero-filled, never read. Warp w takes columns
// 16w .. 16w+15 of a tile: S = q K^T (K rows are dim-contiguous: the
// col-major B operand, one 32-bit load per register), the online softmax
// on the S fragment in the log2 domain (running max and sum per warp), P
// split into three bf16 terms (hi + mid + lo carry its 24 bits) as the A
// fragments of P V, V's B fragments by ldmatrix.trans. The 4 warps meet in
// shared memory and the block writes one (m, l, acc[128]) partial per query
// row to `part`. Then it counts itself in counters[b, kv head] (after a
// __threadfence); the block that arrives last merges the splits' partials
// (read through L2) with the new-token term (JAX _kernel's m / denom / out
// algebra), writes the output, writes k_new / v_new into cache row pos (no
// block reads it: every column read is < pos, and every block of the pair
// has finished), and sets the counter back to 0, so the next call (or a
// CUDA graph replay) starts from zero with no memset. Calls that share the
// counters must not overlap (attn_decode.py owns one buffer per device).
// An empty split (lo >= hi) writes m = -1e30, l = 0, acc = 0: weight 0.

constexpr int DEC_THREADS = 128;        // 4 warps
constexpr int DEC_TILE = 64;            // cache columns per tile, 16 a warp
constexpr int DEC_LD = HD + 8;          // bf16 per padded smem row (272 B)
constexpr int DEC_STAGES = 2;
constexpr int DEC_SMEM = DEC_STAGES * 2 * DEC_TILE * DEC_LD * 2;  // 68 KB
constexpr int MAXG = 16;                // query rows per KV head
constexpr int MAX_SPLITS = 256;         // the merge's weight table
constexpr int PART = HD + 4;            // floats of a partial: m, l, -, -, acc
constexpr float NEG_BIG = -1e30f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

using hopper::mma_bf16;

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_u32(p)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// part: (B, KVH, splits, G, PART) f32 = (m, l, -, -, acc[HD]) per query
// row (acc 16-byte aligned), m in log2 units (score * scale * log2 e). G:
// query rows per KV head, a template parameter so the merge's loads are
// unrolled for exactly G rows.
template <int G>
__global__ void __launch_bounds__(DEC_THREADS)
    decode_attn_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ kn,
                       const __nv_bfloat16* __restrict__ vn,
                       __nv_bfloat16* __restrict__ kc,
                       __nv_bfloat16* __restrict__ vc,
                       const int* __restrict__ pos,
                       const int* __restrict__ start, int pos_all,
                       int start_all, float* __restrict__ part,
                       unsigned* __restrict__ counters,
                       __nv_bfloat16* __restrict__ out, int S, int H, int KVH,
                       float scale) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float sm_m[DEC_THREADS / 32][MAXG], sm_l[DEC_THREADS / 32][MAXG];
  __shared__ float sm_pn[MAXG], sm_L[MAXG];
  __shared__ int sm_last;
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float c2 = scale * 1.4426950408889634f;  // scale · log2(e)

  const int p = min(pos ? pos[b] : pos_all, S);
  const int st = max(start ? start[b] : start_all, 0);
  const int n = max(p - st, 0);
  const int chunk = (n + splits - 1) / splits;
  const int lo = st + split * chunk;
  const int hi = min(p, lo + chunk);
  const int ntiles = hi > lo ? (hi - lo + DEC_TILE - 1) / DEC_TILE : 0;

  // q rows as A fragments: half h holds row g + 8h, qa[kk][h] / [h + 2]
  // its dims 16kk + 2t and + 8; rows >= G zero (with G <= 8 all of half 1)
  constexpr int NH = G > 8 ? 2 : 1;
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rq = g + 8 * h;
    const bool live = h < NH && rq < G;
    const __nv_bfloat16* qrow =
        q + ((long)b * H + kh * G + min(rq, G - 1)) * HD;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      qa[kk][h] = live ? *reinterpret_cast<const uint32_t*>(
                             qrow + 16 * kk + 2 * t)
                       : 0u;
      qa[kk][h + 2] = live ? *reinterpret_cast<const uint32_t*>(
                                 qrow + 16 * kk + 8 + 2 * t)
                           : 0u;
    }
  }

  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  const long row = (long)KVH * HD;
  auto load_tile = [&](int tile, int slot) {
    __nv_bfloat16* ks = ring + slot * 2 * DEC_TILE * DEC_LD;
    __nv_bfloat16* vs = ks + DEC_TILE * DEC_LD;
    const int c0 = lo + tile * DEC_TILE;
    for (int i = tid; i < DEC_TILE * (HD / 8); i += DEC_THREADS) {
      const int r = i >> 4, ch = i & 15;
      const int col = c0 + r;
      const bool live = col < hi;
      const long off =
          ((long)b * S + (live ? col : lo)) * row + (long)kh * HD + ch * 8;
      cp_async16(ks + r * DEC_LD + ch * 8, kc + off, live);
      cp_async16(vs + r * DEC_LD + ch * 8, vc + off, live);
    }
  };

  // rows g, g + 8: running max (log2 units), sum share
  float m2[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};
  float o[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

  if (ntiles > 0) load_tile(0, 0);
  cp_async_commit();
  if (ntiles > 1) load_tile(1, 1);
  cp_async_commit();
  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<1>();
    __syncthreads();
    const int slot = tile & 1;
    const __nv_bfloat16* ks = ring + slot * 2 * DEC_TILE * DEC_LD;
    const __nv_bfloat16* vs = ks + DEC_TILE * DEC_LD;
    const int cw = warp * 16;
    const int col0 = lo + tile * DEC_TILE + cw;
    if (col0 < hi) {  // warp-uniform
      float s[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t a[4] = {qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3]};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const __nv_bfloat16* kr =
              ks + (cw + 8 * j + g) * DEC_LD + 16 * kk + 2 * t;
          mma_bf16(s[j], a, *reinterpret_cast<const uint32_t*>(kr),
                   *reinterpret_cast<const uint32_t*>(kr + 8));
        }
      }
      // row g + 8h's scores: s[j][2h + e] at column col0 + 8j + 2t + e
      uint32_t pa[3][4] = {};
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        float sv[2][2], mx = NEG_BIG;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool live = col0 + 8 * j + 2 * t + e < hi;
            sv[j][e] = live ? s[j][2 * h + e] * c2 : NEG_BIG;
            mx = fmaxf(mx, sv[j][e]);
          }
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
        const float mn = fmaxf(m2[h], mx);
        const float alpha = exp2_approx(m2[h] - mn);
        m2[h] = mn;
        float pr[2][2], psum = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            pr[j][e] = sv[j][e] > 0.5f * NEG_BIG ? exp2_approx(sv[j][e] - mn)
                                                 : 0.f;
            psum += pr[j][e];
          }
        l[h] = l[h] * alpha + psum;
#pragma unroll
        for (int i = 0; i < HD / 8; ++i) {
          o[i][2 * h] *= alpha;
          o[i][2 * h + 1] *= alpha;
        }
        // P as three bf16 terms (8 + 8 + 8 significant bits: P.V in f32
        // precision, as the f32 probabilities of the earlier kernel), each
        // the A fragment of one product, the smallest first: row g + 8h's
        // columns 2t in pa[k][h], 8 + 2t in pa[k][h + 2]
#pragma unroll
        for (int k = 2; k >= 0; --k) {
          float part_[2][2];
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              part_[j][e] = __bfloat162float(__float2bfloat16_rn(pr[j][e]));
              pr[j][e] -= part_[j][e];
            }
          pa[k][h] = pack_bf16(part_[0][0], part_[0][1]);
          pa[k][h + 2] = pack_bf16(part_[1][0], part_[1][1]);
        }
      }
      const int mi = lane >> 3, r = lane & 7;
#pragma unroll
      for (int jj = 0; jj < HD / 16; ++jj) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, vs + (cw + (mi & 1) * 8 + r) * DEC_LD + 16 * jj +
                              (mi >> 1) * 8);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          mma_bf16(o[2 * jj], pa[k], vb[0], vb[1]);
          mma_bf16(o[2 * jj + 1], pa[k], vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // the slot is read: it takes tile + 2
    if (tile + 2 < ntiles) load_tile(tile + 2, slot);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();

  // the 4 warps meet over the drained ring: so[warp][row][d]
  float* so = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    l[h] += __shfl_xor_sync(FULL, l[h], 1);
    l[h] += __shfl_xor_sync(FULL, l[h], 2);
    const int rq = g + 8 * h;
    if (rq < G) {
      if (t == 0) {
        sm_m[warp][rq] = m2[h];
        sm_l[warp][rq] = l[h];
      }
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        so[(warp * MAXG + rq) * HD + 8 * i + 2 * t] = o[i][2 * h];
        so[(warp * MAXG + rq) * HD + 8 * i + 2 * t + 1] = o[i][2 * h + 1];
      }
    }
  }
  __syncthreads();
  const long pair = (long)b * KVH + kh;
  const long sstep = (long)G * PART;
  float* mine = part + (pair * splits + split) * sstep;
  for (int gg = 0; gg < G; ++gg) {
    float M = NEG_BIG;
#pragma unroll
    for (int w = 0; w < DEC_THREADS / 32; ++w) M = fmaxf(M, sm_m[w][gg]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_THREADS / 32; ++w) {
      const float e = exp2f(sm_m[w][gg] - M);
      L = fmaf(e, sm_l[w][gg], L);
      A = fmaf(e, so[(w * MAXG + gg) * HD + tid], A);
    }
    if (tid == 0) {
      mine[gg * PART] = M;
      mine[gg * PART + 1] = L;
    }
    mine[gg * PART + 4 + tid] = A;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    sm_last = atomicAdd(&counters[pair], 1u) == (unsigned)(splits - 1);
  __syncthreads();
  if (!sm_last) return;
  __threadfence();

  // the last block of (b, kv head): merge the splits and the new token.
  // Warp w takes query rows w, w + 4, ...: the new score, every split's
  // (m, l) in one load a lane, M, the split weights 2^(m_s - M) into wsm,
  // and L. Then warp w sums the acc rows of splits w, w + 4, ... (4 dims a
  // lane, U splits a round: U G 16-byte loads in flight a thread, U = 4
  // for G <= 8 and 1 above, to stay in registers), and the 4 warps meet
  // in shared memory.
  float* wsm = so + (DEC_THREADS / 32) * MAXG * HD;  // [MAXG][MAX_SPLITS]
  const float* all = part + pair * splits * sstep;
  const __nv_bfloat16* knr = kn + pair * HD;
  const __nv_bfloat16* vnr = vn + pair * HD;
  for (int gg = warp; gg < G; gg += DEC_THREADS / 32) {
    const __nv_bfloat16* qr = q + ((long)b * H + kh * G + gg) * HD;
    float dot = 0.f;
    for (int d = lane; d < HD; d += 32)
      dot = fmaf(__bfloat162float(qr[d]), __bfloat162float(knr[d]), dot);
    const float snew = warp_sum(dot) * c2;
    float2 ml[MAX_SPLITS / 32];
    float M = snew;
#pragma unroll
    for (int i = 0; i < MAX_SPLITS / 32; ++i) {
      const int s = min(lane + 32 * i, splits - 1);
      ml[i] = __ldcg(reinterpret_cast<const float2*>(all + s * sstep +
                                                     gg * PART));
      M = fmaxf(M, ml[i].x);
    }
    M = warp_max(M);
    float L = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_SPLITS / 32; ++i) {
      const int s = lane + 32 * i;
      const float w = s < splits ? exp2f(ml[i].x - M) : 0.f;
      if (s < splits) wsm[gg * MAX_SPLITS + s] = w;
      L = fmaf(w, ml[i].y, L);
    }
    L = warp_sum(L);
    if (lane == 0) {
      const float pn = exp2f(snew - M);
      sm_pn[gg] = pn;
      sm_L[gg] = L + pn;
    }
  }
  __syncthreads();
  constexpr int U = G > 8 ? 1 : 4;
  float4 a[G];
#pragma unroll
  for (int gg = 0; gg < G; ++gg) a[gg] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = warp; s0 < splits; s0 += U * (DEC_THREADS / 32)) {
    float4 v[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int sc = min(s0 + 4 * u, splits - 1);
#pragma unroll
      for (int gg = 0; gg < G; ++gg)
        v[u][gg] = __ldcg(reinterpret_cast<const float4*>(
                              all + sc * sstep + gg * PART + 4) + lane);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int sn = s0 + 4 * u;
#pragma unroll
      for (int gg = 0; gg < G; ++gg) {
        const float w = sn < splits ? wsm[gg * MAX_SPLITS + sn] : 0.f;
        a[gg].x = fmaf(w, v[u][gg].x, a[gg].x);
        a[gg].y = fmaf(w, v[u][gg].y, a[gg].y);
        a[gg].z = fmaf(w, v[u][gg].z, a[gg].z);
        a[gg].w = fmaf(w, v[u][gg].w, a[gg].w);
      }
    }
  }
  float4* red = reinterpret_cast<float4*>(so);  // [warp][MAXG][HD / 4]
#pragma unroll
  for (int gg = 0; gg < G; ++gg) red[(warp * MAXG + gg) * (HD / 4) + lane] = a[gg];
  __syncthreads();
  const float vd = __bfloat162float(vnr[tid]);
#pragma unroll
  for (int gg = 0; gg < G; ++gg) {
    float A = sm_pn[gg] * vd;
#pragma unroll
    for (int w = 0; w < DEC_THREADS / 32; ++w) A += so[(w * MAXG + gg) * HD + tid];
    out[((long)b * H + kh * G + gg) * HD + tid] =
        __float2bfloat16_rn(A / sm_L[gg]);
  }
  if (p >= 0 && p < S) {
    const long idx = ((long)b * S + p) * row + (long)kh * HD + tid;
    kc[idx] = knr[tid];
    vc[idx] = vnr[tid];
  }
  if (tid == 0) counters[pair] = 0u;
}

// ---------------------------------------------------------------------------
// K5: causal flash attention, TMA + wgmma bf16
// ---------------------------------------------------------------------------
//
// Block: 128 query rows of one head; warpgroups 0 and 1 own 64 rows each,
// warp 8 is the TMA producer. Q (128 x 128) is loaded once; K and V tiles
// of 128 rows go through a 2-stage ring (64 KB a stage). Every tile is two
// TMA boxes of 64 columns (128 bytes, the swizzle span) over the 4-D view
// (dim, head, token, batch), so tokens past T are zero-filled per batch.
// S = Q K^T is wgmma m64n128k16 with both operands K-major in shared memory
// (hd is contiguous); the online softmax runs on the f32 accumulator in
// registers, and its bf16 rounding is laid out as the A fragment of
// O += P V (wgmma with A from registers). V is read MN-major through the
// descriptor's transpose bit: the leading offset steps from dims 0-63 to
// 64-127 (one box), the stride offset from 8 key rows to the next. Each
// warpgroup issues the next tile's Q K^T right behind the current P V (one
// wait for both); the two warpgroups interleave on their own.

constexpr int FA_BM = 128, FA_BN = 128, FA_THREADS = 384;
constexpr int FA_HALF = 128 * 128;  // bytes of one 128-row x 64-dim box
constexpr int FA_TILE = 2 * FA_HALF;
constexpr int FA_STAGES = 2;
constexpr int FA_SMEM = FA_TILE * (1 + 2 * FA_STAGES) + 1024 + 64;

// S = Q K_j^T of key tile j into s, once tile j's stage has landed; qw:
// the warpgroup's 64 Q rows, kv: the K/V stages
__device__ __forceinline__ void issue_scores(float (&s)[64], const uint8_t* qw,
                                             const uint8_t* kv, uint64_t* full,
                                             int j) {
  const int slot = j % FA_STAGES;
  hopper::mbar_wait(&full[slot], (j / FA_STAGES) & 1);
  const uint8_t* kt = kv + slot * 2 * FA_TILE;
#pragma unroll
  for (int i = 0; i < 64; ++i) hopper::reg_fence(s[i]);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk / 4, off = (kk % 4) * 32;
    hopper::wgmma_bf16_ss(
        s, hopper::desc_sw128(qw + c * FA_HALF + off, 16, 1024),
        hopper::desc_sw128(kt + c * FA_HALF + off, 16, 1024), kk > 0);
  }
  hopper::wgmma_commit();
}

// The online-softmax step of one key tile, on its scores s in place (they
// become unnormalised probabilities). s[i] is row r0 + 8 * ((i >> 1) & 1),
// column col0 + (i >> 2) * 8 + 2t + (i & 1); the mask only on the diagonal
// tile. It runs in the log2 domain: exp(scale * (s - max)) =
// 2^(s * c2 - max * c2) with c2 = scale * log2(e), one FFMA and one ex2 an
// element (scale > 0, so the row max of s gives that of s * scale). m0 / m1
// become the running row maxima, a0 / a1 the rescale factors of what came
// before, rs0 / rs1 the tile's row sums.
__device__ __forceinline__ void softmax_tile(float (&s)[64], bool diag,
                                             int col0, int r0, int t, float c2,
                                             float& m0, float& m1, float& a0,
                                             float& a1, float& rs0,
                                             float& rs1) {
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (diag) {
      const int col = col0 + (i >> 2) * 8 + 2 * t + (i & 1);
      const int row = r0 + (((i >> 1) & 1) ? 8 : 0);
      if (col > row) s[i] = -INFINITY;
    }
    if ((i >> 1) & 1)
      mx1 = fmaxf(mx1, s[i]);
    else
      mx0 = fmaxf(mx0, s[i]);
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
  // tile 0 holds column 0 <= every row, so mx0 / mx1 are finite here and
  // the first rescale is 2^-inf = 0
  a0 = exp2_approx((m0 - mx0) * c2);
  a1 = exp2_approx((m1 - mx1) * c2);
  m0 = mx0;
  m1 = mx1;
  const float b0 = m0 * c2, b1 = m1 * c2;
  rs0 = rs1 = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if ((i >> 1) & 1) {
      s[i] = exp2_approx(fmaf(s[i], c2, -b1));
      rs1 += s[i];
    } else {
      s[i] = exp2_approx(fmaf(s[i], c2, -b0));
      rs0 += s[i];
    }
  }
  rs0 += __shfl_xor_sync(FULL, rs0, 1);
  rs0 += __shfl_xor_sync(FULL, rs0, 2);
  rs1 += __shfl_xor_sync(FULL, rs1, 1);
  rs1 += __shfl_xor_sync(FULL, rs1, 2);
}

// P in bf16 as the A fragments of P V: key block kk's is s[8kk .. 8kk + 7]
__device__ __forceinline__ void pack_probs(const float (&s)[64],
                                           uint32_t (&pa)[FA_BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < FA_BN / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

__global__ void __launch_bounds__(FA_THREADS, 1)
    flash_causal_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        __nv_bfloat16* __restrict__ out, int T, int H, int KVH,
                        float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Qs = smem;
  uint8_t* KVs = smem + FA_TILE;  // stage i: K at 2i tiles, V after it
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem + FA_TILE * (1 + 2 * FA_STAGES));
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + FA_STAGES;
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest rows start first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KVH);

  if (threadIdx.x == 0) {
    hopper::mbar_init(qbar, 1);
    for (int i = 0; i < FA_STAGES; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], 2);  // one arrival per consumer warpgroup
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      hopper::prefetch_map(&qmap);
      hopper::prefetch_map(&kmap);
      hopper::prefetch_map(&vmap);
      const uint64_t once = hopper::policy_evict_first();
      const uint64_t keep = hopper::policy_evict_last();
      hopper::mbar_arrive_expect_tx(qbar, FA_TILE);
      for (int c = 0; c < 2; ++c)
        hopper::tma_load_4d(Qs + c * FA_HALF, &qmap, qbar, 64 * c, h,
                            qt * FA_BM, b, once);
      for (int j = 0; j <= qt; ++j) {
        const int slot = j % FA_STAGES;
        hopper::mbar_wait(&empty[slot], ((j / FA_STAGES) & 1) ^ 1);
        uint8_t* kt = KVs + slot * 2 * FA_TILE;
        hopper::mbar_arrive_expect_tx(&full[slot], 2 * FA_TILE);
        for (int c = 0; c < 2; ++c) {
          hopper::tma_load_4d(kt + c * FA_HALF, &kmap, &full[slot], 64 * c,
                              kh, j * FA_BN, b, keep);
          hopper::tma_load_4d(kt + FA_TILE + c * FA_HALF, &vmap, &full[slot],
                              64 * c, kh, j * FA_BN, b, keep);
        }
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<232>();
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  // this thread's rows of the (T, T) problem: r0 and r0 + 8
  const int r0 = qt * FA_BM + wg * 64 + warp * 16 + g;
  float s[64], o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  // running row max of the raw scores, and row sums
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const float c2 = scale * 1.4426950408889634f;  // scale · log2(e)
  hopper::mbar_wait(qbar, 0);
  const uint8_t* qw = Qs + wg * 64 * 128;  // this warpgroup's 64 rows

  float a0, a1, rs0, rs1;
  uint32_t pa[FA_BN / 16][4];  // P in bf16: key block kk's A fragment
  issue_scores(s, qw, KVs, full, 0);
  hopper::wgmma_wait<0>();
  for (int j = 0; j <= qt; ++j) {
    const int slot = j % FA_STAGES;
    const uint8_t* vt = KVs + slot * 2 * FA_TILE + FA_TILE;
#pragma unroll
    for (int i = 0; i < 64; ++i) hopper::reg_fence(s[i]);
    softmax_tile(s, j == qt, j * FA_BN, r0, t, c2, m0, m1, a0, a1, rs0, rs1);
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      o[i] *= ((i >> 1) & 1) ? a1 : a0;
      hopper::reg_fence(o[i]);
    }
    pack_probs(s, pa);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < FA_BN / 16; ++kk)
      hopper::wgmma_bf16_rs_tb(
          o, pa[kk], hopper::desc_sw128(vt + kk * 16 * 128, FA_HALF, 1024));
    hopper::wgmma_commit();
    // the next tile's scores go in behind P V (s is free: P is packed), so
    // the tensor cores get both without a wait in between
    if (j < qt) issue_scores(s, qw, KVs, full, j + 1);
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) hopper::reg_fence(o[i]);
#pragma unroll
    for (int kk = 0; kk < FA_BN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) hopper::reg_fence(pa[kk][r]);
    if (tid == 0) hopper::mbar_arrive(&empty[slot]);
  }

  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const long qs = (long)H * HD;
  __nv_bfloat16* ob = out + (long)b * T * qs + (long)h * HD;
#pragma unroll
  for (int i = 0; i < 64; i += 4) {
    const int d = (i >> 2) * 8 + 2 * t;
    if (r0 < T)
      *reinterpret_cast<uint32_t*>(ob + (long)r0 * qs + d) =
          pack_bf16(o[i] * inv0, o[i + 1] * inv0);
    if (r0 + 8 < T)
      *reinterpret_cast<uint32_t*>(ob + (long)(r0 + 8) * qs + d) =
          pack_bf16(o[i + 2] * inv1, o[i + 3] * inv1);
  }
}

template <int G>
int launch_decode(const void* q, const void* kn, const void* vn, void* kc,
                  void* vc, const void* pos, const void* start, void* out,
                  void* part, void* counters, int pos_all, int start_all,
                  int B, int S, int H, int KVH, int splits, float scale,
                  void* stream) {
  static bool attr = false;
  if (!attr) {
    const int err = (int)cudaFuncSetAttribute(
        decode_attn_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        DEC_SMEM);
    if (err) return err;
    attr = true;
  }
  decode_attn_kernel<G><<<dim3(splits, KVH, B), DEC_THREADS, DEC_SMEM,
                          (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)kn,
      (const __nv_bfloat16*)vn, (__nv_bfloat16*)kc, (__nv_bfloat16*)vc,
      (const int*)pos, (const int*)start, pos_all, start_all, (float*)part,
      (unsigned*)counters, (__nv_bfloat16*)out, S, H, KVH, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (B, H, 128) = decode attention of q (B, H, 128) over the cache columns
// [start[b], pos[b]) and the new row; kc / vc (B, S, KVH, 128) get row pos[b]
// = kn / vn (B, KVH, 128). pos / start: (B,) int32 on the device, or null
// for one value of every row, passed by value in pos_all / start_all (a
// decode step's host position: no copy or fill kernel per layer). part: f32
// scratch of B * KVH * splits * G * 132; counters: B * KVH unsigned, zero
// before the call and zero after it. One launch; H / KVH <= 16,
// splits <= 256.
int mq_attn_decode(const void* q, const void* kn, const void* vn, void* kc,
                   void* vc, const void* pos, const void* start, void* out,
                   void* part, void* counters, int pos_all, int start_all,
                   int B, int S, int H, int KVH, int splits, float scale,
                   void* stream) {
  if (B < 1 || S < 1 || KVH < 1 || H % KVH || H / KVH < 1 ||
      H / KVH > MAXG || splits < 1 || splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  switch (H / KVH) {
    case 1: return launch_decode<1>(q, kn, vn, kc, vc, pos, start, out, part, counters, pos_all, start_all, B, S, H, KVH, splits, scale, stream);
    case 2: return launch_decode<2>(q, kn, vn, kc, vc, pos, start, out, part, counters, pos_all, start_all, B, S, H, KVH, splits, scale, stream);
    case 3: return launch_decode<3>(q, kn, vn, kc, vc, pos, start, out, part, counters, pos_all, start_all, B, S, H, KVH, splits, scale, stream);
    case 4: return launch_decode<4>(q, kn, vn, kc, vc, pos, start, out, part, counters, pos_all, start_all, B, S, H, KVH, splits, scale, stream);
    case 5: return launch_decode<5>(q, kn, vn, kc, vc, pos, start, out, part, counters, pos_all, start_all, B, S, H, KVH, splits, scale, stream);
    case 6: return launch_decode<6>(q, kn, vn, kc, vc, pos, start, out, part, counters, pos_all, start_all, B, S, H, KVH, splits, scale, stream);
    case 7: return launch_decode<7>(q, kn, vn, kc, vc, pos, start, out, part, counters, pos_all, start_all, B, S, H, KVH, splits, scale, stream);
    case 8: return launch_decode<8>(q, kn, vn, kc, vc, pos, start, out, part, counters, pos_all, start_all, B, S, H, KVH, splits, scale, stream);
    case 9: return launch_decode<9>(q, kn, vn, kc, vc, pos, start, out, part, counters, pos_all, start_all, B, S, H, KVH, splits, scale, stream);
    case 10: return launch_decode<10>(q, kn, vn, kc, vc, pos, start, out, part, counters, pos_all, start_all, B, S, H, KVH, splits, scale, stream);
    case 11: return launch_decode<11>(q, kn, vn, kc, vc, pos, start, out, part, counters, pos_all, start_all, B, S, H, KVH, splits, scale, stream);
    case 12: return launch_decode<12>(q, kn, vn, kc, vc, pos, start, out, part, counters, pos_all, start_all, B, S, H, KVH, splits, scale, stream);
    case 13: return launch_decode<13>(q, kn, vn, kc, vc, pos, start, out, part, counters, pos_all, start_all, B, S, H, KVH, splits, scale, stream);
    case 14: return launch_decode<14>(q, kn, vn, kc, vc, pos, start, out, part, counters, pos_all, start_all, B, S, H, KVH, splits, scale, stream);
    case 15: return launch_decode<15>(q, kn, vn, kc, vc, pos, start, out, part, counters, pos_all, start_all, B, S, H, KVH, splits, scale, stream);
    default: return launch_decode<16>(q, kn, vn, kc, vc, pos, start, out, part, counters, pos_all, start_all, B, S, H, KVH, splits, scale, stream);
  }
}

// out (B, T, H, 128) = causal softmax(q k^T * scale) v; q (B, T, H, 128),
// k / v (B, T, KVH, 128), bf16, contiguous, 16-byte aligned; T % 64 == 0.
int mq_flash_attn_causal(const void* q, const void* k, const void* v,
                         void* out, int B, int T, int H, int KVH, float scale,
                         void* stream) {
  if (B < 1 || T < 1 || T % 64 || H < 1 || KVH < 1 || H % KVH)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, kmap, vmap;
  const uint32_t box[4] = {64, 1, 128, 1};
  const uint64_t qd[4] = {HD, (uint64_t)H, (uint64_t)T, (uint64_t)B};
  const uint64_t qst[3] = {2 * HD, 2ull * HD * H, 2ull * HD * H * T};
  const uint64_t kd[4] = {HD, (uint64_t)KVH, (uint64_t)T, (uint64_t)B};
  const uint64_t kst[3] = {2 * HD, 2ull * HD * KVH, 2ull * HD * KVH * T};
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  int err = hopper::encode_map(&qmap, bf, 4, q, qd, qst, box);
  if (!err) err = hopper::encode_map(&kmap, bf, 4, k, kd, kst, box);
  if (!err) err = hopper::encode_map(&vmap, bf, 4, v, kd, kst, box);
  if (err) return err;
  static bool attr = false;
  if (!attr) {
    err = (int)cudaFuncSetAttribute(flash_causal_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    FA_SMEM);
    if (err) return err;
    attr = true;
  }
  flash_causal_kernel<<<dim3((T + FA_BM - 1) / FA_BM, H, B), FA_THREADS,
                        FA_SMEM, (cudaStream_t)stream>>>(
      qmap, kmap, vmap, (__nv_bfloat16*)out, T, H, KVH, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
