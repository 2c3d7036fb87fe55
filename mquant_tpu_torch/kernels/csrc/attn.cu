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
//     grid (splits, KVH, B). A block holds the G query rows of its KV head
//     in registers, streams its slice of K and V with 16-byte loads (a
//     half-warp per column row of 256 B) and keeps an f32 running max, sum
//     and P.V accumulator (online softmax); its 8 half-warps meet in shared
//     memory and the block writes one (m, l, acc) partial per query row.
//     A second small kernel, one block per (b, kv head, query row), merges
//     the partials with the new-token term (JAX _kernel's m / denom / out
//     algebra), and the row-0 block writes k_new / v_new into row pos.
//     Attention never reads row pos from the cache (col < pos), and the
//     merge runs after the split kernel on the same stream, so the write
//     races nothing.
//     Columns outside [start, pos) are never read (stale KV of a reused
//     slot or a left pad cannot leak in).
//     Numerics: the JAX kernel normalizes the probabilities and rounds them
//     to bf16 before P.V; here P.V runs on f32 unnormalized probabilities
//     and is divided by the sum at the end, so outputs agree with the plain
//     version to bf16 rounding, not bit for bit. The written cache rows are
//     copies, bit-equal.
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

__device__ __forceinline__ void bf16x8_to_f32(const uint4& u, float f[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// ---------------------------------------------------------------------------
// K4: decode attention, split-S
// ---------------------------------------------------------------------------

constexpr int DEC_THREADS = 128;              // 4 warps
constexpr int DEC_HALVES = DEC_THREADS / 16;  // half-warps, one column each
constexpr int MAXG = 8;                       // query rows per KV head
constexpr float NEG_BIG = -1e30f;

// part: (B, KVH, splits, G, 2 + HD) f32 = (m, l, acc[HD]) per query row.
__global__ void __launch_bounds__(DEC_THREADS)
    decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ kc,
                        const __nv_bfloat16* __restrict__ vc,
                        const int* __restrict__ pos,
                        const int* __restrict__ start, int pos_all,
                        int start_all, float* __restrict__ part, int S, int H,
                        int KVH, int G, float scale) {
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int tid = threadIdx.x, half = tid >> 4, hl = tid & 15;
  const int warp = tid >> 5, wh = half & 1;
  const int d0 = hl * 8;

  const int p = min(pos ? pos[b] : pos_all, S);
  const int st = max(start ? start[b] : start_all, 0);
  const int n = max(p - st, 0);
  const int chunk = (n + splits - 1) / splits;
  const int lo = st + split * chunk;
  const int hi = min(p, lo + chunk);

  float qf[MAXG][8];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          q + ((long)b * H + kh * G + g) * HD + d0);
      bf16x8_to_f32(u, qf[g]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) qf[g][i] = 0.f;
    }
  }
  float m[MAXG], l[MAXG], acc[MAXG][8];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = NEG_BIG;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
  }

  const long row = (long)KVH * HD;
  const __nv_bfloat16* kb = kc + (long)b * S * row + kh * HD + d0;
  const __nv_bfloat16* vb = vc + (long)b * S * row + kh * HD + d0;
  // both half-warps of a warp step together (the shuffles need the whole
  // warp); a half-warp past the end computes on zeros and discards them
  for (int c0 = lo + warp * 2; c0 < hi; c0 += DEC_HALVES) {
    const int c = c0 + wh;
    const bool live = c < hi;
    float kf[8], vf[8];
    if (live) {
      bf16x8_to_f32(*reinterpret_cast<const uint4*>(kb + c * row), kf);
      bf16x8_to_f32(*reinterpret_cast<const uint4*>(vb + c * row), vf);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) kf[i] = vf[i] = 0.f;
    }
    float s[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      float t = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) t = fmaf(qf[g][i], kf[i], t);
      t += __shfl_xor_sync(FULL, t, 8);
      t += __shfl_xor_sync(FULL, t, 4);
      t += __shfl_xor_sync(FULL, t, 2);
      t += __shfl_xor_sync(FULL, t, 1);
      s[g] = t * scale;
    }
    if (live) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          const float mn = fmaxf(m[g], s[g]);
          const float a = expf(m[g] - mn);
          const float pe = expf(s[g] - mn);
          l[g] = l[g] * a + pe;
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[g][i] = fmaf(pe, vf[i], acc[g][i] * a);
          m[g] = mn;
        }
      }
    }
  }

  // the 8 half-warps meet in shared memory; thread tid owns dim tid
  __shared__ float sm_m[DEC_HALVES][MAXG], sm_l[DEC_HALVES][MAXG];
  __shared__ float sm_acc[DEC_HALVES][MAXG][HD];
  if (hl == 0) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      sm_m[half][g] = m[g];
      sm_l[half][g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int i = 0; i < 8; ++i) sm_acc[half][g][d0 + i] = acc[g][i];
  __syncthreads();
  for (int g = 0; g < G; ++g) {
    float M = NEG_BIG;
#pragma unroll
    for (int h = 0; h < DEC_HALVES; ++h) M = fmaxf(M, sm_m[h][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int h = 0; h < DEC_HALVES; ++h) {
      const float w = expf(sm_m[h][g] - M);
      L = fmaf(w, sm_l[h][g], L);
      A = fmaf(w, sm_acc[h][g][tid], A);
    }
    float* dst = part + ((((long)b * KVH + kh) * splits + split) * G + g) *
                            (2 + HD);
    if (tid == 0) {
      dst[0] = M;
      dst[1] = L;
    }
    dst[2 + tid] = A;
  }
}

constexpr int MAX_SPLITS = 256;

// Sum (or max) of one value per thread over the 128-thread block.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(FULL, v, o);
    v = MAX ? fmaxf(v, u) : v + u;
  }
  __syncthreads();  // red is free again
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < HD / 32; ++w) v = MAX ? fmaxf(v, red[w]) : v + red[w];
  return v;
}

// One block per (query row g, kv head, b); thread d owns output dim d. The
// split weights exp(m_s - M) are computed once, in parallel over the splits,
// so the accumulation over splits is independent loads.
__global__ void __launch_bounds__(HD)
    decode_merge_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ kn,
                        const __nv_bfloat16* __restrict__ vn,
                        __nv_bfloat16* __restrict__ kc,
                        __nv_bfloat16* __restrict__ vc,
                        const int* __restrict__ pos, int pos_all,
                        const float* __restrict__ part,
                        __nv_bfloat16* __restrict__ out, int S, int H, int KVH,
                        int G, int splits, float scale) {
  const int g = blockIdx.x, kh = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  __shared__ float red[HD / 32];
  __shared__ float wsm[MAX_SPLITS];
  const long nrow = ((long)b * KVH + kh) * HD + d;
  const __nv_bfloat16 knb = kn[nrow], vnb = vn[nrow];
  const long qrow = ((long)b * H + kh * G + g) * HD;
  const float snew =
      block_reduce<false>(__bfloat162float(q[qrow + d]) *
                              __bfloat162float(knb), red) * scale;

  const long sstep = (long)G * (2 + HD);
  const float* src = part + (((long)b * KVH + kh) * splits * G + g) * (2 + HD);
  float M = snew;
  for (int s = d; s < splits; s += HD) M = fmaxf(M, src[s * sstep]);
  M = block_reduce<true>(M, red);
  float L = 0.f;
  for (int s = d; s < splits; s += HD) {
    const float w = expf(src[s * sstep] - M);
    wsm[s] = w;
    L = fmaf(w, src[s * sstep + 1], L);
  }
  const float pn = expf(snew - M);
  L = block_reduce<false>(L, red) + pn;  // its barriers publish wsm too
  float A = pn * __bfloat162float(vnb);
#pragma unroll 4
  for (int s = 0; s < splits; ++s) A = fmaf(wsm[s], src[s * sstep + 2 + d], A);
  out[qrow + d] = __float2bfloat16_rn(A / L);

  const int p = pos ? pos[b] : pos_all;
  if (g == 0 && p >= 0 && p < S) {
    const long idx = (((long)b * S + p) * KVH + kh) * HD + d;
    kc[idx] = knb;
    vc[idx] = vnb;
  }
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

// d (64 x 128 f32) (+)= A (64 x 16, descriptor) . B (16 x 128, descriptor)
__device__ __forceinline__ void wgmma_bf16_ss(float d[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128 f32) += A (64 x 16, registers) . B (16 x 128, descriptor,
// MN-major)
__device__ __forceinline__ void wgmma_bf16_rs_tb(float d[64],
                                                 const uint32_t a[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

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
    wgmma_bf16_ss(s, hopper::desc_sw128(qw + c * FA_HALF + off, 16, 1024),
                  hopper::desc_sw128(kt + c * FA_HALF + off, 16, 1024),
                  kk > 0);
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
      wgmma_bf16_rs_tb(o, pa[kk],
                       hopper::desc_sw128(vt + kk * 16 * 128, FA_HALF, 1024));
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

}  // namespace

extern "C" {

// out (B, H, 128) = decode attention of q (B, H, 128) over the cache columns
// [start[b], pos[b]) and the new row; kc / vc (B, S, KVH, 128) get row pos[b]
// = kn / vn (B, KVH, 128). pos / start: (B,) int32 on the device, or null
// for one value of every row, passed by value in pos_all / start_all (a
// decode step's host position: no copy or fill kernel per layer). part: f32
// scratch of B * KVH * splits * G * 130; splits <= 256.
int mq_attn_decode(const void* q, const void* kn, const void* vn, void* kc,
                   void* vc, const void* pos, const void* start, void* out,
                   void* part, int pos_all, int start_all, int B, int S, int H,
                   int KVH, int splits, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int G = H / KVH;
  decode_split_kernel<<<dim3(splits, KVH, B), DEC_THREADS, 0, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)kc,
      (const __nv_bfloat16*)vc, (const int*)pos, (const int*)start, pos_all,
      start_all, (float*)part, S, H, KVH, G, scale);
  decode_merge_kernel<<<dim3(G, KVH, B), HD, 0, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)kn,
      (const __nv_bfloat16*)vn, (__nv_bfloat16*)kc, (__nv_bfloat16*)vc,
      (const int*)pos, pos_all, (const float*)part, (__nv_bfloat16*)out, S, H,
      KVH, G, splits, scale);
  return (int)cudaGetLastError();
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
