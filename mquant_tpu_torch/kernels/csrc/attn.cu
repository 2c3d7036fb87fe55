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
//     design keeps the (T, T) scores out of device memory: grid (T/64, H, B),
//     a block of 4 warps owns 64 query rows (16 per warp, held as mma A
//     fragments in registers) and walks the K/V tiles of 64 rows up to the
//     diagonal (tiles above it are never loaded). Q.K^T and P.V run on
//     mma.sync.m16n8k16 bf16 with f32 accumulation; the softmax is online in
//     f32 (running row max and sum, the accumulator rescaled per tile) and
//     P is rounded to bf16 for the second product. The causal mask is
//     applied inside the diagonal tile. GQA is native: query head h reads KV
//     head h / (H / KVH), and K/V are never repeated in memory. V fragments
//     come from shared memory through ldmatrix.trans. wgmma, TMA and a
//     producer / consumer pipeline are later work: the tiles are loaded
//     synchronously, one at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
// K5: causal flash attention, mma.sync m16n8k16 bf16
// ---------------------------------------------------------------------------

constexpr int FA_BM = 64, FA_BN = 64, FA_THREADS = 128;
constexpr int FA_LD = HD + 8;  // padded row (272 B): conflict-free fragments

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices, transposed: lanes 8i..8i+7 give the row addresses
// of matrix i; r[i] receives matrix i's (2t, 2t+1) x g elements
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__global__ void __launch_bounds__(FA_THREADS)
    flash_causal_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ out, int T, int H, int KVH,
                        float scale) {
  __shared__ __align__(16) __nv_bfloat16 Ks[FA_BN][FA_LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[FA_BN][FA_LD];
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest rows start first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KVH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = qt * FA_BM + warp * 16 + g;  // this thread's rows r0, r0 + 8
  const long qs = (long)H * HD, ks = (long)KVH * HD;  // token strides
  const __nv_bfloat16* qb = q + (long)b * T * qs + (long)h * HD;
  const __nv_bfloat16* kb = k + (long)b * T * ks + (long)kh * HD;
  const __nv_bfloat16* vb = v + (long)b * T * ks + (long)kh * HD;

  // A fragments of the warp's 16 query rows over the 8 k-steps of HD
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const __nv_bfloat16* p0 = qb + (long)r0 * qs + kk * 16 + 2 * t;
    const __nv_bfloat16* p1 = p0 + 8 * qs;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(p0);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(p1);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
  }

  float o[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j <= qt; ++j) {  // FA_BM == FA_BN: tile qt is the diagonal
    const int k0 = j * FA_BN;
    __syncthreads();  // the previous tile's fragments are read
    for (int p = tid; p < FA_BN * HD / 8; p += FA_THREADS) {
      const int rr = p >> 4, cc = (p & 15) * 8;
      *reinterpret_cast<uint4*>(&Ks[rr][cc]) =
          *reinterpret_cast<const uint4*>(kb + (long)(k0 + rr) * ks + cc);
      *reinterpret_cast<uint4*>(&Vs[rr][cc]) =
          *reinterpret_cast<const uint4*>(vb + (long)(k0 + rr) * ks + cc);
    }
    __syncthreads();

    float s[FA_BN / 8][4];
#pragma unroll
    for (int nb = 0; nb < FA_BN / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const __nv_bfloat16* kp = &Ks[nb * 8 + g][kk * 16 + 2 * t];
        mma_bf16(s[nb], qa[kk], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }
    const bool diag = j == qt;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nb = 0; nb < FA_BN / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[nb][e] * scale;
        if (diag) {
          const int col = k0 + nb * 8 + 2 * t + (e & 1);
          const int row = r0 + (e >= 2 ? 8 : 0);
          if (col > row) val = -INFINITY;
        }
        s[nb][e] = val;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nb][0], s[nb][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nb][2], s[nb][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
    // tile 0 holds column 0 <= every row, so mx0 / mx1 are finite here and
    // the first rescale is exp(-inf) = 0
    const float a0 = __expf(m0 - mx0), a1 = __expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nb = 0; nb < FA_BN / 8; ++nb) {
      s[nb][0] = __expf(s[nb][0] - m0);
      s[nb][1] = __expf(s[nb][1] - m0);
      s[nb][2] = __expf(s[nb][2] - m1);
      s[nb][3] = __expf(s[nb][3] - m1);
      rs0 += s[nb][0] + s[nb][1];
      rs1 += s[nb][2] + s[nb][3];
    }
    rs0 += __shfl_xor_sync(FULL, rs0, 1);
    rs0 += __shfl_xor_sync(FULL, rs0, 2);
    rs1 += __shfl_xor_sync(FULL, rs1, 1);
    rs1 += __shfl_xor_sync(FULL, rs1, 2);
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      o[i][0] *= a0;
      o[i][1] *= a0;
      o[i][2] *= a1;
      o[i][3] *= a1;
    }

    // O += P V: the S accumulator fragments are P's A fragments
#pragma unroll
    for (int kk = 0; kk < FA_BN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int vr = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, &Vs[vr][dp * 16 + (lane >> 4) * 8]);
        mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }

  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  __nv_bfloat16* ob = out + (long)b * T * qs + (long)h * HD;
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    const int d = i * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(ob + (long)r0 * qs + d) =
        pack_bf16(o[i][0] * inv0, o[i][1] * inv0);
    *reinterpret_cast<uint32_t*>(ob + (long)(r0 + 8) * qs + d) =
        pack_bf16(o[i][2] * inv1, o[i][3] * inv1);
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
// k / v (B, T, KVH, 128), T % 64 == 0.
int mq_flash_attn_causal(const void* q, const void* k, const void* v,
                         void* out, int B, int T, int H, int KVH, float scale,
                         void* stream) {
  flash_causal_kernel<<<dim3(T / FA_BM, H, B), FA_THREADS, 0,
                        (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, T, H, KVH, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
