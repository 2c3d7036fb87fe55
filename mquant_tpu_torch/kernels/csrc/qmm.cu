// Real-integer quantized matmuls for the W4A8 / W8A8 serving path on Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// mquant_tpu_torch/kernels/_build.py.
//
// K1  w4a8_gemv  replaces mquant_tpu/kernels/qmm.py::_qmm_pallas_w4_stacked
//                and the M<=32 branch of _qmm_pallas_w4 (bodies
//                _qmm_w4_kernel_nok / _qmm_w4_kernel). Decode GEMV on
//                split-half packed int4 weights: byte row r of the (K/2, N)
//                matrix holds weight row r in its low nibble and row r+K/2 in
//                its high nibble.
// K2  int8_gemv  replaces qmm.py::_qmm_pallas_gemv (_gemv_kernel): the same
//                GEMV on int8 (K, N) weights (the int8 lm_head).
// K3  int8_gemm  replaces the M>32 branch of qmm.py::_qmm_pallas_w4
//                (_qmm_w4_kernel with its k accumulator) and the XLA s8 dots
//                it stood beside: int8 x int8 -> int32 GEMM on W4 packed or
//                W8 weights with the per-token x per-channel dequant fused.
// K12 w8_bf16_gemv  replaces scripts/gemv_bench.py::w8_bf16_gemv_pallas
//                (pl.pallas_call at :70): y = bf16((x . f32(W)) * w_scale)
//                for bf16 x (M <= 8, K) and int8 W (K, N), f32 sums.
// K13 w4_unpack_gemv  replaces scripts/w4_unpack_tune.py::pallas_gemv with
//                its kernels P0-P3 (:72-107, pl.pallas_call at :115): the
//                packed-W4 GEMV to int32 with the nibbles unpacked three
//                ways (P1 i32 mask / select, P2 int8 shifts, P3 i32 shifts)
//                and P0, x_lo . int8(packed bytes) without an unpack (the
//                probe's bound on the packed stream, not the W4 product). K1's
//                GEMV with the unpack as a template parameter: the loads,
//                the __dp4a loop, the split-K reduction are K1's.
//
// What bounds them on an H100. The GEMVs stream the weight once per token:
// 0.5 B per weight (K1) or 1 B (K2) against ~3.35 TB/s of HBM; the x vector
// is a few KB and stays in L1/L2. The design therefore reads each weight byte
// once with 16-byte loads (a warp covers 512 contiguous bytes of a row),
// unpacks nibbles in registers with word-wide (SWAR) masks, and spends the
// arithmetic on __dp4a (4 int8 MACs per instruction) so the integer pipe
// stays under the byte rate. Narrow-N sites (N = 3584) split K across blocks
// so every SM has a slice of the stream; partial sums meet in an int32
// workspace through atomicAdd, which is exact and order-independent.
// The GEMM at prefill (M = 1024) is bound by int8 tensor-core throughput:
// it runs mma.sync m16n8k32 s8 on 128x128 block tiles staged through shared
// memory. Nibbles are unpacked while the tile is written to shared memory, so
// no int8 copy of a W4 weight ever exists in device memory. wgmma/TMA and
// pipelined stages are later work: this version is simple and exact first.
//
// Epilogue (K1-K3): y = (float(acc) * x_scale[m]) * w_scale[n], then
// rounded to the output type, the order of qmm.py:549/:577.
//
// K12 streams 1 B per weight and does 2 M flops on it: at M = 8 and (3584,
// 19968), 72 MB (21 us at 3.35 TB/s) against 1.1 GFLOP of f32 FMA (17 us at
// the 67 TFLOP/s f32 rate): the two bounds nearly meet, so the int8 -> f32
// convert has to stay cheap (one byte permute and one add per weight: the
// byte, biased to [0, 255], as the low mantissa bits of 2^23). Each block
// owns 128 columns over all of K (156 blocks at N = 19968; no split-K, so
// the f32 sums are deterministic): a thread streams 8 columns of 4 rows at a
// time with 8-byte loads, x is staged in shared memory as f32 in chunks of
// 1024 rows, and the 16 row slices meet through one shuffle and a fixed-order
// sum over the 8 warps in shared memory.
//
// Any K (K2 and K3 on int8 weights; K3 on packed W4 with K even): the RMS
// split stores 18943 int8 rows of `down`, as the JAX package writes them. The
// TAIL instantiations predicate and zero-fill the last row group and k step,
// and read activation rows that are not 4- (16-) byte aligned as aligned
// words shifted into place, so the int32 sums stay exact and no byte outside
// a tensor is read. The host picks them only for such shapes: aligned shapes
// run the plain vector loads (the predicates cost the GEMM ~15% on the card).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// out_kind: 0 = bf16, 1 = f32, 2 = raw int32 accumulator
__device__ __forceinline__ void store_out(void* out, int out_kind, long idx,
                                          int acc, float xs, float wsc) {
  if (out_kind == 2) {
    reinterpret_cast<int*>(out)[idx] = acc;
    return;
  }
  float y = (static_cast<float>(acc) * xs) * wsc;
  if (out_kind == 0) {
    reinterpret_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(y);
  } else {
    reinterpret_cast<float*>(out)[idx] = y;
  }
}

// 4x4 byte transpose: in[i] holds row i (bytes = columns 0..3);
// out[j] holds column j (bytes = rows 0..3).
__device__ __forceinline__ void transpose4x4(const uint32_t in[4],
                                             uint32_t out[4]) {
  uint32_t t0 = __byte_perm(in[0], in[1], 0x5140);
  uint32_t t1 = __byte_perm(in[2], in[3], 0x5140);
  uint32_t t2 = __byte_perm(in[0], in[1], 0x7362);
  uint32_t t3 = __byte_perm(in[2], in[3], 0x7362);
  out[0] = __byte_perm(t0, t1, 0x5410);
  out[1] = __byte_perm(t0, t1, 0x7632);
  out[2] = __byte_perm(t2, t3, 0x5410);
  out[3] = __byte_perm(t2, t3, 0x7632);
}

// Signed nibbles of a packed word as four signed bytes each. With
// u = nibble + 8 in [0, 15] (the xor with 0x88 per byte), (u + 0x78) ^ 0x80
// is u - 8 as an int8 byte, and no byte carries into the next.
__device__ __forceinline__ void unpack_signed(uint32_t w, uint32_t& lo,
                                              uint32_t& hi) {
  uint32_t u = w ^ 0x88888888u;
  lo = ((u & 0x0F0F0F0Fu) + 0x78787878u) ^ 0x80808080u;
  hi = (((u >> 4) & 0x0F0F0F0Fu) + 0x78787878u) ^ 0x80808080u;
}

// Bytes base[c .. c+3] as one word, those at or past `limit` as 0. Reads only
// aligned words that hold a byte of [base + c, base + min(c + 4, limit)), so
// it never leaves the pages of valid bytes.
__device__ __forceinline__ uint32_t load4_tail(const int8_t* base, int c,
                                               int limit) {
  const int n = limit - c;
  if (n <= 0) return 0u;
  const uintptr_t p = reinterpret_cast<uintptr_t>(base + c);
  const uintptr_t a = p & ~uintptr_t(3);
  uint32_t v = *reinterpret_cast<const uint32_t*>(a);
  if (p != a) {
    const uint32_t hi = a + 4 < p + (uintptr_t)min(n, 4)
                            ? *reinterpret_cast<const uint32_t*>(a + 4)
                            : 0u;
    v = __funnelshift_r(v, hi, (uint32_t)(p - a) * 8u);
  }
  return n >= 4 ? v : v & ((1u << (8 * n)) - 1u);
}

// 16 bytes base[c .. c+15], those at or past `limit` as 0 (see load4_tail).
__device__ __forceinline__ uint4 load16_tail(const int8_t* base, int c,
                                             int limit) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(base + c);
  if (c + 16 <= limit && (p & 15) == 0)
    return *reinterpret_cast<const uint4*>(p);
  return make_uint4(load4_tail(base, c, limit), load4_tail(base, c + 4, limit),
                    load4_tail(base, c + 8, limit),
                    load4_tail(base, c + 12, limit));
}

// ---------------------------------------------------------------------------
// K1 / K2: GEMV, M <= 32
// ---------------------------------------------------------------------------

constexpr int GV_TX = 8;     // threads along N, 16 columns each
constexpr int GV_TY = 32;    // K slices inside a block, 4 rows each step
constexpr int GV_BN = GV_TX * 16;

// The weight forms of the GEMV (template parameter WT):
// kW4: w is (R = K/2, N) packed bytes; x row m contributes x[m, r] to the low
// plane and x[m, R + r] to the high one. The dot runs on biased nibbles
// u = w + 8 (two masks per word), and 8 * sum(x) is taken off at the end:
// x.w = x.u - 8 * sum(x), exactly.
// kW8: w is (R = K, N) int8.
// kP1 .. kP3 (K13): kW4's product with signed nibbles unpacked byte by byte
// (unpack_probe); kP0: x[m, :R] . int8(packed bytes), kW8's loop on the
// packed matrix.
enum GemvW { kW8 = 0, kW4 = 1, kP0 = 2, kP1 = 3, kP2 = 4, kP3 = 5 };

// The signed nibbles of the 4 packed bytes of w as the probe's three unpacks
// compute them (w4_unpack_tune.py:52-69), each byte alone; lo / hi receive
// the low / high nibbles as 4 signed bytes.
template <int WT>
__device__ __forceinline__ void unpack_probe(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
  lo = hi = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int l, h;
    if constexpr (WT == kP1) {  // i32 masks, then x >= 8 ? x - 16 : x
      const int b = (int)((w >> (8 * j)) & 0xFFu);
      l = b & 15;
      h = (b >> 4) & 15;
      l = l >= 8 ? l - 16 : l;
      h = h >= 8 ? h - 16 : h;
    } else if constexpr (WT == kP2) {  // int8 arithmetic shifts
      const int8_t b = (int8_t)(w >> (8 * j));
      l = (int8_t)(b << 4) >> 4;
      h = b >> 4;
    } else {  // kP3: int32 shifts of the sign-extended byte
      const int b = (int8_t)(w >> (8 * j));
      l = (int)((uint32_t)b << 28) >> 28;
      h = b >> 4;
    }
    lo |= (uint32_t)(l & 0xFF) << (8 * j);
    hi |= (uint32_t)(h & 0xFF) << (8 * j);
  }
}

template <int WT, int MC, bool TAIL>
__global__ void __launch_bounds__(GV_TX* GV_TY)
    gemv_kernel(const int8_t* __restrict__ x, int M, int K,
                const int8_t* __restrict__ w, int R, int N, int rows_per_split,
                int* __restrict__ acc_out) {
  constexpr bool kHi = WT != kW8 && WT != kP0;  // reads the high plane's x
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int warp = (ty * GV_TX + tx) >> 5, lane = (ty * GV_TX + tx) & 31;
  const int col0 = blockIdx.x * GV_BN + tx * 16;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(R, r_begin + rows_per_split);
  __shared__ int red[GV_TY / 4][MC][GV_BN];

  for (int m0 = 0; m0 < M; m0 += MC) {
    int acc[MC][16];
    int xsum[MC];
#pragma unroll
    for (int mi = 0; mi < MC; ++mi) {
      xsum[mi] = 0;
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[mi][c] = 0;
    }
    if (col0 < N) {
      for (int r = r_begin + ty * 4; r < r_end; r += GV_TY * 4) {
        // TAIL: rows past r_end (the last group of a K that is no multiple
        // of 4) read as zero weights and zero activations
        uint4 v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = !TAIL || r + i < r_end
                     ? *reinterpret_cast<const uint4*>(w + (long)(r + i) * N +
                                                       col0)
                     : make_uint4(0, 0, 0, 0);
        int xlo[MC], xhi[MC];
#pragma unroll
        for (int mi = 0; mi < MC; ++mi) {
          const bool live = m0 + mi < M;
          const int8_t* xr = x + (long)(m0 + mi) * K;
          if (TAIL) {
            xlo[mi] = live ? (int)load4_tail(xr, r, r_end) : 0;
            xhi[mi] = (kHi && live) ? (int)load4_tail(xr + R, r, r_end) : 0;
          } else {
            xlo[mi] = live ? *reinterpret_cast<const int*>(xr + r) : 0;
            xhi[mi] =
                (kHi && live) ? *reinterpret_cast<const int*>(xr + R + r) : 0;
          }
          if (WT == kW4) {
            xsum[mi] = __dp4a(xlo[mi], 0x01010101, xsum[mi]);
            xsum[mi] = __dp4a(xhi[mi], 0x01010101, xsum[mi]);
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          uint32_t rows[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint4 q = v[i];
            rows[i] = c == 0 ? q.x : c == 1 ? q.y : c == 2 ? q.z : q.w;
          }
          if constexpr (kHi) {
            uint32_t lo[4], hi[4], loc[4], hic[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if constexpr (WT == kW4) {
                const uint32_t u = rows[i] ^ 0x88888888u;
                lo[i] = u & 0x0F0F0F0Fu;
                hi[i] = (u >> 4) & 0x0F0F0F0Fu;
              } else {
                unpack_probe<WT>(rows[i], lo[i], hi[i]);
              }
            }
            transpose4x4(lo, loc);
            transpose4x4(hi, hic);
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int mi = 0; mi < MC; ++mi) {
                acc[mi][c * 4 + j] =
                    __dp4a((int)loc[j], xlo[mi], acc[mi][c * 4 + j]);
                acc[mi][c * 4 + j] =
                    __dp4a((int)hic[j], xhi[mi], acc[mi][c * 4 + j]);
              }
          } else {
            uint32_t cols[4];
            transpose4x4(rows, cols);
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int mi = 0; mi < MC; ++mi)
                acc[mi][c * 4 + j] =
                    __dp4a((int)cols[j], xlo[mi], acc[mi][c * 4 + j]);
          }
        }
      }
    }
    // reduce the 32 K slices: 4 per warp through shuffles, 8 warps in smem
#pragma unroll
    for (int mi = 0; mi < MC; ++mi) {
      const int corr = WT == kW4 ? 8 * xsum[mi] : 0;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        int s = acc[mi][c] - corr;
        s += __shfl_down_sync(0xffffffffu, s, 16);
        s += __shfl_down_sync(0xffffffffu, s, 8);
        if (lane < 8) red[warp][mi][lane * 16 + c] = s;
      }
    }
    __syncthreads();
    for (int idx = ty * GV_TX + tx; idx < MC * GV_BN; idx += GV_TX * GV_TY) {
      const int mi = idx / GV_BN, cc = idx % GV_BN;
      const int n = blockIdx.x * GV_BN + cc;
      int s = 0;
#pragma unroll
      for (int wi = 0; wi < GV_TY / 4; ++wi) s += red[wi][mi][cc];
      if (m0 + mi < M && n < N) atomicAdd(acc_out + (long)(m0 + mi) * N + n, s);
    }
    __syncthreads();
  }
}

__global__ void epilogue_kernel(const int* __restrict__ acc, int M, int N,
                                const float* __restrict__ xs,
                                const float* __restrict__ wsc, void* out,
                                int out_kind) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)M * N) return;
  const int m = idx / N, n = idx % N;
  store_out(out, out_kind, idx, acc[idx], xs[m], wsc[n]);
}

// ---------------------------------------------------------------------------
// K3: GEMM, M > 32, mma.sync m16n8k32 s8
// ---------------------------------------------------------------------------

constexpr int GM_BM = 128, GM_BN = 128, GM_BK = 64;
constexpr int GM_LD = GM_BK + 16;  // padded row: conflict-free fragment loads

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x (M, K) int8. W4: w (K/2, N) packed; W8: w (K, N) int8.
// One k step covers 64 activation columns: for W4 the 32 low-plane columns
// [r0, r0+32) and the 32 high-plane columns [K/2 + r0, ...) of packed rows
// [r0, r0+32); for W8 columns [k0, k0+64).
// Shared tiles: As[m][k] row-major, Bs[n][k] (transposed, so one 32-bit load
// gives a B fragment register: four consecutive k of one column).
template <bool W4, bool TAIL>
__global__ void __launch_bounds__(256)
    gemm_kernel(const int8_t* __restrict__ x, int M, int K,
                const int8_t* __restrict__ w, int N,
                const float* __restrict__ xs, const float* __restrict__ wsc,
                void* out, int out_kind) {
  __shared__ __align__(16) int8_t As[GM_BM][GM_LD];
  __shared__ __align__(16) int8_t Bs[GM_BN][GM_LD];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps, 64 x 32 each
  const int bm = blockIdx.y * GM_BM, bn = blockIdx.x * GM_BN;
  const int K2 = K / 2;
  // the last step of a K that is no multiple of 64 (W4: of 64 packed rows)
  // is zero-filled past K (K2 in each nibble plane)
  const int steps = W4 ? (K2 + GM_BK / 2 - 1) / (GM_BK / 2)
                       : (K + GM_BK - 1) / GM_BK;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int s = 0; s < steps; ++s) {
    // A tile: 128 rows x 64 bytes = 512 16-byte pieces, 2 per thread
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int piece = tid + p * 256;
      const int row = piece >> 2, q = piece & 3;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (bm + row < M) {
        const int8_t* xr = x + (long)(bm + row) * K;
        // W4: low plane columns [r0, r0+32), high plane K2 + the same
        const int r0 = s * (GM_BK / 2);
        if (TAIL) {
          if (W4)
            v = q < 2 ? load16_tail(xr, r0 + 16 * q, K2)
                      : load16_tail(xr + K2, r0 + 16 * (q - 2), K2);
          else
            v = load16_tail(xr, s * GM_BK + 16 * q, K);
        } else {
          const int col = W4 ? (q < 2 ? r0 + 16 * q : K2 + r0 + 16 * (q - 2))
                             : s * GM_BK + 16 * q;
          v = *reinterpret_cast<const uint4*>(xr + col);
        }
      }
      *reinterpret_cast<uint4*>(&As[row][16 * q]) = v;
    }
    // B tile, 4x4 byte blocks: a thread reads four 32-bit words (four k rows,
    // four n columns) and writes four transposed words into Bs[n][k..k+3]
    if (W4) {
      const int rq = tid >> 5, cq = tid & 31;  // 8 row groups x 32 col groups
      const int n = bn + 4 * cq;
      uint32_t rows[4] = {0, 0, 0, 0};
      if (n < N) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kr = s * (GM_BK / 2) + 4 * rq + i;
          if (!TAIL || kr < K2)
            rows[i] = *reinterpret_cast<const uint32_t*>(w + (long)kr * N + n);
        }
      }
      uint32_t lo[4], hi[4], loc[4], hic[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) unpack_signed(rows[i], lo[i], hi[i]);
      transpose4x4(lo, loc);
      transpose4x4(hi, hic);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        *reinterpret_cast<uint32_t*>(&Bs[4 * cq + j][4 * rq]) = loc[j];
        *reinterpret_cast<uint32_t*>(&Bs[4 * cq + j][GM_BK / 2 + 4 * rq]) =
            hic[j];
      }
    } else {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int rq = (tid >> 5) + 8 * p, cq = tid & 31;  // 16 x 32 groups
        const int n = bn + 4 * cq;
        uint32_t rows[4] = {0, 0, 0, 0};
        if (n < N) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int kr = s * GM_BK + 4 * rq + i;
            if (!TAIL || kr < K)
              rows[i] =
                  *reinterpret_cast<const uint32_t*>(w + (long)kr * N + n);
          }
        }
        uint32_t cols[4];
        transpose4x4(rows, cols);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<uint32_t*>(&Bs[4 * cq + j][4 * rq]) = cols[j];
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < GM_BK; kk += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm * 64 + i * 16 + g;
        a[i][0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 4 * t]);
        a[i][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 4 * t]);
        a[i][2] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 16 + 4 * t]);
        a[i][3] =
            *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 16 + 4 * t]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn * 32 + j * 8 + g;
        b[j][0] = *reinterpret_cast<const uint32_t*>(&Bs[c][kk + 4 * t]);
        b[j][1] = *reinterpret_cast<const uint32_t*>(&Bs[c][kk + 16 + 4 * t]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  // accumulator fragment: c0,c1 at (g, 2t..2t+1), c2,c3 at (g+8, 2t..2t+1)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = bm + wm * 64 + i * 16 + g + (e >= 2 ? 8 : 0);
        const int n = bn + wn * 32 + j * 8 + 2 * t + (e & 1);
        if (m < M && n < N)
          store_out(out, out_kind, (long)m * N + n, acc[i][j][e], xs[m],
                    wsc[n]);
      }
}

template <int WT, int MC, bool TAIL>
void gemv(dim3 grid, dim3 block, cudaStream_t stream, const void* x, int M,
          int K, const void* w, int R, int N, int rps, void* acc) {
  gemv_kernel<WT, MC, TAIL><<<grid, block, 0, stream>>>(
      (const int8_t*)x, M, K, (const int8_t*)w, R, N, rps, (int*)acc);
}

template <int WT>
int launch_gemv(const void* x, const void* w, const void* xs, const void* wsc,
                void* acc, void* out, int M, int K, int N, int splits,
                int out_kind, cudaStream_t stream) {
  const int R = WT == kW8 ? K : K / 2;
  // the predicated K tail only where rows or x words are not 4-aligned
  const bool tail = R % 4 || K % 4 || reinterpret_cast<uintptr_t>(x) % 4;
  // rows per split: a multiple of 4 that covers R in `splits` pieces
  int rps = (R + splits - 1) / splits;
  rps = (rps + 3) / 4 * 4;
  const int grid_y = (R + rps - 1) / rps;
  cudaMemsetAsync(acc, 0, sizeof(int) * (size_t)M * N, stream);
  dim3 grid((N + GV_BN - 1) / GV_BN, grid_y), block(GV_TX, GV_TY);
  if (M == 1 && tail)
    gemv<WT, 1, true>(grid, block, stream, x, M, K, w, R, N, rps, acc);
  else if (M == 1)
    gemv<WT, 1, false>(grid, block, stream, x, M, K, w, R, N, rps, acc);
  else if (tail)
    gemv<WT, 4, true>(grid, block, stream, x, M, K, w, R, N, rps, acc);
  else
    gemv<WT, 4, false>(grid, block, stream, x, M, K, w, R, N, rps, acc);
  if (out_kind != 2) {
    const long total = (long)M * N;
    epilogue_kernel<<<(total + 255) / 256, 256, 0, stream>>>(
        (const int*)acc, M, N, (const float*)xs, (const float*)wsc, out,
        out_kind);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K12: int8 weights -> f32, bf16 x, f32 sums, M <= 8
// ---------------------------------------------------------------------------

constexpr int W8_TX = 16;          // threads along N, 8 columns each
constexpr int W8_TY = 16;          // row slices, 4 rows a step
constexpr int W8_BN = W8_TX * 8;   // 128 columns a block
constexpr int W8_KC = 1024;        // x rows staged in shared memory at a time

// four int8 bytes of w as exact floats: the byte + 128 becomes the low
// mantissa bits of 2^23, and 2^23 + 128 is subtracted
__device__ __forceinline__ void s8x4_to_f32(uint32_t w, float f[4]) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
}

// x (M, K) bf16, w (K, N) int8 row-major, ws (N,) f32 -> out (M, N) bf16;
// MC >= M rows of x, the rest zero
template <int MC>
__global__ void __launch_bounds__(W8_TX* W8_TY, 2)
    w8_bf16_gemv_kernel(const __nv_bfloat16* __restrict__ x, int M, int K,
                        const int8_t* __restrict__ w, int N,
                        const float* __restrict__ ws,
                        __nv_bfloat16* __restrict__ out) {
  // x chunk (W8_KC, MC) f32, then the warps' partial sums (8, MC, W8_BN)
  constexpr int kXs = W8_KC * MC, kRed = (W8_TX * W8_TY / 32) * MC * W8_BN;
  __shared__ __align__(16) float sm[kXs > kRed ? kXs : kRed];
  const int tid = threadIdx.x, tx = tid % W8_TX, ty = tid / W8_TX;
  const int warp = tid >> 5, lane = tid & 31;
  const int col0 = blockIdx.x * W8_BN + tx * 8;
  const bool live = col0 < N;  // N % 8 == 0: all 8 columns or none

  float acc[MC][8];
#pragma unroll
  for (int m = 0; m < MC; ++m)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[m][c] = 0.f;

  for (int kb = 0; kb < K; kb += W8_KC) {
    const int rows = min(W8_KC, K - kb);
    __syncthreads();  // the previous chunk has been read
    for (int i = tid; i < W8_KC * MC; i += W8_TX * W8_TY) {
      const int m = i / W8_KC, k = i % W8_KC;  // coalesced along k
      sm[k * MC + m] = m < M && k < rows
                           ? __bfloat162float(x[(long)m * K + kb + k])
                           : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int r = ty * 4; r < rows; r += W8_TY * 4) {
      uint2 wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)  // rows past K read as zero weights
        wv[i] = r + i < rows ? __ldg(reinterpret_cast<const uint2*>(
                                   w + (long)(kb + r + i) * N + col0))
                             : make_uint2(0u, 0u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float wf[8];
        s8x4_to_f32(wv[i].x, wf);
        s8x4_to_f32(wv[i].y, wf + 4);
        const float* xk = sm + (r + i) * MC;
#pragma unroll
        for (int m = 0; m < MC; ++m) {
          const float xv = xk[m];
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[m][c] = fmaf(xv, wf[c], acc[m][c]);
        }
      }
    }
  }

  // the 16 row slices: two per warp by one shuffle, then the 8 warps in a
  // fixed order (every output's sum is the same on every run)
  __syncthreads();  // the last x chunk has been read
#pragma unroll
  for (int m = 0; m < MC; ++m)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float s = acc[m][c] + __shfl_xor_sync(0xffffffffu, acc[m][c], 16);
      if (lane < 16) sm[(warp * MC + m) * W8_BN + tx * 8 + c] = s;
    }
  __syncthreads();
  for (int i = tid; i < MC * W8_BN; i += W8_TX * W8_TY) {
    const int m = i / W8_BN, c = i % W8_BN;
    const int n = blockIdx.x * W8_BN + c;
    if (m >= M || n >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < W8_TX * W8_TY / 32; ++wi)
      s += sm[(wi * MC + m) * W8_BN + c];
    out[(long)m * N + n] = __float2bfloat16_rn(s * __ldg(ws + n));
  }
}

template <int MC>
int launch_w8_bf16(const void* x, const void* w, const void* ws, void* out,
                   int M, int K, int N, cudaStream_t stream) {
  w8_bf16_gemv_kernel<MC>
      <<<(N + W8_BN - 1) / W8_BN, W8_TX * W8_TY, 0, stream>>>(
          (const __nv_bfloat16*)x, M, K, (const int8_t*)w, N,
          (const float*)ws, (__nv_bfloat16*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y (M, N) = epilogue(x (M, K) . W4 packed (K/2, N)). acc: int32 (M, N)
// workspace; with out_kind 2 it is the result and `out` is unused.
int mq_w4a8_gemv(const void* x, const void* w, const void* xs, const void* wsc,
                 void* acc, void* out, int M, int K, int N, int splits,
                 int out_kind, void* stream) {
  return launch_gemv<kW4>(x, w, xs, wsc, acc, out, M, K, N, splits, out_kind,
                           (cudaStream_t)stream);
}

int mq_int8_gemv(const void* x, const void* w, const void* xs, const void* wsc,
                 void* acc, void* out, int M, int K, int N, int splits,
                 int out_kind, void* stream) {
  return launch_gemv<kW8>(x, w, xs, wsc, acc, out, M, K, N, splits,
                          out_kind, (cudaStream_t)stream);
}

// acc (M, N) int32 = x (M, K) . W4 packed (K/2, N) by the unpack `variant`
// 1 .. 3 (P1 .. P3), or x[:, :K/2] . int8(packed) for variant 0 (P0).
// M <= 8, K even.
int mq_w4_unpack_gemv(const void* x, const void* w, void* acc, int M, int K,
                      int N, int splits, int variant, void* stream) {
  if (M < 1 || M > 8 || K < 2 || K % 2 || N < 1 || splits < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
    case 0:
      return launch_gemv<kP0>(x, w, nullptr, nullptr, acc, nullptr, M, K, N,
                              splits, 2, st);
    case 1:
      return launch_gemv<kP1>(x, w, nullptr, nullptr, acc, nullptr, M, K, N,
                              splits, 2, st);
    case 2:
      return launch_gemv<kP2>(x, w, nullptr, nullptr, acc, nullptr, M, K, N,
                              splits, 2, st);
    case 3:
      return launch_gemv<kP3>(x, w, nullptr, nullptr, acc, nullptr, M, K, N,
                              splits, 2, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// out (M, N) bf16 = bf16((x . f32(W)) * ws) for bf16 x (M, K), int8 W (K, N)
// row-major (rows 8-byte aligned), ws (N,) f32; f32 sums. M <= 8, N % 8 == 0.
int mq_w8_bf16_gemv(const void* x, const void* w, const void* ws, void* out,
                    int M, int K, int N, void* stream) {
  if (M < 1 || M > 8 || K < 1 || N < 8 || N % 8)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (M == 1) return launch_w8_bf16<1>(x, w, ws, out, M, K, N, st);
  if (M == 2) return launch_w8_bf16<2>(x, w, ws, out, M, K, N, st);
  if (M <= 4) return launch_w8_bf16<4>(x, w, ws, out, M, K, N, st);
  return launch_w8_bf16<8>(x, w, ws, out, M, K, N, st);
}

// y (M, N) = epilogue(x (M, K) . W), W4 packed (K/2, N) if w4 else int8 (K, N).
int mq_int8_gemm(const void* x, const void* w, const void* xs, const void* wsc,
                 void* out, int M, int K, int N, int w4, int out_kind,
                 void* stream) {
  dim3 grid((N + GM_BN - 1) / GM_BN, (M + GM_BM - 1) / GM_BM), block(256);
  cudaStream_t st = (cudaStream_t)stream;
  // the predicated K tail only where a k step is partial or an x row is not
  // 16-byte aligned
  const bool tail = (w4 ? (K / 2) % (GM_BK / 2) : K % GM_BK) ||
                    reinterpret_cast<uintptr_t>(x) % 16;
  const int8_t* xp = (const int8_t*)x;
  const int8_t* wp = (const int8_t*)w;
  const float *xsp = (const float*)xs, *wsp = (const float*)wsc;
  if (w4 && tail)
    gemm_kernel<true, true><<<grid, block, 0, st>>>(xp, M, K, wp, N, xsp, wsp,
                                                    out, out_kind);
  else if (w4)
    gemm_kernel<true, false><<<grid, block, 0, st>>>(xp, M, K, wp, N, xsp,
                                                     wsp, out, out_kind);
  else if (tail)
    gemm_kernel<false, true><<<grid, block, 0, st>>>(xp, M, K, wp, N, xsp,
                                                     wsp, out, out_kind);
  else
    gemm_kernel<false, false><<<grid, block, 0, st>>>(xp, M, K, wp, N, xsp,
                                                      wsp, out, out_kind);
  return (int)cudaGetLastError();
}

}  // extern "C"
