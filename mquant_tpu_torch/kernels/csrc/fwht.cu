// Hadamard and norm kernels of the prefill path, on Hopper (sm_90a). Plain
// C interface, loaded with ctypes by mquant_tpu_torch/kernels/_build.py.
//
// K6  fused_swiglu_had_quant  replaces
//     mquant_tpu/kernels/fwht.py::fused_swiglu_had_quant (_tail_kernel, its
//     pl.pallas_call at :320). For each token row of n = K * 128 (Qwen2-VL-7B:
//     n = 18944, K = 148, the Paley factor of the Hadamard order):
//       x  = bf16(silu(g) * u)                  in f32, then rounded
//       Y1 = bf16(X . B)     X = x viewed (K, 128), B = H_128 / sqrt(128)
//       Y  = A . Y1          A = hadK (K, K), orthonormal
//       q  = clip(round(Y * (1 / scale)), qmin, qmax)  at position k*128 + j
//     Both products take bf16 operands with f32 sums, as the TPU kernel's
//     dots (preferred_element_type=f32); rounding is half to even. The
//     code range [qmin, qmax] (default [-128, 127]) is a runtime argument of
//     every quantizing kernel here, as in the TPU kernels.
//     g and u are bf16 or f32 rows (the TPU kernel casts both to f32 first,
//     so an f32 g enters silu unrounded).
// K7  had_quant  replaces fwht.py::had_quant (_had_quant_kernel, :187): the
//     same pipeline on one input x instead of silu(g) * u, x bf16 or f32
//     rounded to bf16 (the tail kernel instantiated with kIn = kInX).
// K8  rms_norm_quant  replaces fwht.py::rms_norm_quant (_rms_quant_kernel,
//     :246): q = clip(round(x * rsqrt(mean(x^2) + eps) * w * (1 / scale))).
// K14 dequant_swiglu_had_quant  replaces scripts/mlp_variants.py::
//     mlp_int8_fused_epilogue (its kernel `kern`, pl.pallas_call at :180):
//     the int8 MLP's epilogue on the int32 gate and up accumulators,
//       x = bf16((gf * sigmoid(gf)) * uf),  gf = f32(g) * gs[j],
//                                           uf = f32(u) * us[j]
//     (gs, us: per-channel f32 scales already times the activation scale),
//     then K6's two products and quantize (the probe clips to [-127, 127]).
//     The tail kernel instantiated with kIn = kInDequant: only step 1
//     differs. It reads 8 bytes of g, u per element and 8 bytes of the two
//     scale vectors (the scales from L2: every block reads all of them).
// K9  fwht  replaces fwht.py::fwht_pallas (_fwht_kernel, :122): y = (A (x)
//     H_128) x in f32 throughout, bf16 or f32 in and out (fwht_tc_kernel;
//     fwht_kernel for the one hadK that is not c times a sign matrix).
//
// What bounds the tail on an H100. Per token it reads g and u (4 bytes per
// element) and writes one int8 code per element: 97 MB at T = 1024, 29 us at
// 3.35 TB/s. The two products are 2 * n * (K + 128) = 10.5 MFLOP per token,
// 10.7 GFLOP at T = 1024 (11 us at the dense bf16 peak): the kernel is bound
// by bytes as long as the products stay on the tensor cores, and device
// memory sees g, u and the codes once: a token's row stays in shared memory
// through all three steps, and both products run on wgmma bf16 -> f32. The
// hadK axis is zero-padded from K to 160 (ten k16 steps): exact, since the
// pad rows of X and the pad rows and columns of A are zero, and the pad
// rows of Y are never written. The factor matrices come from the wrapper (A
// padded, B transposed), the very matrices of the plain version.
// The design is persistent, with the factors resident: one block of three
// warpgroups per SM walks over tokens b, b + grid, ... Step 2 is wgmma
// m64n128k16 with X (192 x 128: rows past K zero, 64 a warpgroup) and
// H_128 / sqrt(128) both K-major in shared memory (128-byte swizzled rows,
// hopper.cuh); H is copied there once. Step 3 is wgmma m64n128k16 with
// hadK's A fragments in registers (each thread's two rows over the ten k16
// steps: 40 registers, loaded once) and Y1 read MN-major through the
// descriptor's transpose bit. So no factor byte is read per token, and the
// operands' shared-memory traffic is ~0.26 MB a token (a warp-level
// mma.sync design re-reads A and X once per warp: ~0.82 MB). The g / u rows
// come through a ring of slots fed by cp.async.bulk: one thread copies a
// token's g and u rows (or chunks of cs 128-wide sub-rows of them, where a
// whole row does not fit: int32 or f32 pairs) straight from device memory
// into a slot and an mbarrier reports the bytes; a slot is refilled with the
// next chunk of the sequence as soon as every thread has read it, so the
// next token's row loads while this token's steps 2-4 run. The codes are
// staged in shared memory over X (swizzled 128-byte rows) and leave as
// 16-byte stores. Three barriers a token, plus one per ring chunk.
// had_quant reads 2 bytes per element instead of 4 (58 MB, 17 us);
// dequant_swiglu_had_quant 8 (int32 g and u: 175 MB with the codes, 52 us;
// it reads the two scale vectors from L2 per token).
//
// rms_norm_quant moves 3 bytes per element (11 MB at (1024, 3584), 3.3 us)
// and does a few flops per byte: bound by bytes. One block per row: 16-byte
// loads, the f32 sum of squares by warp shuffles and one shared-memory pass,
// then the row again (from L1) into 16-byte int8 stores.
//
// fwht must hold f32 to ~1e-6, and TF32 keeps 10 mantissa bits. But every
// hadK the Hadamard constructions give (Paley, Sylvester, their products) is
// one f32 scalar c times a +-1 sign matrix, which bf16 holds exactly; and an
// f32 value y is exactly hi + mid + lo in three bf16 terms. So the hadK
// product runs on wgmma with exact products and f32 sums: Y = c (sgn . lo +
// sgn . mid + sgn . hi). With the products on the tensor cores (3 x 5.7
// GFLOP padded to 192 x 160 at (1024, 18944): ~24 us at the dense bf16 peak)
// the bytes bound it: 77.6 MB of bf16 in and out, 23 us at 3.35 TB/s (f32:
// 155 MB, 46 us). fwht_tc_kernel is the tail kernel's persistent schedule:
// one block of three warpgroups per SM over the tokens, x rows through a
// cp.async.bulk ring of whole rows (38 KB bf16, 76 KB f32 at K = 148); per
// token each warp transforms whole 128-wide sub-rows in registers (H_128 as
// a butterfly in f32, 8 n flops: 4 values a lane, two stages inside the
// lane, five by shuffles), splits Y1 into the three bf16 planes in shared
// memory (the tail's Y1 layout: 128-byte swizzled, read MN-major), and each
// warpgroup chains the three planes' wgmma m64n128k16 against the sign
// fragments held in registers (40 a thread, loaded once: no factor byte is
// read per token). c times the f32 sums leaves f32 straight from the
// registers, or rounded once to bf16 through the warpgroup's own staging
// rows as 16-byte stores. At K = 1 the butterfly is the result. Two block
// barriers a token: the planes written, the planes read; the next token's
// step 1 runs under this token's stores. The butterfly and the products
// do not overlap: a slab-by-slab pipeline of the two on the same warps,
// and one butterfly warpgroup beside three product warpgroups, both lost
// (PERF.md, Findings).
// The seeded random orthogonal block of K = 156 (n = 19968: no Hadamard
// construction of that order) is no scaled sign matrix: fwht_kernel takes
// its product by f32 FMA, one block per row (the dense factor read through
// L1 per row).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int TL_M = 128;           // the power-of-two factor: row tile width
constexpr int TL_KP = 160;          // hadK, zero-padded to ten k16 steps
constexpr int TL_MT = TL_KP / 16;   // k16 steps of the hadK product
constexpr int TL_WGS = 3;           // warpgroups: 64 rows each of 192
constexpr int TL_ROWS = 64 * TL_WGS;
constexpr int TL_THREADS = 128 * TL_WGS;
// shared-memory tiles, 128-byte swizzled rows (hopper.cuh): X and Y1 as two
// boxes of 64 columns over 192 rows, H_128 / sqrt(128) as two boxes of 64
// columns over its 128 rows
constexpr int TL_BOX = TL_ROWS * 128;       // 24,576
constexpr int TL_X_BYTES = 2 * TL_BOX;      // 49,152
constexpr int TL_H_BOX = TL_M * 128;        // 16,384
constexpr int TL_FIXED = 2 * TL_X_BYTES + 2 * TL_H_BOX;  // X, Y1, H
constexpr int TL_SMEM = 232448;     // a block's shared memory on sm_90
constexpr int TL_MAX_SLOTS = 8;
// what is left for the ring of g / u slots (1024 bytes go to alignment)
constexpr int TL_STAGE_MAX =
    TL_SMEM - TL_FIXED - 1024 - 8 * TL_MAX_SLOTS;  // 100,288

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ldg32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ int quant8(float y, float inv, int qmin,
                                      int qmax) {
  return max(qmin, min(qmax, __float2int_rn(y * inv)));
}

// byte offset of 16-byte chunk `chunk` (0-7) of row r in a tile of
// 128-byte swizzled rows
__device__ __forceinline__ int swz(int r, int chunk) {
  return r * 128 + ((chunk ^ (r & 7)) << 4);
}

// silu(g) * u in f32 as (g * sigmoid(g)) * u (the plain version's
// torch.sigmoid is 1 / (1 + exp(-g)) in f32)
__device__ __forceinline__ float swiglu1(float g, float u) {
  return (g * (1.f / (1.f + expf(-g)))) * u;
}

// silu(g) * u of two bf16 pairs, rounded to bf16
__device__ __forceinline__ uint32_t swiglu2(uint32_t gw, uint32_t uw) {
  const float2 gf = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&gw));
  const float2 uf = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&uw));
  return pack_bf16(swiglu1(gf.x, uf.x), swiglu1(gf.y, uf.y));
}

// silu(gf) * uf of one int32 pair dequantized by its channel scales
__device__ __forceinline__ float dswiglu(int g, int u, float gs, float us) {
  return swiglu1((float)g * gs, (float)u * us);
}

// four int32 pairs at channels 4 c .. 4 c + 3 into two bf16 words
__device__ __forceinline__ uint2 dswiglu4(int4 g, int4 u, float4 gs, float4 us) {
  return make_uint2(
      pack_bf16(dswiglu(g.x, u.x, gs.x, us.x), dswiglu(g.y, u.y, gs.y, us.y)),
      pack_bf16(dswiglu(g.z, u.z, gs.z, us.z), dswiglu(g.w, u.w, gs.w, us.w)));
}

// the tail kernel's input: x = g (bf16, or f32 rounded to bf16), x =
// bf16(silu(g) * u) (bf16 or f32 g, u: the fused tail) or x = bf16(silu(g *
// gs) * (u * us)) (int32 g, u)
enum TailIn { kInX = 0, kInSwiglu = 1, kInDequant = 2 };

// step 1 on one chunk: the nr sub-rows r0 .. r0 + nr - 1 of x, from the g
// (and u) halves of a ring slot into X's rows (element k of sub-row r in box
// k / 64, chunk (k % 64) / 8); E = bytes per input element
template <int kIn, int E>
__device__ __forceinline__ void tail_in(const uint8_t* sg, const uint8_t* su,
                                        const float* __restrict__ gs,
                                        const float* __restrict__ us, int r0,
                                        int nr, uint8_t* X, int tid) {
  if constexpr (E == 2) {  // bf16: 8 elements (one chunk) a step
    for (int v = tid; v < nr * (TL_M / 8); v += TL_THREADS) {
      uint4 o = reinterpret_cast<const uint4*>(sg)[v];
      if constexpr (kIn == kInSwiglu) {
        const uint4 uv = reinterpret_cast<const uint4*>(su)[v];
        o = make_uint4(swiglu2(o.x, uv.x), swiglu2(o.y, uv.y),
                       swiglu2(o.z, uv.z), swiglu2(o.w, uv.w));
      }
      const int r = r0 + v / 16, k8 = v % 16;
      *reinterpret_cast<uint4*>(X + (k8 >> 3) * TL_BOX + swz(r, k8 & 7)) = o;
    }
  } else {  // f32 or int32: 4 elements (half a chunk) a step
    for (int v = tid; v < nr * (TL_M / 4); v += TL_THREADS) {
      uint2 o;
      if constexpr (kIn == kInDequant) {
        const int c = r0 * TL_M + 4 * v;  // channel
        o = dswiglu4(reinterpret_cast<const int4*>(sg)[v],
                     reinterpret_cast<const int4*>(su)[v],
                     __ldg(reinterpret_cast<const float4*>(gs + c)),
                     __ldg(reinterpret_cast<const float4*>(us + c)));
      } else {
        const float4 gv = reinterpret_cast<const float4*>(sg)[v];
        if constexpr (kIn == kInSwiglu) {
          const float4 uv = reinterpret_cast<const float4*>(su)[v];
          o = make_uint2(pack_bf16(swiglu1(gv.x, uv.x), swiglu1(gv.y, uv.y)),
                         pack_bf16(swiglu1(gv.z, uv.z), swiglu1(gv.w, uv.w)));
        } else {
          o = make_uint2(pack_bf16(gv.x, gv.y), pack_bf16(gv.z, gv.w));
        }
      }
      const int r = r0 + v / 32, k4 = v % 32;
      *reinterpret_cast<uint2*>(X + (k4 >> 4) * TL_BOX +
                                swz(r, (k4 >> 1) & 7) + (k4 & 1) * 8) = o;
    }
  }
}

// One block of 3 warpgroups per SM over tokens blockIdx.x, + gridDim.x, ...;
// g, u rows at byte strides ldg_b / ldu_b (16-byte aligned); a token's K
// sub-rows arrive in chunks of cs through a ring of S slots (the host's
// plan: fwht.py::_tail_plan). Dynamic shared memory, 1024-byte aligned:
// X | Y1 | H | S slots | S mbarriers.
template <int kIn, int E>
__global__ void __launch_bounds__(TL_THREADS, 1)
    tail_kernel(const uint8_t* __restrict__ g, const uint8_t* __restrict__ u,
                long ldg_b, long ldu_b, const float* __restrict__ gs,
                const float* __restrict__ us, int T, int K, int cs, int S,
                const __nv_bfloat16* __restrict__ A,   // (TL_KP, TL_KP)
                const __nv_bfloat16* __restrict__ Bt,  // (TL_M, TL_M), B^T
                const float* __restrict__ scale, int qmin, int qmax,
                int8_t* __restrict__ out) {
  constexpr int P = kIn == kInX ? 1 : 2;  // inputs per element
  extern __shared__ uint8_t tl_raw[];
  uint8_t* Xs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(tl_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Ys = Xs + TL_X_BYTES;
  uint8_t* Hs = Ys + TL_X_BYTES;
  uint8_t* Qs = Xs;  // the codes, staged over X's first box once X is read
  uint8_t* stage = Xs + TL_FIXED;
  const int half = cs * TL_M * E;  // bytes of one input in a slot
  const int slot_b = P * half;
  uint64_t* full = reinterpret_cast<uint64_t*>(stage + S * slot_b);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, gq = lane >> 2, t = lane & 3;
  const int row0 = wg * 64 + warp * 16 + gq;  // this thread's rows: + 0, + 8
  const int n = K * TL_M;
  const int nch = (K + cs - 1) / cs;
  const int kt_end = (K + 15) / 16;  // k16 steps of the hadK product
  const int ntok = (T - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int Q = ntok * nch;  // chunks this block consumes, in order

  // chunk q (token q / nch, chunk q % nch) into slot q % S (thread 0 only)
  auto load_chunk = [&](int q) {
    const long tok = blockIdx.x + (long)(q / nch) * gridDim.x;
    const int r0 = (q % nch) * cs, nr = min(cs, K - r0);
    const uint32_t bytes = (uint32_t)nr * TL_M * E;
    const long off = (long)r0 * TL_M * E;
    uint8_t* dst = stage + (q % S) * slot_b;
    uint64_t* bar = &full[q % S];
    hopper::mbar_arrive_expect_tx(bar, P * bytes);
    hopper::bulk_load(dst, g + tok * ldg_b + off, bytes, bar);
    if constexpr (P == 2) hopper::bulk_load(dst + half, u + tok * ldu_b + off,
                                            bytes, bar);
  };

  if (tid == 0) {
    for (int i = 0; i < S; ++i) hopper::mbar_init(&full[i], 1);
    hopper::mbar_fence_init();
    for (int q = 0; q < S && q < Q; ++q) load_chunk(q);
  }
  // the factors, once: H_128 / sqrt(128) into shared memory (row j of B^T
  // is column j of B: the K-major B operand of step 2), hadK's A fragments
  // of this thread's rows into registers (40 a thread, zero past row 160);
  // X's pad rows K..191 zeroed (the codes staged over X never reach them)
  for (int v = tid; v < TL_M * (TL_M / 8); v += TL_THREADS) {
    const int j = v / 16, k8 = v % 16;
    *reinterpret_cast<uint4*>(Hs + (k8 >> 3) * TL_H_BOX + swz(j, k8 & 7)) =
        __ldg(reinterpret_cast<const uint4*>(Bt) + v);
  }
  for (int v = tid; v < 2 * (TL_ROWS - K) * 8; v += TL_THREADS) {
    const int b = v / ((TL_ROWS - K) * 8), w = v % ((TL_ROWS - K) * 8);
    *reinterpret_cast<uint4*>(Xs + b * TL_BOX + swz(K + w / 8, w % 8)) =
        make_uint4(0, 0, 0, 0);
  }
  uint32_t ha[TL_MT][4];
#pragma unroll
  for (int kk = 0; kk < TL_MT; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + (i & 1) * 8, c = kk * 16 + 2 * t + (i >> 1) * 8;
      ha[kk][i] = r < TL_KP ? ldg32(A + r * TL_KP + c) : 0u;
    }
  const float inv = 1.f / __ldg(scale);
  hopper::fence_proxy_async();  // H and the zero rows, for the wgmma reads
  __syncthreads();

  float acc[64];
  int q = 0;
  for (int j = 0; j < ntok; ++j) {
    const long tok = blockIdx.x + (long)j * gridDim.x;
    // 1. x into X's rows 0..K-1, chunk by chunk as the ring delivers them;
    //    a slot read by every thread takes the sequence's next chunk
    for (int c = 0; c < nch; ++c, ++q) {
      const int slot = q % S;
      hopper::mbar_wait(&full[slot], (q / S) & 1);
      const uint8_t* sg = stage + slot * slot_b;
      tail_in<kIn, E>(sg, sg + half, gs, us, c * cs, min(cs, K - c * cs), Xs,
                      tid);
      hopper::fence_proxy_async();  // X's rows, for step 2's wgmma
      __syncthreads();
      if (tid == 0 && q + S < Q) load_chunk(q + S);
    }

    // 2. Y1 = X . B: wgmma m64n128k16 over the 128-wide axis, this
    //    warpgroup's 64 rows of X (A) against H (B), both K-major
#pragma unroll
    for (int i = 0; i < 64; ++i) hopper::reg_fence(acc[i]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TL_M / 16; ++kk) {
      const int box = kk / 4, off = (kk % 4) * 32;
      hopper::wgmma_bf16_ss(
          acc, hopper::desc_sw128(Xs + box * TL_BOX + wg * 64 * 128 + off, 16,
                                  1024),
          hopper::desc_sw128(Hs + box * TL_H_BOX + off, 16, 1024), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) hopper::reg_fence(acc[i]);
    // Y1 in bf16: acc[i] is row row0 + 8 ((i >> 1) & 1), column
    // (i >> 2) * 8 + 2t + (i & 1); rows past K are zero (X's pad rows)
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = row0 + ((i >> 1) & 1) * 8, col = (i >> 2) * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(Ys + (col >> 6) * TL_BOX +
                                   swz(r, (col >> 3) & 7) + (col & 7) * 2) =
          pack_bf16(acc[i], acc[i + 1]);
      acc[i] = acc[i + 1] = 0.f;
    }
    hopper::fence_proxy_async();  // Y1, for step 3's wgmma
    __syncthreads();

    // 3. Y = hadK . Y1: wgmma m64n128k16 over the hadK axis (k16 steps up
    //    to K), hadK's fragments from registers (A), Y1 MN-major through
    //    the descriptor's transpose bit (B: 64-column boxes, 8-row groups)
#pragma unroll
    for (int i = 0; i < 64; ++i) hopper::reg_fence(acc[i]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TL_MT; ++kk)
      if (kk < kt_end)  // uniform over the block
        hopper::wgmma_bf16_rs_tb(
            acc, ha[kk], hopper::desc_sw128(Ys + kk * 16 * 128, TL_BOX, 1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) hopper::reg_fence(acc[i]);

    // 4. static int8: round half to even, clip; code (r, col) staged at
    //    byte col of swizzled row r over X's first box (every warpgroup has
    //    read X: step 2 ended before the last barrier), then the row's n
    //    bytes leave as 16-byte stores
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = row0 + ((i >> 1) & 1) * 8, col = (i >> 2) * 8 + 2 * t;
      if (r < K) {
        const int q0 = quant8(acc[i], inv, qmin, qmax);
        const int q1 = quant8(acc[i + 1], inv, qmin, qmax);
        *reinterpret_cast<uint16_t*>(Qs + swz(r, col >> 4) + (col & 15)) =
            (uint16_t)((q0 & 0xFF) | ((q1 & 0xFF) << 8));
      }
    }
    __syncthreads();
    int8_t* orow = out + tok * n;
    for (int v = tid; v < n / 16; v += TL_THREADS)
      reinterpret_cast<uint4*>(orow)[v] =
          *reinterpret_cast<const uint4*>(Qs + swz(v >> 3, v & 7));
    __syncthreads();  // the codes are read: the next token's x goes over them
  }
}

// ---------------------------------------------------------------------------
// rms_norm_quant
// ---------------------------------------------------------------------------

constexpr int RQ_THREADS = 256;  // 16 elements a thread per pass

__device__ __forceinline__ float2 bf2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
}

__global__ void __launch_bounds__(RQ_THREADS)
    rms_quant_kernel(const __nv_bfloat16* __restrict__ x, int ldx,
                     const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ scale, int8_t* __restrict__ out,
                     int n, float eps, int qmin, int qmax) {
  __shared__ float warp_ss[RQ_THREADS / 32];
  const long row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * ldx);
  const uint4* wr = reinterpret_cast<const uint4*>(w);
  const int chunks = n / 16;  // two 16-byte bf16 loads, one 16-byte store

  // 1. f32 sum of squares: each thread's chunks, then the warp, then the
  //    warps in a fixed order (every thread gets the same sum)
  float ss = 0.f;
  for (int c = tid; c < chunks; c += RQ_THREADS) {
    const uint4 a = __ldg(xr + 2 * c), b = __ldg(xr + 2 * c + 1);
    const uint32_t v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 f = bf2(v[i]);
      ss = fmaf(f.x, f.x, ss);
      ss = fmaf(f.y, f.y, ss);
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (lane == 0) warp_ss[warp] = ss;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int i = 0; i < RQ_THREADS / 32; ++i) tot += warp_ss[i];
  // mean as sum / n (jnp.mean divides); rsqrtf is what torch.rsqrt runs on
  // the card, so the plain version there takes the same root
  const float r = rsqrtf(tot / (float)n + eps);
  const float inv = 1.f / __ldg(scale);

  // 2. (x * r) * w, quantized; the row comes again from L1
  int8_t* orow = out + row * n;
  for (int c = tid; c < chunks; c += RQ_THREADS) {
    const uint4 a = __ldg(xr + 2 * c), b = __ldg(xr + 2 * c + 1);
    const uint4 wa = __ldg(wr + 2 * c), wb = __ldg(wr + 2 * c + 1);
    const uint32_t v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    const uint32_t wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
    uint32_t q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f0 = bf2(v[2 * i]), f1 = bf2(v[2 * i + 1]);
      const float2 w0 = bf2(wv[2 * i]), w1 = bf2(wv[2 * i + 1]);
      const int q0 = quant8((f0.x * r) * w0.x, inv, qmin, qmax);
      const int q1 = quant8((f0.y * r) * w0.y, inv, qmin, qmax);
      const int q2 = quant8((f1.x * r) * w1.x, inv, qmin, qmax);
      const int q3 = quant8((f1.y * r) * w1.y, inv, qmin, qmax);
      q[i] = (uint32_t)(q0 & 0xFF) | ((uint32_t)(q1 & 0xFF) << 8) |
             ((uint32_t)(q2 & 0xFF) << 16) | ((uint32_t)(q3 & 0xFF) << 24);
    }
    reinterpret_cast<uint4*>(orow)[c] = make_uint4(q[0], q[1], q[2], q[3]);
  }
}

// ---------------------------------------------------------------------------
// fwht: f32 two-factor Hadamard
// ---------------------------------------------------------------------------

// one butterfly stage across lanes: element i meets i ^ (4 * mask); the
// lower one keeps the sum v + p, the upper one the difference p - v, as
// p + sg v with sg = +-1 (one exactly rounded operation either way)
__device__ __forceinline__ float bfly(float v, int mask, float sg) {
  return fmaf(sg, v, __shfl_xor_sync(0xffffffffu, v, mask));
}

// Y1 = X . H_128 of one 128-wide sub-row v (this lane's elements 4 lane ..
// 4 lane + 3) in place: index bits 0-1 in the lane, bits 2-6 across lanes;
// Sylvester order, as hadamard_matrix(128)
__device__ __forceinline__ void butterfly128(float4& v, int lane) {
  const float a0 = v.x + v.y, a1 = v.x - v.y;  // h = 1
  const float a2 = v.z + v.w, a3 = v.z - v.w;
  float e0 = a0 + a2, e1 = a1 + a3, e2 = a0 - a2, e3 = a1 - a3;  // h = 2
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {  // h = 4 .. 64
    const float sg = lane & s ? -1.f : 1.f;
    e0 = bfly(e0, s, sg);
    e1 = bfly(e1, s, sg);
    e2 = bfly(e2, s, sg);
    e3 = bfly(e3, s, sg);
  }
  v = make_float4(e0, e1, e2, e3);
}

// fwht_tc_kernel's shared memory: the three bf16 planes of Y1 (hi, mid, lo),
// each two boxes of 64 columns over TL_KP rows (128-byte swizzled, rows K ..
// TL_KP - 1 zero), the output staging (bf16 only), then the ring of x rows
// and their mbarriers
constexpr int FT_BOX = TL_KP * 128;     // 20,480
constexpr int FT_PLANE = 2 * FT_BOX;    // 40,960
constexpr int FT_FIXED = 3 * FT_PLANE;  // 122,880
constexpr int FT_STAGE_MAX =
    TL_SMEM - FT_FIXED - 1024 - 8 * TL_MAX_SLOTS;  // 108,480
// bf16 outputs are staged per warpgroup (64 rows of 256 bytes each) so that
// they leave as 16-byte stores: 4-byte ones write half sectors, which cost
// the bf16 kernel more than its products (PERF.md, Findings); f32 pairs fill
// whole 32-byte sectors straight from the registers
constexpr int FT_OSTAGE_WG = 64 * 256;

// the pair (a, b) as 8 bytes of f32 or 4 of bf16 at p
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

__device__ __forceinline__ float4 slot_row(const float* p, int lane) {
  return reinterpret_cast<const float4*>(p)[lane];
}
__device__ __forceinline__ float4 slot_row(const __nv_bfloat16* p, int lane) {
  const uint2 v = reinterpret_cast<const uint2*>(p)[lane];
  const float2 a = bf2(v.x), b = bf2(v.y);
  return make_float4(a.x, a.y, b.x, b.y);
}

// y, three bf16 terms that sum to it exactly (hi = bf16(y), mid =
// bf16(y - hi), lo = y - hi - mid: each difference is exact in f32, and lo
// keeps the last 8 of y's 24 bits)
__device__ __forceinline__ void split3(float y, __nv_bfloat16& h,
                                       __nv_bfloat16& m, __nv_bfloat16& l) {
  h = __float2bfloat16_rn(y);
  const float r1 = y - __bfloat162float(h);
  m = __float2bfloat16_rn(r1);
  l = __float2bfloat16_rn(r1 - __bfloat162float(m));
}

// One block of 3 warpgroups per SM over tokens blockIdx.x, + gridDim.x, ...
// (the tail kernel's schedule): x rows at byte stride ldx_b through a ring of
// S slots of one whole row each (fwht.py::_fwht_plan); hadK = c * sgn, sgn
// (TL_KP, TL_KP) bf16 +-1, zero-padded; hm = 1 / sqrt(128). Dynamic shared
// memory, 1024-byte aligned: planes | bf16 staging | S slots | S mbarriers.
template <typename V>
__global__ void __launch_bounds__(TL_THREADS, 1)
    fwht_tc_kernel(const uint8_t* __restrict__ x, long ldx_b, int T, int K,
                   int S, const __nv_bfloat16* __restrict__ sgn, float c,
                   float hm, V* __restrict__ out) {
  extern __shared__ uint8_t ft_raw[];
  uint8_t* Ys = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(ft_raw) + 1023) & ~uintptr_t(1023));
  constexpr bool kStaged = sizeof(V) == 2;
  uint8_t* stage = Ys + FT_FIXED + (kStaged ? 3 * FT_OSTAGE_WG : 0);
  const int n = K * TL_M;
  const int row_b = n * (int)sizeof(V);
  uint64_t* full = reinterpret_cast<uint64_t*>(stage + S * row_b);

  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5;
  const int lane = tid & 31, gq = lane >> 2, t = lane & 3;
  const int row0 = wg * 64 + (warp & 3) * 16 + gq;  // rows + 0, + 8
  const bool live = wg * 64 < K;  // this warpgroup has output rows
  const int kt_end = (K + 15) / 16;  // k16 steps of the hadK product
  const int ntok = (T - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  // token j of this block into slot j % S (thread 0 only)
  auto load_row = [&](int j) {
    const long tok = blockIdx.x + (long)j * gridDim.x;
    hopper::mbar_arrive_expect_tx(&full[j % S], row_b);
    hopper::bulk_load(stage + (j % S) * row_b, x + tok * ldx_b, row_b,
                      &full[j % S]);
  };

  if (tid == 0) {
    for (int i = 0; i < S; ++i) hopper::mbar_init(&full[i], 1);
    hopper::mbar_fence_init();
    for (int j = 0; j < S && j < ntok; ++j) load_row(j);
  }
  // the planes' pad rows K .. TL_KP - 1 zeroed once (the sign fragments'
  // pad columns are zero, but 0 times a stale value need not be); the
  // sign fragments of this thread's rows into registers, once (40 a
  // thread, zero past row TL_KP)
  for (int v = tid; v < 6 * (TL_KP - K) * 8; v += TL_THREADS) {
    const int b = v / ((TL_KP - K) * 8), w = v % ((TL_KP - K) * 8);
    *reinterpret_cast<uint4*>(Ys + b * FT_BOX + swz(K + w / 8, w % 8)) =
        make_uint4(0, 0, 0, 0);
  }
  uint32_t sa[TL_MT][4];
#pragma unroll
  for (int kk = 0; kk < TL_MT; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + (i & 1) * 8, col = kk * 16 + 2 * t + (i >> 1) * 8;
      sa[kk][i] = r < TL_KP ? ldg32(sgn + r * TL_KP + col) : 0u;
    }
  hopper::fence_proxy_async();  // the zero rows, for the wgmma reads
  __syncthreads();

  float acc[64];
  for (int j = 0; j < ntok; ++j) {
    V* orow = out + (blockIdx.x + (long)j * gridDim.x) * n;
    hopper::mbar_wait(&full[j % S], (j / S) & 1);
    const V* src = reinterpret_cast<const V*>(stage + (j % S) * row_b);
    // 1. Y1 = X . H_128 / sqrt(128) in f32, one sub-row per warp at a time,
    //    split into the three planes (element (l, col) at byte 2 col of row
    //    l); at K = 1 Y1 is the result, stored at once
    for (int l = warp; l < K; l += TL_THREADS / 32) {
      float4 v = slot_row(src + l * TL_M, lane);
      butterfly128(v, lane);
      const float y[4] = {v.x * hm, v.y * hm, v.z * hm, v.w * hm};
      if (K == 1) {
        store2(orow + 4 * lane, y[0] * c, y[1] * c);
        store2(orow + 4 * lane + 2, y[2] * c, y[3] * c);
        continue;
      }
      uint32_t pw[3][2];  // plane pl's 4 bf16 terms, 2 a word
#pragma unroll
      for (int k = 0; k < 4; k += 2) {
        __nv_bfloat16 a[3], b[3];
        split3(y[k], a[0], a[1], a[2]);
        split3(y[k + 1], b[0], b[1], b[2]);
#pragma unroll
        for (int pl = 0; pl < 3; ++pl)
          pw[pl][k >> 1] = (uint32_t)__bfloat16_as_ushort(a[pl]) |
                           ((uint32_t)__bfloat16_as_ushort(b[pl]) << 16);
      }
      const int off = (lane >> 4) * FT_BOX + swz(l, (lane >> 1) & 7) +
                      (lane & 1) * 8;
#pragma unroll
      for (int pl = 0; pl < 3; ++pl)
        *reinterpret_cast<uint2*>(Ys + pl * FT_PLANE + off) =
            make_uint2(pw[pl][0], pw[pl][1]);
    }
    hopper::fence_proxy_async();  // the planes, for step 2's wgmma
    __syncthreads();
    if (tid == 0 && j + S < ntok) load_row(j + S);  // the slot is read
    if (K == 1) continue;

    // 2. Y = c (sgn . lo + sgn . mid + sgn . hi): wgmma m64n128k16 over
    //    the hadK axis (k16 steps up to K), the sign fragments from
    //    registers (A), each plane MN-major through the descriptor's
    //    transpose bit (B); every product is exact and the sums are f32,
    //    smallest plane first
    if (live) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        acc[i] = 0.f;
        hopper::reg_fence(acc[i]);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int pl = 2; pl >= 0; --pl)
#pragma unroll
        for (int kk = 0; kk < TL_MT; ++kk)
          if (kk < kt_end)  // uniform over the block
            hopper::wgmma_bf16_rs_tb(
                acc, sa[kk],
                hopper::desc_sw128(Ys + pl * FT_PLANE + kk * 16 * 128,
                                   FT_BOX, 1024));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 64; ++i) hopper::reg_fence(acc[i]);
    }
    // every warpgroup's products have read the planes: the next token's
    // step 1 may write them while this token's outputs leave
    __syncthreads();
    // 3. c . acc: acc[i] is row row0 + 8 ((i >> 1) & 1), column (i >> 2) *
    //    8 + 2t + (i & 1). f32: straight from the registers (a warp's store
    //    covers 8 rows x 8 columns, 32-byte sectors). bf16: through this
    //    warpgroup's staging rows (row lr's 16-byte chunk ch at ch ^ (lr %
    //    8)), then 16-byte stores; the next token's staging writes follow
    //    two block barriers, after these reads
    if (live) {
      if constexpr (kStaged) {
        uint8_t* St = Ys + FT_FIXED + wg * FT_OSTAGE_WG;
#pragma unroll
        for (int i = 0; i < 64; i += 2) {
          const int lr = row0 - wg * 64 + ((i >> 1) & 1) * 8;
          const int col = (i >> 2) * 8 + 2 * t;
          *reinterpret_cast<uint32_t*>(St + lr * 256 +
                                       (((col >> 3) ^ (lr & 7)) << 4) +
                                       (col & 7) * 2) =
              pack_bf16(acc[i] * c, acc[i + 1] * c);
        }
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
        const int rows = min(64, K - wg * 64);
        for (int v = tid & 127; v < rows * 16; v += 128) {
          const int lr = v >> 4, ch = v & 15;
          reinterpret_cast<uint4*>(orow + (wg * 64 + lr) * TL_M)[ch] =
              *reinterpret_cast<const uint4*>(St + lr * 256 +
                                              ((ch ^ (lr & 7)) << 4));
        }
      } else {
#pragma unroll
        for (int i = 0; i < 64; i += 2) {
          const int r = row0 + ((i >> 1) & 1) * 8, col = (i >> 2) * 8 + 2 * t;
          if (r < K)
            store2(orow + r * TL_M + col, acc[i] * c, acc[i + 1] * c);
        }
      }
    }
  }
}

// the dense hadK product, for a factor that is not c times a sign matrix
// (the seeded random orthogonal block of K = 156, which no Hadamard
// construction gives): one block per row, each warp transforms whole
// 128-wide sub-rows in registers into shared memory (f32, 80 KB at K =
// 156), then computes 20 rows of A . Y1 for the 4 columns of each lane (80
// f32 FMA accumulators), with A^T zero-padded to 160 columns and read as
// broadcast 16-byte loads through L1.
constexpr int FW_THREADS = 256;               // 8 warps
constexpr int FW_ROWS = TL_KP / (FW_THREADS / 32);  // 20 hadK rows a warp

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = bf2(v.x), b = bf2(v.y);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v.x, v.y),
                                            pack_bf16(v.z, v.w));
}

template <typename V>
__global__ void __launch_bounds__(FW_THREADS, 2)
    fwht_kernel(const V* __restrict__ x, int ldx, int K,
                const float* __restrict__ At,  // (K, TL_KP): A^T, zero-padded
                float hm, V* __restrict__ out) {
  extern __shared__ float4 Ys4[];  // Y1 (K, 128) f32
  const long row = blockIdx.x;
  const int n = K * TL_M;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const V* xr = x + row * ldx;

  // 1. Y1 = X . H_128 / sqrt(128), one 128-wide sub-row per warp at a time
  for (int l = warp; l < K; l += FW_THREADS / 32) {
    float4 v = load4(xr + l * TL_M + 4 * lane);
    butterfly128(v, lane);
    Ys4[l * (TL_M / 4) + lane] =
        make_float4(v.x * hm, v.y * hm, v.z * hm, v.w * hm);
  }
  __syncthreads();

  // 2. Y = A . Y1: warp w owns rows 20 w .. 20 w + 19, each lane the columns
  //    4 lane .. 4 lane + 3; A^T's row l holds the warp's 20 coefficients
  //    side by side (one broadcast 16-byte load per 4 rows)
  const int k0 = warp * FW_ROWS;
  if (k0 >= K) return;  // warp-uniform; no barrier follows
  float acc[FW_ROWS][4];
#pragma unroll
  for (int i = 0; i < FW_ROWS; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  const float4* ap = reinterpret_cast<const float4*>(At + k0);
#pragma unroll 2
  for (int l = 0; l < K; ++l) {
    const float4 y = Ys4[l * (TL_M / 4) + lane];
#pragma unroll
    for (int q = 0; q < FW_ROWS / 4; ++q) {
      const float4 a = __ldg(ap + l * (TL_KP / 4) + q);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* o = acc[4 * q + i];
        o[0] = fmaf(av[i], y.x, o[0]);
        o[1] = fmaf(av[i], y.y, o[1]);
        o[2] = fmaf(av[i], y.z, o[2]);
        o[3] = fmaf(av[i], y.w, o[3]);
      }
    }
  }

  // 3. out[k * 128 + 4 lane ..]: 512 contiguous bytes (f32) a row per warp
  V* orow = out + row * n;
#pragma unroll
  for (int i = 0; i < FW_ROWS; ++i)
    if (k0 + i < K)
      store4(orow + (k0 + i) * TL_M + 4 * lane,
             make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
}

template <typename V>
int launch_fwht(const void* x, int ldx, const void* sgn, float c, float hm,
                void* out, int T, int K, int grid, int S, void* stream) {
  if (K < 1 || K > TL_KP || T < 1 || grid < 1 || grid > T || S < 1 ||
      S > TL_MAX_SLOTS)
    return (int)cudaErrorInvalidValue;
  const int ostage = sizeof(V) == 2 ? 3 * FT_OSTAGE_WG : 0;
  const long ring = (long)S * K * TL_M * sizeof(V);
  if (ring > FT_STAGE_MAX - ostage) return (int)cudaErrorInvalidValue;
  static bool sized = false;  // above 48 KB only after the attribute is set
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        fwht_tc_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        TL_SMEM);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const int smem = FT_FIXED + ostage + 1024 + (int)ring + 8 * S;
  fwht_tc_kernel<V><<<grid, TL_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)x, (long)ldx * sizeof(V), T, K, S,
      (const __nv_bfloat16*)sgn, c, hm, (V*)out);
  return (int)cudaGetLastError();
}

template <typename V>
int launch_fwht_dense(const void* x, int ldx, const void* At, float hm,
                      void* out, int T_, int K, cudaStream_t stream) {
  static bool sized = false;  // above 48 KB only after the attribute is set
  const int smem = TL_KP * TL_M * (int)sizeof(float);
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        fwht_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  fwht_kernel<V><<<T_, FW_THREADS, K * TL_M * (int)sizeof(float), stream>>>(
      (const V*)x, ldx, K, (const float*)At, hm, (V*)out);
  return (int)cudaGetLastError();
}

bool bad_range(int qmin, int qmax) {
  return qmin < -128 || qmin > qmax || qmax > 127;
}

// the tail kernel for E-byte inputs at element strides ldg / ldu on the
// plan (grid blocks, chunks of cs sub-rows, S ring slots)
template <int kIn, int E>
int launch_tail(const void* g, const void* u, int ldg, int ldu, const void* gs,
                const void* us, const void* A, const void* Bt,
                const void* scale, void* out, int T, int K, int qmin,
                int qmax, int grid, int cs, int S, void* stream) {
  constexpr int P = kIn == kInX ? 1 : 2;
  if (K < 1 || K > TL_KP || T < 1 || bad_range(qmin, qmax) || grid < 1 ||
      grid > T || cs < 1 || cs > K || S < 1 || S > TL_MAX_SLOTS)
    return (int)cudaErrorInvalidValue;
  const long stage = (long)S * P * cs * TL_M * E;
  if (stage > TL_STAGE_MAX) return (int)cudaErrorInvalidValue;
  static bool sized = false;  // above 48 KB only after the attribute is set
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        tail_kernel<kIn, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        TL_SMEM);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const int smem = TL_FIXED + 1024 + (int)stage + 8 * S;
  tail_kernel<kIn, E><<<grid, TL_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)g, (const uint8_t*)u, (long)ldg * E, (long)ldu * E,
      (const float*)gs, (const float*)us, T, K, cs, S,
      (const __nv_bfloat16*)A, (const __nv_bfloat16*)Bt, (const float*)scale,
      qmin, qmax, (int8_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (T, K * 128) int8 = clip(round((A (x) H_128) . (silu(g) * u) / scale),
// qmin, qmax). g, u: (T, K * 128) rows at strides ldg / ldu (elements; rows
// 16-byte aligned), bf16, or f32 where in_f32. A: (160, 160) bf16, hadK
// zero-padded; Bt: (128, 128) bf16, the transposed H_128 / sqrt(128); scale:
// one f32 on the device. K <= 160; -128 <= qmin <= qmax <= 127. The plan:
// `grid` blocks (<= T), chunks of cs sub-rows, S ring slots (<= 8) whose
// S * (2 cs * 128 * element bytes) fit the ring's 135,104 bytes.
int mq_fused_swiglu_had_quant(const void* g, const void* u, int ldg, int ldu,
                              const void* A, const void* Bt, const void* scale,
                              void* out, int T, int K, int qmin, int qmax,
                              int in_f32, int grid, int cs, int S,
                              void* stream) {
  return in_f32 ? launch_tail<kInSwiglu, 4>(g, u, ldg, ldu, nullptr, nullptr,
                                            A, Bt, scale, out, T, K, qmin,
                                            qmax, grid, cs, S, stream)
                : launch_tail<kInSwiglu, 2>(g, u, ldg, ldu, nullptr, nullptr,
                                            A, Bt, scale, out, T, K, qmin,
                                            qmax, grid, cs, S, stream);
}

// out (T, K * 128) int8 = clip(round((A (x) H_128) . bf16(x) / scale), qmin,
// qmax); x: (T, K * 128) rows at stride ldx, bf16, or f32 where in_f32 (each
// element rounded to bf16); A, Bt, scale, K, qmin, qmax and the plan as
// above (one input: S * cs * 128 * element bytes).
int mq_had_quant(const void* x, int ldx, const void* A, const void* Bt,
                 const void* scale, void* out, int T, int K, int qmin,
                 int qmax, int in_f32, int grid, int cs, int S, void* stream) {
  return in_f32 ? launch_tail<kInX, 4>(x, x, ldx, ldx, nullptr, nullptr, A,
                                       Bt, scale, out, T, K, qmin, qmax, grid,
                                       cs, S, stream)
                : launch_tail<kInX, 2>(x, x, ldx, ldx, nullptr, nullptr, A,
                                       Bt, scale, out, T, K, qmin, qmax, grid,
                                       cs, S, stream);
}

// out (T, K * 128) int8 = clip(round((A (x) H_128) . x / scale), qmin, qmax)
// with x = bf16(silu(g * gs) * (u * us)) in f32; g, u: (T, K * 128) int32
// rows at strides ldg / ldu (elements; rows 16-byte aligned); gs, us: (K *
// 128,) f32; A, Bt, scale, K, qmin, qmax and the plan as above.
int mq_dequant_swiglu_had_quant(const void* g, const void* u, int ldg, int ldu,
                                const void* gs, const void* us, const void* A,
                                const void* Bt, const void* scale, void* out,
                                int T, int K, int qmin, int qmax, int grid,
                                int cs, int S, void* stream) {
  return launch_tail<kInDequant, 4>(g, u, ldg, ldu, gs, us, A, Bt, scale, out,
                                    T, K, qmin, qmax, grid, cs, S, stream);
}

// out (T, n) int8 = clip(round(x * rsqrt(mean(x^2) + eps) * w / scale), qmin,
// qmax); x: (T, n) bf16 rows at stride ldx (16-byte aligned), w: (n,) bf16,
// scale: one f32 on the device; n % 16 == 0.
int mq_rms_norm_quant(const void* x, int ldx, const void* w, const void* scale,
                      void* out, int T, int n, float eps, int qmin, int qmax,
                      void* stream) {
  if (T < 1 || n < 16 || n % 16 || ldx % 8 || bad_range(qmin, qmax))
    return (int)cudaErrorInvalidValue;
  rms_quant_kernel<<<T, RQ_THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, ldx, (const __nv_bfloat16*)w,
      (const float*)scale, (int8_t*)out, n, eps, qmin, qmax);
  return (int)cudaGetLastError();
}

// out (T, K * 128) = c (sgn (x) H_128) . x in f32, stored as x's type
// (is_f32: f32, else bf16), on the tensor cores; x rows at stride ldx
// (elements; rows 16-byte aligned); sgn: (160, 160) bf16, sign(hadK)
// zero-padded, hadK = c sgn; hm: the f32 entry 1 / sqrt(128) of H_128 /
// sqrt(128). K <= 160. The plan: `grid` blocks (<= T), S ring slots (<= 8)
// of one row each, S * K * 128 * element bytes within the ring's 108,480
// bytes (bf16: 59,328, beside the output staging).
int mq_fwht(const void* x, int ldx, const void* sgn, float c, float hm,
            void* out, int T, int K, int is_f32, int grid, int S,
            void* stream) {
  return is_f32 ? launch_fwht<float>(x, ldx, sgn, c, hm, out, T, K, grid, S,
                                     stream)
                : launch_fwht<__nv_bfloat16>(x, ldx, sgn, c, hm, out, T, K,
                                             grid, S, stream);
}

// The same transform for a hadK that is not c times a sign matrix, by f32
// FMA; At: (K, 160) f32, A^T zero-padded.
int mq_fwht_dense(const void* x, int ldx, const void* At, float hm, void* out,
                  int T, int K, int is_f32, void* stream) {
  if (K < 1 || K > TL_KP || T < 1) return (int)cudaErrorInvalidValue;
  return is_f32 ? launch_fwht_dense<float>(x, ldx, At, hm, out, T, K,
                                           (cudaStream_t)stream)
                : launch_fwht_dense<__nv_bfloat16>(x, ldx, At, hm, out, T, K,
                                                   (cudaStream_t)stream);
}

}  // extern "C"
