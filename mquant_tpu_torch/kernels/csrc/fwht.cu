// Fused MLP tail before the full-Hadamard down projection, on Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// mquant_tpu_torch/kernels/_build.py.
//
// K6  fused_swiglu_had_quant  replaces
//     mquant_tpu/kernels/fwht.py::fused_swiglu_had_quant (_tail_kernel, its
//     pl.pallas_call at :320). For each token row of n = K * 128 (Qwen2-VL-7B:
//     n = 18944, K = 148, the Paley factor of the Hadamard order):
//       x  = bf16(silu(g) * u)                  in f32, then rounded
//       Y1 = bf16(X . B)     X = x viewed (K, 128), B = H_128 / sqrt(128)
//       Y  = A . Y1          A = hadK (K, K), orthonormal
//       q  = clip(round(Y * (1 / scale)), -128, 127)  at position k*128 + j
//     Both products take bf16 operands with f32 sums, as the TPU kernel's
//     dots (preferred_element_type=f32); rounding is half to even.
//
// What bounds it on an H100. Per token it reads g and u (4 bytes per
// element) and writes one int8 code per element: 97 MB at T = 1024, 29 us at
// 3.35 TB/s. The two products are 2 * n * (K + 128) = 10.5 MFLOP per token,
// 10.7 GFLOP at T = 1024 (11 us at the dense bf16 peak): the kernel is bound
// by bytes as long as the products stay on the tensor cores. So one block
// keeps one whole row in shared memory through all three steps (38 KB as
// (160, 128) bf16), device memory sees g, u and the codes once, and both
// products run on mma.sync m16n8k16 bf16 -> f32. The hadK axis is zero-padded
// from K to 160 (ten 16-row tiles): exact, since the pad rows of X and the
// pad rows and columns of A are zero, and the pad rows of Y are never
// written. The factor matrices come from the wrapper (A padded, B
// transposed), the very matrices of the plain version; the 51 KB A and 32 KB
// B are read through L1 by every block. Each of the 8 warps owns 16 output
// columns over all 160 rows (80 f32 accumulators). The codes are staged in
// shared memory and written out with 16-byte stores. A TMA / wgmma pipeline
// and several tokens per block (to share the A fragments) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TL_M = 128;           // the power-of-two factor: row tile width
constexpr int TL_KP = 160;          // hadK rows, zero-padded to 10 m16 tiles
constexpr int TL_MT = TL_KP / 16;   // m tiles
constexpr int TL_LD = TL_M + 8;     // padded row (272 B): conflict-free fragments
constexpr int TL_THREADS = 256;     // 8 warps x 16 output columns

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

__device__ __forceinline__ uint32_t ldg32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// silu(g) * u of two bf16 pairs, in f32 as (g * sigmoid(g)) * u, rounded to
// bf16 (the plain version's torch.sigmoid is 1 / (1 + exp(-g)) in f32)
__device__ __forceinline__ uint32_t swiglu2(uint32_t gw, uint32_t uw) {
  const float2 gf = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&gw));
  const float2 uf = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&uw));
  const float s0 = 1.f / (1.f + expf(-gf.x)), s1 = 1.f / (1.f + expf(-gf.y));
  return pack_bf16((gf.x * s0) * uf.x, (gf.y * s1) * uf.y);
}

__global__ void __launch_bounds__(TL_THREADS, 2)
    tail_kernel(const __nv_bfloat16* __restrict__ g,
                const __nv_bfloat16* __restrict__ u, int ldg_, int ldu_, int K,
                const __nv_bfloat16* __restrict__ A,   // (TL_KP, TL_KP)
                const __nv_bfloat16* __restrict__ Bt,  // (TL_M, TL_M), B^T
                const float* __restrict__ scale, int8_t* __restrict__ out) {
  __shared__ __align__(16) __nv_bfloat16 Xs[TL_KP][TL_LD];
  const long row = blockIdx.x;
  const int n = K * TL_M;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int n0 = warp * 16;  // this warp's output columns n0 .. n0 + 15

  // 1. x = bf16(silu(g) * u) into rows 0..K-1, zeros into the pad rows
  const __nv_bfloat16* gr = g + row * ldg_;
  const __nv_bfloat16* ur = u + row * ldu_;
  for (int v = tid; v < n / 8; v += TL_THREADS) {
    const uint4 gv = __ldg(reinterpret_cast<const uint4*>(gr) + v);
    const uint4 uv = __ldg(reinterpret_cast<const uint4*>(ur) + v);
    const uint4 o = make_uint4(swiglu2(gv.x, uv.x), swiglu2(gv.y, uv.y),
                               swiglu2(gv.z, uv.z), swiglu2(gv.w, uv.w));
    const int e = v * 8;
    *reinterpret_cast<uint4*>(&Xs[e / TL_M][e % TL_M]) = o;
  }
  for (int v = tid; v < (TL_KP - K) * TL_M / 8; v += TL_THREADS) {
    const int e = v * 8;
    *reinterpret_cast<uint4*>(&Xs[K + e / TL_M][e % TL_M]) =
        make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  float acc[TL_MT][2][4];
#pragma unroll
  for (int mt = 0; mt < TL_MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // 2. Y1 = X . B over the 128-wide axis (8 k steps); B fragments from B^T,
  //    whose row n holds column n of B with consecutive k
#pragma unroll 2
  for (int kk = 0; kk < TL_M / 16; ++kk) {
    uint32_t b[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const __nv_bfloat16* bp = Bt + (n0 + nt * 8 + gq) * TL_M + kk * 16 + 2 * t;
      b[nt][0] = ldg32(bp);
      b[nt][1] = ldg32(bp + 8);
    }
#pragma unroll
    for (int mt = 0; mt < TL_MT; ++mt) {
      const int r = mt * 16 + gq, c = kk * 16 + 2 * t;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(&Xs[r][c]);
      a[1] = *reinterpret_cast<const uint32_t*>(&Xs[r + 8][c]);
      a[2] = *reinterpret_cast<const uint32_t*>(&Xs[r][c + 8]);
      a[3] = *reinterpret_cast<const uint32_t*>(&Xs[r + 8][c + 8]);
      mma_bf16(acc[mt][0], a, b[0][0], b[0][1]);
      mma_bf16(acc[mt][1], a, b[1][0], b[1][1]);
    }
  }
  __syncthreads();  // every warp has read X: Y1 (bf16) goes over it
#pragma unroll
  for (int mt = 0; mt < TL_MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int r = mt * 16 + gq, c = n0 + nt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(&Xs[r][c]) =
          pack_bf16(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<uint32_t*>(&Xs[r + 8][c]) =
          pack_bf16(acc[mt][nt][2], acc[mt][nt][3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
  __syncthreads();

  // 3. Y = A . Y1 over the padded hadK axis (10 k steps); Y1's B fragments
  //    through ldmatrix.trans (rows k, columns n0 .. n0 + 15)
#pragma unroll 1
  for (int kk = 0; kk < TL_MT; ++kk) {
    uint32_t vf[4];
    const int vr = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    ldsm_x4_trans(vf, &Xs[vr][n0 + (lane >> 4) * 8]);
#pragma unroll
    for (int mt = 0; mt < TL_MT; ++mt) {
      const __nv_bfloat16* ap = A + (mt * 16 + gq) * TL_KP + kk * 16 + 2 * t;
      uint32_t a[4];
      a[0] = ldg32(ap);
      a[1] = ldg32(ap + 8 * TL_KP);
      a[2] = ldg32(ap + 8);
      a[3] = ldg32(ap + 8 * TL_KP + 8);
      mma_bf16(acc[mt][0], a, vf[0], vf[1]);
      mma_bf16(acc[mt][1], a, vf[2], vf[3]);
    }
  }

  // 4. static int8: round half to even, clip; the row's codes are staged in
  //    shared memory (k * 128 + j) and leave as 16-byte stores
  const float inv = 1.f / __ldg(scale);
  __syncthreads();  // every warp has read Y1
  int8_t* Qs = reinterpret_cast<int8_t*>(&Xs[0][0]);
#pragma unroll
  for (int mt = 0; mt < TL_MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + gq + 8 * h, c = n0 + nt * 8 + 2 * t;
        if (r < K) {
          const int q0 = max(-128, min(127, __float2int_rn(
                                                acc[mt][nt][2 * h] * inv)));
          const int q1 = max(-128, min(127, __float2int_rn(
                                                acc[mt][nt][2 * h + 1] * inv)));
          *reinterpret_cast<uint16_t*>(Qs + r * TL_M + c) =
              (uint16_t)((q0 & 0xFF) | ((q1 & 0xFF) << 8));
        }
      }
  __syncthreads();
  int8_t* orow = out + row * n;
  for (int v = tid; v < n / 16; v += TL_THREADS)
    reinterpret_cast<uint4*>(orow)[v] = reinterpret_cast<const uint4*>(Qs)[v];
}

}  // namespace

extern "C" {

// out (T, K * 128) int8 = clip(round((A (x) H_128) . (silu(g) * u) / scale)).
// g, u: (T, K * 128) bf16 rows at strides ldg / ldu (elements; rows 16-byte
// aligned). A: (160, 160) bf16, hadK zero-padded; Bt: (128, 128) bf16, the
// transposed H_128 / sqrt(128); scale: one f32 on the device. K <= 160.
int mq_fused_swiglu_had_quant(const void* g, const void* u, int ldg, int ldu,
                              const void* A, const void* Bt, const void* scale,
                              void* out, int T, int K, void* stream) {
  if (K < 1 || K > TL_KP || T < 1) return (int)cudaErrorInvalidValue;
  tail_kernel<<<T, TL_THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)g, (const __nv_bfloat16*)u, ldg, ldu, K,
      (const __nv_bfloat16*)A, (const __nv_bfloat16*)Bt, (const float*)scale,
      (int8_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
