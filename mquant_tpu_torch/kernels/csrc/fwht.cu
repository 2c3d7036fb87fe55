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
// K7  had_quant  replaces fwht.py::had_quant (_had_quant_kernel, :187): the
//     same pipeline on one bf16 input x instead of silu(g) * u (the tail
//     kernel instantiated with kIn = kInX).
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
//     H_128) x in f32 throughout, bf16 or f32 in and out.
//
// What bounds the tail on an H100. Per token it reads g and u (4 bytes per
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
// had_quant reads 2 bytes per element instead of 4 (58 MB, 17 us);
// dequant_swiglu_had_quant 8 (int32 g and u: 175 MB with the codes, 52 us).
//
// rms_norm_quant moves 3 bytes per element (11 MB at (1024, 3584), 3.3 us)
// and does a few flops per byte: bound by bytes. One block per row: 16-byte
// loads, the f32 sum of squares by warp shuffles and one shared-memory pass,
// then the row again (from L1) into 16-byte int8 stores.
//
// fwht must hold f32 to ~1e-6, so no tensor cores (TF32 keeps 10 mantissa
// bits). As a butterfly the 128-wide factor costs 8 n flops and the dense
// hadK product 2 K n (5.9 GFLOP at (1024, 18944): 88 us at the 67 TFLOP/s f32
// rate, above the 23 us of its bf16 bytes): bound by operations. One block
// per row: each warp transforms whole 128-wide sub-rows in registers (4
// values a lane; two stages inside the lane, five by shuffles) into shared
// memory (f32, 74 KB at K = 148, dynamic), then each warp computes 20 rows of
// A . Y1 for the 4 columns of each lane (80 f32 FMA accumulators), with A^T
// zero-padded to 160 columns and read as broadcast 16-byte loads through L1.

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

__device__ __forceinline__ int quant8(float y, float inv, int qmin,
                                      int qmax) {
  return max(qmin, min(qmax, __float2int_rn(y * inv)));
}

// silu(g) * u of two bf16 pairs, in f32 as (g * sigmoid(g)) * u, rounded to
// bf16 (the plain version's torch.sigmoid is 1 / (1 + exp(-g)) in f32)
__device__ __forceinline__ uint32_t swiglu2(uint32_t gw, uint32_t uw) {
  const float2 gf = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&gw));
  const float2 uf = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&uw));
  const float s0 = 1.f / (1.f + expf(-gf.x)), s1 = 1.f / (1.f + expf(-gf.y));
  return pack_bf16((gf.x * s0) * uf.x, (gf.y * s1) * uf.y);
}

// silu(gf) * uf of one int32 pair dequantized by its channel scales, in
// f32 as swiglu2 computes it
__device__ __forceinline__ float dswiglu(int g, int u, float gs, float us) {
  const float gf = (float)g * gs, uf = (float)u * us;
  return (gf * (1.f / (1.f + expf(-gf)))) * uf;
}

// four int32 pairs at channels 4 c .. 4 c + 3 into two bf16 words
__device__ __forceinline__ uint2 dswiglu4(int4 g, int4 u, float4 gs, float4 us) {
  return make_uint2(
      pack_bf16(dswiglu(g.x, u.x, gs.x, us.x), dswiglu(g.y, u.y, gs.y, us.y)),
      pack_bf16(dswiglu(g.z, u.z, gs.z, us.z), dswiglu(g.w, u.w, gs.w, us.w)));
}

// the tail kernel's input: x = g (bf16), x = bf16(silu(g) * u) (bf16 g, u:
// the fused tail) or x = bf16(silu(g * gs) * (u * us)) (int32 g, u)
enum TailIn { kInX = 0, kInSwiglu = 1, kInDequant = 2 };

template <int kIn>
__global__ void __launch_bounds__(TL_THREADS, 2)
    tail_kernel(const void* __restrict__ g, const void* __restrict__ u,
                int ldg_, int ldu_, const float* __restrict__ gs,
                const float* __restrict__ us, int K,
                const __nv_bfloat16* __restrict__ A,   // (TL_KP, TL_KP)
                const __nv_bfloat16* __restrict__ Bt,  // (TL_M, TL_M), B^T
                const float* __restrict__ scale, int qmin, int qmax,
                int8_t* __restrict__ out) {
  __shared__ __align__(16) __nv_bfloat16 Xs[TL_KP][TL_LD];
  const long row = blockIdx.x;
  const int n = K * TL_M;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int n0 = warp * 16;  // this warp's output columns n0 .. n0 + 15

  // 1. x into rows 0..K-1 (8 elements a step), zeros into the pad rows
  for (int v = tid; v < n / 8; v += TL_THREADS) {
    uint4 o;
    if constexpr (kIn == kInDequant) {
      const int4* gr =
          reinterpret_cast<const int4*>(static_cast<const int*>(g) +
                                        row * ldg_) + 2 * v;
      const int4* ur =
          reinterpret_cast<const int4*>(static_cast<const int*>(u) +
                                        row * ldu_) + 2 * v;
      const float4* gsv = reinterpret_cast<const float4*>(gs) + 2 * v;
      const float4* usv = reinterpret_cast<const float4*>(us) + 2 * v;
      const uint2 a = dswiglu4(__ldg(gr), __ldg(ur), __ldg(gsv), __ldg(usv));
      const uint2 b = dswiglu4(__ldg(gr + 1), __ldg(ur + 1), __ldg(gsv + 1),
                               __ldg(usv + 1));
      o = make_uint4(a.x, a.y, b.x, b.y);
    } else {
      const uint4* gr = reinterpret_cast<const uint4*>(
          static_cast<const __nv_bfloat16*>(g) + row * ldg_);
      o = __ldg(gr + v);
      if constexpr (kIn == kInSwiglu) {
        const uint4* ur = reinterpret_cast<const uint4*>(
            static_cast<const __nv_bfloat16*>(u) + row * ldu_);
        const uint4 uv = __ldg(ur + v);
        o = make_uint4(swiglu2(o.x, uv.x), swiglu2(o.y, uv.y),
                       swiglu2(o.z, uv.z), swiglu2(o.w, uv.w));
      }
    }
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
          const int q0 = quant8(acc[mt][nt][2 * h], inv, qmin, qmax);
          const int q1 = quant8(acc[mt][nt][2 * h + 1], inv, qmin, qmax);
          *reinterpret_cast<uint16_t*>(Qs + r * TL_M + c) =
              (uint16_t)((q0 & 0xFF) | ((q1 & 0xFF) << 8));
        }
      }
  __syncthreads();
  int8_t* orow = out + row * n;
  for (int v = tid; v < n / 16; v += TL_THREADS)
    reinterpret_cast<uint4*>(orow)[v] = reinterpret_cast<const uint4*>(Qs)[v];
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

// one butterfly stage across lanes: element i meets i ^ (4 * mask); the
// lower one keeps the sum, the upper one the difference
__device__ __forceinline__ float bfly(float v, int mask, bool upper) {
  const float p = __shfl_xor_sync(0xffffffffu, v, mask);
  return upper ? p - v : v + p;
}

template <typename T>
__global__ void __launch_bounds__(FW_THREADS, 2)
    fwht_kernel(const T* __restrict__ x, int ldx, int K,
                const float* __restrict__ At,  // (K, TL_KP): A^T, zero-padded
                float hm, T* __restrict__ out) {
  extern __shared__ float4 Ys4[];  // Y1 (K, 128) f32
  const long row = blockIdx.x;
  const int n = K * TL_M;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* xr = x + row * ldx;

  // 1. Y1 = X . H_128 / sqrt(128), one 128-wide sub-row per warp at a time;
  //    lane holds elements 4 lane .. 4 lane + 3 (index bits 0-1 in the lane,
  //    bits 2-6 across lanes); Sylvester order, as hadamard_matrix(128)
  for (int l = warp; l < K; l += FW_THREADS / 32) {
    const float4 v = load4(xr + l * TL_M + 4 * lane);
    const float a0 = v.x + v.y, a1 = v.x - v.y;  // h = 1
    const float a2 = v.z + v.w, a3 = v.z - v.w;
    float e0 = a0 + a2, e1 = a1 + a3, e2 = a0 - a2, e3 = a1 - a3;  // h = 2
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {  // h = 4 .. 64
      const bool up = lane & s;
      e0 = bfly(e0, s, up);
      e1 = bfly(e1, s, up);
      e2 = bfly(e2, s, up);
      e3 = bfly(e3, s, up);
    }
    Ys4[l * (TL_M / 4) + lane] = make_float4(e0 * hm, e1 * hm, e2 * hm, e3 * hm);
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
  T* orow = out + row * n;
#pragma unroll
  for (int i = 0; i < FW_ROWS; ++i)
    if (k0 + i < K)
      store4(orow + (k0 + i) * TL_M + 4 * lane,
             make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
}

template <typename T>
int launch_fwht(const void* x, int ldx, const void* At, float hm, void* out,
                int T_, int K, cudaStream_t stream) {
  static bool sized = false;  // above 48 KB only after the attribute is set
  const int smem = TL_KP * TL_M * (int)sizeof(float);
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        fwht_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  fwht_kernel<T><<<T_, FW_THREADS, K * TL_M * (int)sizeof(float), stream>>>(
      (const T*)x, ldx, K, (const float*)At, hm, (T*)out);
  return (int)cudaGetLastError();
}

bool bad_range(int qmin, int qmax) {
  return qmin < -128 || qmin > qmax || qmax > 127;
}

template <int kIn>
int launch_tail(const void* g, const void* u, int ldg, int ldu, const void* gs,
                const void* us, const void* A, const void* Bt,
                const void* scale, void* out, int T, int K, int qmin,
                int qmax, void* stream) {
  if (K < 1 || K > TL_KP || T < 1 || bad_range(qmin, qmax))
    return (int)cudaErrorInvalidValue;
  tail_kernel<kIn><<<T, TL_THREADS, 0, (cudaStream_t)stream>>>(
      g, u, ldg, ldu, (const float*)gs, (const float*)us, K,
      (const __nv_bfloat16*)A, (const __nv_bfloat16*)Bt, (const float*)scale,
      qmin, qmax, (int8_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (T, K * 128) int8 = clip(round((A (x) H_128) . (silu(g) * u) / scale),
// qmin, qmax). g, u: (T, K * 128) bf16 rows at strides ldg / ldu (elements;
// rows 16-byte aligned). A: (160, 160) bf16, hadK zero-padded; Bt: (128, 128)
// bf16, the transposed H_128 / sqrt(128); scale: one f32 on the device.
// K <= 160; -128 <= qmin <= qmax <= 127.
int mq_fused_swiglu_had_quant(const void* g, const void* u, int ldg, int ldu,
                              const void* A, const void* Bt, const void* scale,
                              void* out, int T, int K, int qmin, int qmax,
                              void* stream) {
  return launch_tail<kInSwiglu>(g, u, ldg, ldu, nullptr, nullptr, A, Bt, scale,
                                out, T, K, qmin, qmax, stream);
}

// out (T, K * 128) int8 = clip(round((A (x) H_128) . x / scale), qmin, qmax);
// x: (T, K * 128) bf16 rows at stride ldx; A, Bt, scale, K, qmin, qmax as
// above.
int mq_had_quant(const void* x, int ldx, const void* A, const void* Bt,
                 const void* scale, void* out, int T, int K, int qmin,
                 int qmax, void* stream) {
  return launch_tail<kInX>(x, x, ldx, ldx, nullptr, nullptr, A, Bt, scale, out,
                           T, K, qmin, qmax, stream);
}

// out (T, K * 128) int8 = clip(round((A (x) H_128) . x / scale), qmin, qmax)
// with x = bf16(silu(g * gs) * (u * us)) in f32; g, u: (T, K * 128) int32
// rows at strides ldg / ldu (elements; rows 16-byte aligned); gs, us: (K *
// 128,) f32; A, Bt, scale, K, qmin, qmax as above.
int mq_dequant_swiglu_had_quant(const void* g, const void* u, int ldg, int ldu,
                                const void* gs, const void* us, const void* A,
                                const void* Bt, const void* scale, void* out,
                                int T, int K, int qmin, int qmax,
                                void* stream) {
  return launch_tail<kInDequant>(g, u, ldg, ldu, gs, us, A, Bt, scale, out, T,
                                 K, qmin, qmax, stream);
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

// out (T, K * 128) = (A (x) H_128) . x in f32, stored as x's type (is_f32:
// f32, else bf16); x rows at stride ldx (16-byte aligned); At: (K, 160) f32,
// A^T zero-padded; hm: the f32 entry 1 / sqrt(128) of H_128 / sqrt(128).
int mq_fwht(const void* x, int ldx, const void* At, float hm, void* out,
            int T, int K, int is_f32, void* stream) {
  if (K < 1 || K > TL_KP || T < 1) return (int)cudaErrorInvalidValue;
  return is_f32 ? launch_fwht<float>(x, ldx, At, hm, out, T, K,
                                     (cudaStream_t)stream)
                : launch_fwht<__nv_bfloat16>(x, ldx, At, hm, out, T, K,
                                             (cudaStream_t)stream);
}

}  // extern "C"
