// Real-integer quantized matmuls for the W4A8 / W8A8 serving path on Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// mquant_tpu_torch/kernels/_build.py.
//
// K1  w4a8_gemv  replaces mquant_tpu/kernels/qmm.py::_qmm_pallas_w4_stacked
//                and the M<=32 branch of _qmm_pallas_w4 (bodies
//                _qmm_w4_kernel_nok / _qmm_w4_kernel). Decode GEMV on
//                split-half packed int4 weights: byte row r of the (K/2, N)
//                matrix holds weight row r in its low nibble and row r+K/2 in
//                its high nibble. One launch (gemv_tc_kernel): TMA streams W,
//                mma.sync s8 on the tensor cores reads it once for any
//                M <= 32, the K splits of a channel tile meet through a
//                thread block cluster's distributed shared memory.
// K2  int8_gemv  replaces qmm.py::_qmm_pallas_gemv (_gemv_kernel): the same
//                GEMV on int8 (K, N) weights (the int8 lm_head, the RMS
//                split's K = 18943 `down`, the engine's 8-row pool step):
//                K1's one launch with the int8 bytes as the A fragments, W
//                read once for any M <= 32, any K and any N.
// K3  int8_gemm  replaces the M>32 branch of qmm.py::_qmm_pallas_w4
//                (_qmm_w4_kernel with its k accumulator) and the XLA s8 dots
//                it stood beside: int8 x int8 -> int32 GEMM on W4 packed or
//                W8 weights with the per-token x per-channel dequant fused.
// K12 w8_bf16_gemv  replaces scripts/gemv_bench.py::w8_bf16_gemv_pallas
//                (pl.pallas_call at :70): y = bf16((x . bf16(W)) * w_scale)
//                for bf16 x (M <= 8, K) and int8 W (K, N), f32 sums: K1's
//                one-launch design with the products in bf16 on the tensor
//                cores (w8_bf16_tc_kernel).
// K13 w4_unpack_gemv  replaces scripts/w4_unpack_tune.py::pallas_gemv with
//                its kernels P0-P3 (:72-107, pl.pallas_call at :115): the
//                packed-W4 GEMV to int32 with the nibbles unpacked three
//                ways (P1 i32 mask / select, P2 int8 shifts, P3 i32 shifts)
//                and P0, x_lo . int8(packed bytes) without an unpack (the
//                probe's bound on the packed stream, not the W4 product).
//                K1's one-launch tensor-core GEMV (gemv_tc_kernel) with the
//                unpack as a template parameter: the TMA ring, the mma.sync
//                products, the cluster K-split and the plan are K1's, so
//                the probe weighs each unpack in front of a tensor-core
//                product that reads W once (P0: the packed bytes are the
//                low plane's A fragments, the high plane's products are
//                skipped).
//
// What bounds them on an H100. The GEMVs stream the weight once per call:
// 0.5 B per weight (K1) or 1 B (K2) against ~3.35 TB/s of HBM; the x rows
// are a few KB and stay in L1/L2. K1 and K2 read each weight byte once (a
// TMA box where W's rows are a TMA stride, else 8-byte cp.async or words
// the producer's lanes shift into place) and put the products on the
// tensor cores (mma.sync with the token rows as the n8 side), so neither
// the integer pipe nor M moves the byte count; narrow-N sites (N = 3584)
// split K across the blocks of a cluster so every SM has a slice of the
// stream, and the splits meet in distributed shared memory (no workspace,
// no atomics); K13 is K1 with another unpack.
// The GEMM at prefill (M = 1024) is bound by int8 tensor-core throughput.
// K3's main kernel is Hopper-native (gemm_tma_kernel): TMA loads of x and
// the raw W tile through an mbarrier ring, wgmma with W^T built in
// registers (nibbles unpacked there, so no int8 copy of a W4 weight ever
// exists in device memory). It takes any K on int8 weights (the RMS split's
// K = 18943: TMA zero-fills W's rows and x's columns at and past K, so the
// last k step adds nothing), with x read at its own row stride, a multiple
// of 16. Shapes outside TMA's 16-byte stride contract (any N, packed W4
// with (K/2) % 16 != 0: the lm_heads of N = 92553 and 151666) run the same
// kernel with W's tile written by threads instead of TMA (the ragged kernel,
// mq_int8_gemm_ragged).
//
// Epilogue (K1-K3): y = (float(acc) * x_scale[m]) * w_scale[n], then
// rounded to the output type, the order of qmm.py:549/:577.
//
// Any K (K2 and K3 on int8 weights; K3 on packed W4 with K even): the RMS
// split stores 18943 int8 rows of `down`, as the JAX package writes them. The
// TMA GEMM leaves the K tail to TMA's zero fill (above). In the GEMVs the
// weight's rows past K are zero-filled in the ring, and the TAIL
// instantiations read activation rows that are not 4-byte aligned (a K that
// is no multiple of 4, an unaligned base) as aligned words shifted into
// place, zero past the last row, so the int32 sums stay exact and no byte
// outside a tensor is read. The host picks them only for such shapes:
// aligned shapes run the plain word loads.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// K1 / K2 / K13: the GEMVs' unpacks, M <= 32
// ---------------------------------------------------------------------------

// The unpacks of the tensor-core GEMV (gemv_tc_kernel's template
// parameter U): kSigned, the served W4 one (unpack_signed: eight word
// operations for 8 nibbles); kP1 .. kP3 (K13), the probe's three, byte by
// byte (unpack_probe); kP0 (K13), none: x[m, :K/2] . int8(packed bytes);
// kI8 (K2), none on int8 weights: x[m, :K] . W over all K rows. The P
// values are the probe's variant numbers, which chip_smoke.py's SASS report
// looks for in the template arguments.
enum GemvUnpack { kP0 = 0, kP1 = 1, kP2 = 2, kP3 = 3, kSigned = 4, kI8 = 5 };

// How the GEMV's producer warp fills a stage of W (template parameter WL):
// one TMA box where W's rows are a legal TMA stride (N % 16 == 0, a 16-byte
// aligned base); 8-byte cp.async per lane where they are 8-byte aligned
// (N % 8 == 0); otherwise its 32 lanes write the tile from aligned words
// shifted into place (load_gemv_words / store_gemv_words), any N and any
// base.
enum GemvWLoad { kTmaW = 0, kCpAsyncW = 1, kThreadW = 2 };

// The signed nibbles of the 4 packed bytes of w as the probe's three unpacks
// compute them (w4_unpack_tune.py:52-69), each byte alone; lo / hi receive
// the low / high nibbles as 4 signed bytes.
template <int U>
__device__ __forceinline__ void unpack_probe(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
  lo = hi = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int l, h;
    if constexpr (U == kP1) {  // i32 masks, then x >= 8 ? x - 16 : x
      const int b = (int)((w >> (8 * j)) & 0xFFu);
      l = b & 15;
      h = (b >> 4) & 15;
      l = l >= 8 ? l - 16 : l;
      h = h >= 8 ? h - 16 : h;
    } else if constexpr (U == kP2) {  // int8 arithmetic shifts
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

// unpack U of one packed word (U != kP0)
template <int U>
__device__ __forceinline__ void unpack_w4(uint32_t w, uint32_t& lo,
                                          uint32_t& hi) {
  if constexpr (U == kSigned)
    unpack_signed(w, lo, hi);
  else
    unpack_probe<U>(w, lo, hi);
}

// d (16 x 8 s32) += a (16 x 32 s8) . b (32 x 8 s8), mma.sync
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------------------
// K3 on Hopper: TMA + wgmma, the operands swapped
// ---------------------------------------------------------------------------
//
// Integer wgmma (s8 x s8 -> s32) takes only K-major operands, and W's rows
// are N-contiguous, so W cannot be wgmma's B. The tile is computed
// transposed, out^T (channels x tokens) = W^T x^T: A = W^T is built in
// registers from the raw W tile (TMA copies W's bytes unchanged into shared
// memory; each thread reads 4 rows x 4 channels as four words, unpacks the
// nibbles for W4 and transposes the 4x4 bytes with prmt), and B = x^T is the
// x tile, whose rows are K-contiguous: K-major, as TMA stores it. wgmma reads
// A from registers (the RS form) and B from shared memory.
//
// Block: 128 channels x 2 NT tokens (NT = 64 or 128, the host picks);
// warpgroups 0 and 1 each own NT tokens and all 128 channels (two m64nNTk32
// tiles), warpgroup 2 is the producer: in the served kernel one thread of
// it issues TMA for W and x.
// A thread of warp w, lane (g, t) holds channels 4c..4c+3, c = 8w + g: tile
// 0's rows g and g+8 are channels 4c and 4c+1, tile 1's are 4c+2 and 4c+3,
// so the epilogue writes 4 neighbouring channels of a token at once. A
// stage is 128 W rows (16 KB; W4: 128 packed rows) and 128 k columns of
// the block's x rows (W4: the low-plane and the high-plane columns); as
// many stages as fit in 192 KB are in flight (2-6). A k32 step's A
// fragments are built while the previous step's products run. K, N and M
// need not be multiples of the tile: TMA zero-fills outside the tensors (W
// rows past K or K/2 are zero, and so are x's columns past K: a k step that
// runs past K adds nothing, and the int32 sums stay exact for any K) and the
// epilogue stores only m < M, n < N. TMA's contract: 16-byte aligned bases
// and row strides (x's stride ldx and N multiples of 16, W4: (K/2) % 16).
//
// The ragged kernel (mq_int8_gemm_ragged) is the same kernel for every
// other shape: x keeps TMA (its rows padded to a 16-byte stride by the
// host), and W's rows, at a stride TMA cannot address, are written into the
// same swizzled tile by the 128 threads of warpgroup 2 (template parameter
// RAGGED), zero past R rows and N channels: the aligned words that hold a
// row's bytes are loaded into registers and shifted into place across the
// row's misalignment (a thread's 16-byte chunk of a row from 4 loaded words
// and the neighbouring lane's first) and stored as 16 bytes; for W8 the next
// stage's words are loaded before the slot of this stage's is waited for
// (two stages in flight: the producer takes 120 registers, the consumers
// 192; W4, whose consumers need 208, keeps one). At N % 4 == 0 this was as
// fast as 4-byte cp.async of each word in place (PERF.md, Findings). Each
// producer thread arrives on the stage's full barrier after its stores (129
// arrivals: 128 and the x load's expect-tx).
// A TMA box must start on 16 bytes of x's row: for W4 with (K/2) % 16 != 0
// the host writes the two planes 16-byte aligned (the high one from column
// H = K/2 rounded up to 16, kernel argument hoff); where a low-plane box
// runs past K/2 it reads the pad or the high plane's columns, which meet
// the zero rows past K/2. Where N breaks the 4-channel vector store the
// epilogue stores channel by channel.

constexpr int TG_BM = 128;  // channels per block
constexpr int TG_BK = 128;  // x columns (bytes) per stage; W rows per stage
constexpr int TG_WTILE = TG_BK * TG_BM;  // bytes of the W tile of a stage
constexpr int TG_THREADS = 384;

// NT tokens per consumer warpgroup (64 or 128): the block covers 2 * NT
template <bool W4, int NT>
struct TmaGemmCfg {
  static constexpr int kXTile = 2 * NT * TG_BK;  // x tile of a stage
  static constexpr int kXBytes = (W4 ? 2 : 1) * kXTile;
  static constexpr int kStageBytes = TG_WTILE + kXBytes;
  static constexpr int kStages = (192 * 1024) / kStageBytes;
  static constexpr int kSmem = kStages * kStageBytes + 1024 + 2 * 8 * kStages;
};

// d += A (64 x 32, registers) . B (32 x N, descriptor), s8 x s8 -> s32,
// N = 64 or 128 (the accumulator's size picks the shape)
__device__ __forceinline__ void wgmma_s8(int (&d)[32], const uint32_t a[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], const uint32_t a[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// the four A-fragment words of k32 step kk for this thread's channels:
// rows kk*32 + 4q + i (q = t, t + 4; i = 0..3) at byte 4c of the swizzled
// W tile (row r's 16-byte chunk j sits at chunk j ^ (r % 8))
__device__ __forceinline__ void load_w_quads(const uint8_t* wt, int kk, int c,
                                             int t, uint32_t rows[2][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = kk * 32 + 4 * (t + 4 * h) + i;
      const int off = r * 128 + (((c >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2);
      rows[h][i] = *reinterpret_cast<const uint32_t*>(wt + off);
    }
}

// A fragments of the two m64 tiles from the row words: tile j's rows g /
// g+8 are channels 4c + 2j / 4c + 2j + 1; registers 0/1 hold k quad t,
// 2/3 k quad t + 4
__device__ __forceinline__ void frags_from_rows(uint32_t rows[2][4],
                                                uint32_t a0[4],
                                                uint32_t a1[4]) {
  uint32_t c0[4], c1[4];
  transpose4x4(rows[0], c0);
  transpose4x4(rows[1], c1);
  a0[0] = c0[0];
  a0[1] = c0[1];
  a0[2] = c1[0];
  a0[3] = c1[1];
  a1[0] = c0[2];
  a1[1] = c0[3];
  a1[2] = c1[2];
  a1[3] = c1[3];
}

// both tiles' A fragments of k32 step kk (W4: the low plane in a, the high
// plane in h)
template <bool W4>
__device__ __forceinline__ void build_frags(const uint8_t* wt, int kk, int c,
                                            int t, uint32_t a[2][4],
                                            uint32_t h[2][4]) {
  uint32_t rows[2][4];
  load_w_quads(wt, kk, c, t, rows);
  if constexpr (W4) {
    uint32_t lo[2][4], hi[2][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) unpack_signed(rows[q][i], lo[q][i], hi[q][i]);
    frags_from_rows(lo, a[0], a[1]);
    frags_from_rows(hi, h[0], h[1]);
  } else {
    frags_from_rows(rows, a[0], a[1]);
  }
}

// keeps fragments in their registers up to this point (a product that
// reads them may still be running before it)
template <bool W4>
__device__ __forceinline__ void fence_frags(uint32_t a[2][4],
                                            uint32_t h[2][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hopper::reg_fence(a[j][i]);
      if constexpr (W4) hopper::reg_fence(h[j][i]);
    }
}

// The ragged kernel's W tile of one stage: rows [r0, r0 + 128) x channels
// [ch0, ch0 + 128) of the (R, N) int8 matrix w in the swizzled tile wt, zero
// past R rows and N channels; rows start at any byte. Producer thread (warp
// pw, lane l) owns the 16-byte chunk j = l % 8 of rows 4 pw + l / 8 + 16 i
// (i = 0..7), so a warp reads 4 tile rows (128 contiguous bytes each) per
// instruction: it loads the 4 aligned words that start sh = (row address)
// % 4 bytes before the chunk (the fifth word is the next lane's first; lane
// j = 7 loads it itself), zero where a word holds no byte of a row below R
// at a column below N ...
struct WordChunks {
  uint32_t v[8][4], e[8];
};

__device__ __forceinline__ void load_w_words(WordChunks& wc,
                                             const int8_t* __restrict__ w,
                                             int R, int N, int r0, int ch0,
                                             int pw, int lane) {
  const int j = lane & 7, c = ch0 + 16 * j;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = r0 + 4 * pw + (lane >> 3) + 16 * i;
    const uintptr_t p = reinterpret_cast<uintptr_t>(w + (long)gr * N + c);
    const int sh = (int)(p & 3);
    const uint32_t* a = reinterpret_cast<const uint32_t*>(p - sh);
    const bool row = gr < R;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      wc.v[i][q] = row && c + 4 * q - sh < N ? __ldg(a + q) : 0u;
    wc.e[i] = j == 7 && row && sh && c + 16 - sh < N ? __ldg(a + 4) : 0u;
  }
}

// ... and, once the slot is free, shifts each word into place (its bytes
// and the next word's), clears the bytes at or past column N and stores
// the chunk (one 16-byte store into the swizzled tile)
__device__ __forceinline__ void store_w_words(uint8_t* wt,
                                              const WordChunks& wc,
                                              const int8_t* __restrict__ w,
                                              int N, int r0, int ch0, int pw,
                                              int lane) {
  const int j = lane & 7, c = ch0 + 16 * j;
  uint32_t keep[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int n = N - (c + 4 * q);  // the word's channels below N
    keep[q] = n >= 4 ? ~0u : n <= 0 ? 0u : (1u << (8 * n)) - 1u;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = 4 * pw + (lane >> 3) + 16 * i;
    const int sh = (int)(reinterpret_cast<uintptr_t>(
                             w + (long)(r0 + r) * N + c) & 3);
    uint32_t next = __shfl_down_sync(0xffffffffu, wc.v[i][0], 1);
    if (j == 7) next = wc.e[i];
    uint4 o;
    o.x = __funnelshift_r(wc.v[i][0], wc.v[i][1], 8 * sh) & keep[0];
    o.y = __funnelshift_r(wc.v[i][1], wc.v[i][2], 8 * sh) & keep[1];
    o.z = __funnelshift_r(wc.v[i][2], wc.v[i][3], 8 * sh) & keep[2];
    o.w = __funnelshift_r(wc.v[i][3], next, 8 * sh) & keep[3];
    *reinterpret_cast<uint4*>(wt + r * 128 + ((j ^ (r & 7)) << 4)) = o;
  }
}

template <bool W4, int NT, bool RAGGED>
__global__ void __launch_bounds__(TG_THREADS, 1)
    gemm_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const int8_t* __restrict__ w, int M, int K, int N,
                    int hoff, const float* __restrict__ xs,
                    const float* __restrict__ wsc, void* out, int out_kind) {
  using Cfg = TmaGemmCfg<W4, NT>;
  constexpr int S = Cfg::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * Cfg::kStageBytes);
  uint64_t* empty = full + S;
  const int tok0 = blockIdx.x * 2 * NT, ch0 = blockIdx.y * TG_BM;
  const int K2 = K / 2;
  const int steps = ((W4 ? K2 : K) + TG_BK - 1) / TG_BK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      // TMA: the one expect-tx arrival; ragged: and one per producer thread
      hopper::mbar_init(&full[i], RAGGED ? 129 : 1);
      hopper::mbar_init(&empty[i], 2);  // one arrival per consumer warpgroup
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer warpgroup
    if constexpr (!RAGGED) {  // one thread issues TMA for W and x
      hopper::setmaxnreg_dec<40>();
      if (threadIdx.x == 256) {
        hopper::prefetch_map(&xmap);
        hopper::prefetch_map(&wmap);
        // x is read by every channel tile; a W tile by the few token tiles
        // that run beside it (the grid walks tokens fastest)
        const uint64_t keep = hopper::policy_evict_last();
        const uint64_t once = hopper::policy_evict_first();
        for (int s = 0; s < steps; ++s) {
          const int slot = s % S;
          hopper::mbar_wait(&empty[slot], ((s / S) & 1) ^ 1);
          uint8_t* st = smem + slot * Cfg::kStageBytes;
          hopper::mbar_arrive_expect_tx(&full[slot], Cfg::kStageBytes);
          const int r0 = s * TG_BK;
          hopper::tma_load_2d(st, &wmap, &full[slot], ch0, r0, once);
          hopper::tma_load_2d(st + TG_WTILE, &xmap, &full[slot], r0, tok0,
                              keep);
          if (W4)
            hopper::tma_load_2d(st + TG_WTILE + Cfg::kXTile, &xmap,
                                &full[slot], hoff + r0, tok0, keep);
        }
      }
    } else {  // ragged: one thread issues x's TMA, all 128 write W's tile
      // W8: the word producer holds two stages of loads
      if constexpr (W4)
        hopper::setmaxnreg_dec<88>();
      else
        hopper::setmaxnreg_dec<120>();
      const int pt = threadIdx.x - 256, pw = pt >> 5, lane = pt & 31;
      const int R = W4 ? K2 : K;
      if (pt == 0) hopper::prefetch_map(&xmap);
      const uint64_t keep = hopper::policy_evict_last();
      WordChunks cur, nxt;
      load_w_words(cur, w, R, N, 0, ch0, pw, lane);
      for (int s = 0; s < steps; ++s) {
        const int slot = s % S;
        const int r0 = s * TG_BK;
        // W8: the next stage's words are loaded before this stage's slot is
        // waited for
        if constexpr (!W4)
          if (s + 1 < steps)
            load_w_words(nxt, w, R, N, r0 + TG_BK, ch0, pw, lane);
        hopper::mbar_wait(&empty[slot], ((s / S) & 1) ^ 1);
        uint8_t* st = smem + slot * Cfg::kStageBytes;
        if (pt == 0) {
          hopper::mbar_arrive_expect_tx(&full[slot], Cfg::kXBytes);
          hopper::tma_load_2d(st + TG_WTILE, &xmap, &full[slot], r0, tok0,
                              keep);
          if (W4)
            hopper::tma_load_2d(st + TG_WTILE + Cfg::kXTile, &xmap,
                                &full[slot], hoff + r0, tok0, keep);
        }
        store_w_words(st, cur, w, N, r0, ch0, pw, lane);
        hopper::mbar_arrive(&full[slot]);
        if constexpr (W4) {
          if (s + 1 < steps)
            load_w_words(cur, w, R, N, r0 + TG_BK, ch0, pw, lane);
        } else {
          cur = nxt;
        }
      }
    }
    return;
  }

  // consumer warpgroups
  // the block holds 384 x 168 registers: 2 x 128 x C + 128 x P of them
  if constexpr (!RAGGED)
    hopper::setmaxnreg_inc<232>();
  else if constexpr (W4)
    hopper::setmaxnreg_inc<208>();
  else
    hopper::setmaxnreg_inc<192>();
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int c = 8 * warp + g;
  constexpr int NR = NT / 2;  // accumulator registers of one m64 tile
  int acc0[NR], acc1[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) acc0[i] = acc1[i] = 0;

  // A fragments of two k32 steps: step kk's are built while step kk - 1's
  // products run, in the other buffer
  uint32_t a[2][2][4], h[2][2][4];
  for (int s = 0; s < steps; ++s) {
    const int slot = s % S;
    hopper::mbar_wait(&full[slot], (s / S) & 1);
    const uint8_t* st = smem + slot * Cfg::kStageBytes;
    // this warpgroup's NT token rows of the x tile(s), NT / 8 swizzle atoms
    const uint8_t* xb = st + TG_WTILE + wg * NT * 128;
    build_frags<W4>(st, 0, c, t, a[0], h[0]);
#pragma unroll
    for (int kk = 0; kk < TG_BK / 32; ++kk) {
      const int cur = kk & 1;
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        hopper::reg_fence(acc0[i]);
        hopper::reg_fence(acc1[i]);
      }
      hopper::wgmma_fence();
      const uint64_t db = hopper::desc_sw128(xb + kk * 32, 16, 1024);
      wgmma_s8(acc0, a[cur][0], db);
      wgmma_s8(acc1, a[cur][1], db);
      if constexpr (W4) {
        const uint64_t dh =
            hopper::desc_sw128(xb + Cfg::kXTile + kk * 32, 16, 1024);
        wgmma_s8(acc0, h[cur][0], dh);
        wgmma_s8(acc1, h[cur][1], dh);
      }
      hopper::wgmma_commit();
      // step kk - 1's products are done: its fragments end their life here,
      // and the buffer takes step kk + 1's
      hopper::wgmma_wait<1>();
      fence_frags<W4>(a[cur ^ 1], h[cur ^ 1]);
      if (kk + 1 < TG_BK / 32)
        build_frags<W4>(st, kk + 1, c, t, a[cur ^ 1], h[cur ^ 1]);
    }
    hopper::wgmma_wait<0>();
    fence_frags<W4>(a[(TG_BK / 32 - 1) & 1], h[(TG_BK / 32 - 1) & 1]);
    // every thread of the warpgroup has issued its last product on this
    // stage (wgmma is warpgroup-wide) and waited for it
    if (tid == 0) hopper::mbar_arrive(&empty[slot]);
  }
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    hopper::reg_fence(acc0[i]);
    hopper::reg_fence(acc1[i]);
  }

  // accumulator d[i] of an m64nNT tile: token (i / 4) * 8 + 2t + (i & 1) of
  // the warpgroup's NT, row g (i % 4 < 2) or g + 8
  const int n0 = ch0 + 4 * c;
  if (n0 >= N) return;
  if (RAGGED && N % 4) {  // rows of no 4-channel alignment: one by one
    const int nv = min(4, N - n0);
#pragma unroll
    for (int nb = 0; nb < NT / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = tok0 + wg * NT + nb * 8 + 2 * t + e;
        if (m >= M) continue;
        const int v[4] = {acc0[nb * 4 + e], acc0[nb * 4 + 2 + e],
                          acc1[nb * 4 + e], acc1[nb * 4 + 2 + e]};
        const float x = out_kind == 2 ? 0.f : xs[m];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q < nv)
            store_out(out, out_kind, (long)m * N + n0 + q, v[q], x,
                      out_kind == 2 ? 0.f : wsc[n0 + q]);
      }
    return;
  }
  const float4 wv = make_float4(wsc[n0], wsc[n0 + 1], wsc[n0 + 2],
                                wsc[n0 + 3]);
#pragma unroll
  for (int nb = 0; nb < NT / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = tok0 + wg * NT + nb * 8 + 2 * t + e;
      if (m >= M) continue;
      const int v[4] = {acc0[nb * 4 + e], acc0[nb * 4 + 2 + e],
                        acc1[nb * 4 + e], acc1[nb * 4 + 2 + e]};
      const long idx = (long)m * N + n0;
      if (out_kind == 2) {
        *reinterpret_cast<int4*>(reinterpret_cast<int*>(out) + idx) =
            make_int4(v[0], v[1], v[2], v[3]);
        continue;
      }
      const float x = xs[m];
      const float y0 = (static_cast<float>(v[0]) * x) * wv.x;
      const float y1 = (static_cast<float>(v[1]) * x) * wv.y;
      const float y2 = (static_cast<float>(v[2]) * x) * wv.z;
      const float y3 = (static_cast<float>(v[3]) * x) * wv.w;
      if (out_kind == 1) {
        *reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + idx) =
            make_float4(y0, y1, y2, y3);
      } else {
        __nv_bfloat162 p0 = __floats2bfloat162_rn(y0, y1);
        __nv_bfloat162 p1 = __floats2bfloat162_rn(y2, y3);
        uint2 u;
        u.x = *reinterpret_cast<uint32_t*>(&p0);
        u.y = *reinterpret_cast<uint32_t*>(&p1);
        *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(out) +
                                  idx) = u;
      }
    }
}

// One launch of gemm_tma_kernel<W4, NT, RAGGED>
// (x's row holds its columns [0, xcols); W4: the high plane from column
// hoff)
template <bool W4, int NT, bool RAGGED>
int launch_gemm_tma(const void* x, int ldx, int xcols, int hoff,
                    const void* w, const void* xs, const void* wsc, void* out,
                    int M, int K, int N, int out_kind, cudaStream_t stream) {
  using Cfg = TmaGemmCfg<W4, NT>;
  CUtensorMap xmap, wmap = {};
  const uint64_t xd[2] = {(uint64_t)xcols, (uint64_t)M};
  const uint64_t xst[1] = {(uint64_t)ldx};
  const uint32_t xbox[2] = {TG_BK, 2 * NT};
  int err = hopper::encode_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, x, xd,
                               xst, xbox);
  if (err) return err;
  if (!RAGGED) {
    const uint64_t wd[2] = {(uint64_t)N, (uint64_t)(W4 ? K / 2 : K)};
    const uint64_t wst[1] = {(uint64_t)N};
    const uint32_t wbox[2] = {TG_BM, TG_BK};
    err = hopper::encode_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, wd,
                             wst, wbox);
    if (err) return err;
  }
  static bool attr = false;
  if (!attr) {
    err = (int)cudaFuncSetAttribute(gemm_tma_kernel<W4, NT, RAGGED>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    Cfg::kSmem);
    if (err) return err;
    attr = true;
  }
  dim3 grid((M + 2 * NT - 1) / (2 * NT), (N + TG_BM - 1) / TG_BM);
  gemm_tma_kernel<W4, NT, RAGGED><<<grid, TG_THREADS, Cfg::kSmem, stream>>>(
      xmap, wmap, (const int8_t*)w, M, K, N, hoff, (const float*)xs,
      (const float*)wsc, out, out_kind);
  return (int)cudaGetLastError();
}

// the four instantiations (W4 or W8, 128 or 256 tokens a block) of one
// producer
template <bool RAGGED>
int launch_gemm(const void* x, int ldx, int xcols, int hoff, const void* w,
                const void* xs, const void* wsc, void* out, int M, int K,
                int N, int w4, int out_kind, int tokens, cudaStream_t st) {
  if (tokens == 128)
    return w4 ? launch_gemm_tma<true, 64, RAGGED>(x, ldx, xcols, hoff, w, xs, wsc,
                                              out, M, K, N, out_kind, st)
              : launch_gemm_tma<false, 64, RAGGED>(x, ldx, xcols, hoff, w, xs,
                                               wsc, out, M, K, N, out_kind,
                                               st);
  return w4 ? launch_gemm_tma<true, 128, RAGGED>(x, ldx, xcols, hoff, w, xs, wsc,
                                             out, M, K, N, out_kind, st)
            : launch_gemm_tma<false, 128, RAGGED>(x, ldx, xcols, hoff, w, xs, wsc,
                                              out, M, K, N, out_kind, st);
}

// ---------------------------------------------------------------------------
// K1 / K2 on Hopper: one launch, tensor cores, W read once for any M <= 32
// ---------------------------------------------------------------------------
//
// out^T (channels x tokens) = W^T x^T on mma.sync.m16n8k32 s8, the operands
// swapped as in gemm_tma_kernel: the channels are the 16-row A side, the
// tokens the n8 side, so M <= 8 is one n8 tile and M <= 32 four, and every
// W byte is read from HBM (and, for W4, unpacked) once whatever M is.
// Block: 128 channels x one K split of `rps` weight rows (K/2 packed rows
// of a W4 weight, K int8 rows for K2). Two groups of 4 consumer warps take
// the even and the odd stages; in a group, warp w owns 32 channels (two
// m16 tiles: thread (g, t) holds channels 4c..4c+3, c = 8w + g, as rows
// g / g+8 of tile 0 and tile 1); warp 8 is the producer. A stage is 32
// weight rows x 128 channels (4 KB, 128-byte swizzle), TV_STAGES in flight:
// one TMA box, or for K2 where W's rows are no TMA stride 8-byte cp.async
// (N % 8 == 0) or words written by the producer's lanes (any N, any base;
// GemvWLoad), zero past the weight's rows and N. Per stage a consumer warp
// loads its 4x4-byte quads and transposes them with prmt into A fragments:
// W4 unpacks the signed nibbles first (no 8*sum(x) correction) into the low
// plane (W rows r) and the high plane (W rows K/2 + r); K2's int8 bytes are
// the fragments as they are (kI8, as P0's packed bytes). The B fragments are
// words of x rows (K-contiguous, row stride K), x columns [r, r+32) and for
// W4 [K/2 + r, ...), loaded from global memory (L1 / L2) one stage ahead,
// zero past the split's rows (which a stage may hold) and for tokens >= M.
// The K splits of one channel tile form a thread block cluster (grid.x =
// splits = cluster size <= 8). Each block leaves its int32 partial tile in
// its own shared memory (over the drained stage ring); after a cluster
// barrier every block sums its share of the tile over the cluster's blocks
// through distributed shared memory in rank order, applies store_out's
// epilogue and stores (4 channels at once where N % 4 == 0, else channel by
// channel). No workspace, memset, atomics or second kernel: one launch,
// graph-capturable (one split launches without a cluster). Splits are
// whole 32-row stages. At M = 1 the served W4 unpack takes the product on
// __dp4a instead (dp4a_row: W straight into registers, no TMA): at one
// token row the card streams packed W faster that way (PERF.md, Findings),
// and the K splits still meet through the cluster, in the one launch. The
// unpack is the template parameter U (GemvUnpack): the served kSigned,
// K2's kI8, or one of the probe's P0-P3 (K13), which stay on the tensor
// cores at every M <= 8 and change nothing else but the A fragments'
// arithmetic (P0 skips the high plane's x words and products).
// Contracts: W4 (w4_gemv_map): M <= 32 (K13: 8), K even, N % 16 == 0, W
// 16-byte aligned (TMA's row stride), rps % 32 == 0. K2 (mq_int8_gemv):
// M <= 32, any K >= 1 and N >= 1, any alignment of W and x (x's rows
// contiguous at stride K), rps % 32 == 0.

constexpr int TV_BN = 128;               // channels per block
constexpr int TV_BR = 32;                // packed rows per stage: one k32 step
constexpr int TV_STAGE = TV_BR * TV_BN;  // bytes of a stage (4 KB)
constexpr int TV_STAGES = 8;
constexpr int TV_THREADS = 288;          // 8 consumer warps + the producer
constexpr int TV_MAX_CLUSTER = 8;        // the portable cluster size
constexpr int TV_SMEM = TV_STAGES * TV_STAGE + 1024 + 2 * 8 * TV_STAGES;

// x word base[c .. c+3], zero at or past `limit` (TAIL: any alignment)
template <bool TAIL>
__device__ __forceinline__ uint32_t x_word(const int8_t* base, int c,
                                           int limit) {
  if (TAIL) return load4_tail(base, c, limit);
  return c < limit ? __ldg(reinterpret_cast<const unsigned int*>(base + c))
                   : 0u;
}

// the B fragments of one stage: token tile nb's words of the low plane
// (columns r + 4t, r + 16 + 4t) and, where HI, of the high plane (K/2 + the
// same; zero otherwise)
template <int NB, bool TAIL, bool HI>
__device__ __forceinline__ void load_x_frags(const int8_t* x, int M, int K,
                                             int r, int r_end, int g, int t,
                                             uint32_t (&xb)[NB][2][2]) {
  const int R = K / 2;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int m = nb * 8 + g;
    if (m < M) {
      const int8_t* xr = x + (long)m * K;
      xb[nb][0][0] = x_word<TAIL>(xr, r + 4 * t, r_end);
      xb[nb][0][1] = x_word<TAIL>(xr, r + 16 + 4 * t, r_end);
      xb[nb][1][0] = HI ? x_word<TAIL>(xr + R, r + 4 * t, r_end) : 0u;
      xb[nb][1][1] = HI ? x_word<TAIL>(xr + R, r + 16 + 4 * t, r_end) : 0u;
    } else {
      xb[nb][0][0] = xb[nb][0][1] = xb[nb][1][0] = xb[nb][1][1] = 0u;
    }
  }
}

// The W tile of one stage written by the producer warp's lanes, where W's
// rows lie at a stride neither a TMA box nor 8-byte copies address (N % 8
// != 0, or an unaligned base): rows r0 .. r0 + 31 x channels ch0 .. ch0 +
// 127 of the (R, N) int8 matrix w, zero past R rows and N channels. Lane l
// owns bytes 4l .. 4l + 3 of every row, so one warp instruction reads a
// row's 128 bytes: the aligned word that starts sh = (row address) % 4
// bytes before the lane's chunk, shifted into place with the next lane's
// word, which lane 31 loads itself. load_gemv_words loads a stage's 32
// words a lane (33 in lane 31) before any is used, so their latencies
// overlap, and before the slot is free; store_gemv_words shifts them into
// place. A
// word is read only where it holds a byte of the row's tile below column
// N, so no page outside the tensor's bytes is touched. The chunk goes into
// the swizzled tile (16-byte chunk j of row r at chunk j ^ (r % 8)).
struct GemvWords {
  uint32_t v[32], e[32];
};

__device__ __forceinline__ void load_gemv_words(GemvWords& h,
                                                const int8_t* __restrict__ w,
                                                int R, int N, int r0, int ch0,
                                                int lane) {
  const int c = ch0 + 4 * lane;
  const int tail = min(N, ch0 + 128) - c;  // bytes of the tile from c on
  const int8_t* p = w + (long)r0 * N + c;
#pragma unroll
  for (int i = 0; i < 32; ++i, p += N) {
    const int sh = (int)(reinterpret_cast<uintptr_t>(p) & 3);
    const uint32_t* a = reinterpret_cast<const uint32_t*>(p - sh);
    const bool live = r0 + i < R;
    h.v[i] = live && tail + sh > 0 ? __ldg(a) : 0u;
    h.e[i] = lane == 31 && live && tail + sh > 4 ? __ldg(a + 1) : 0u;
  }
}

__device__ __forceinline__ void store_gemv_words(uint8_t* st,
                                                 const GemvWords& h,
                                                 const int8_t* __restrict__ w,
                                                 int N, int r0, int ch0,
                                                 int lane) {
  const int c = ch0 + 4 * lane;
  const int nv = N - c;  // the chunk's channels below N
  const uint32_t keep = nv >= 4 ? ~0u : nv <= 0 ? 0u : (1u << (8 * nv)) - 1u;
  const int8_t* p = w + (long)r0 * N + c;
#pragma unroll
  for (int i = 0; i < 32; ++i, p += N) {
    const uint32_t sh = (uint32_t)(reinterpret_cast<uintptr_t>(p) & 3);
    uint32_t nxt = __shfl_down_sync(0xffffffffu, h.v[i], 1);
    if (lane == 31) nxt = h.e[i];
    *reinterpret_cast<uint32_t*>(st + i * 128 + (((lane >> 2) ^ (i & 7)) << 4) +
                                 ((lane & 3) << 2)) =
        __funnelshift_r(h.v[i], nxt, 8 * sh) & keep;
  }
}

// the epilogue of 4 neighbouring channels n0..n0+3 of token m
__device__ __forceinline__ void store_out4(void* out, int out_kind, long idx,
                                           int4 v, float x,
                                           const float* __restrict__ wsc,
                                           int n0) {
  if (out_kind == 2) {
    *reinterpret_cast<int4*>(reinterpret_cast<int*>(out) + idx) = v;
    return;
  }
  const float y0 = (static_cast<float>(v.x) * x) * wsc[n0];
  const float y1 = (static_cast<float>(v.y) * x) * wsc[n0 + 1];
  const float y2 = (static_cast<float>(v.z) * x) * wsc[n0 + 2];
  const float y3 = (static_cast<float>(v.w) * x) * wsc[n0 + 3];
  if (out_kind == 1) {
    *reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + idx) =
        make_float4(y0, y1, y2, y3);
  } else {
    __nv_bfloat162 p0 = __floats2bfloat162_rn(y0, y1);
    __nv_bfloat162 p1 = __floats2bfloat162_rn(y2, y3);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&p0);
    u.y = *reinterpret_cast<uint32_t*>(&p1);
    *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(out) + idx) = u;
  }
}

// the epilogue of channels n0..n0+3 of token m, n0 < N: one vector store
// where N % 4 == 0 (every group of 4 inside N, 16-byte aligned rows), else
// each channel below N alone
__device__ __forceinline__ void store_out_any(void* out, int out_kind, int N,
                                              long idx, int4 v, float x,
                                              const float* __restrict__ wsc,
                                              int n0) {
  if ((N & 3) == 0) {
    store_out4(out, out_kind, idx, v, x, wsc, n0);
    return;
  }
  const int a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (n0 + q < N)
      store_out(out, out_kind, idx + q, a[q], x,
                out_kind == 2 ? 0.f : wsc[n0 + q]);
}

// One token row (M = 1, the decode step), where the bytes alone set the
// bound: warps 0-7 stream the block's rows straight into registers with
// 16-byte loads and take the product on __dp4a (biased nibbles, 8 * sum(x)
// taken off), 16 channels x 4 rows a thread a step, as the first W4 kernel
// did; the card streams W faster this way than through the TMA ring when
// each W byte meets one token. The block's partial row lands in red[0..127]
// (rows 1-7 of the tile are not stored), through wred = red + 1024.
template <bool TAIL>
__device__ __forceinline__ void dp4a_row(const int8_t* __restrict__ x, int K,
                                         const int8_t* __restrict__ w, int N,
                                         int ch0, int r_begin, int r_end,
                                         int* red) {
  const int R = K / 2;
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int warp = tid >> 5, lane = tid & 31;
  const int col0 = ch0 + tx * 16;
  int acc[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) acc[c] = 0;
  int xsum = 0;
  if (col0 < N) {
    for (int r = r_begin + ty * 4; r < r_end; r += 32 * 4) {
      uint4 v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = !TAIL || r + i < r_end
                   ? *reinterpret_cast<const uint4*>(w + (long)(r + i) * N +
                                                     col0)
                   : make_uint4(0, 0, 0, 0);
      const int xlo = TAIL ? (int)load4_tail(x, r, r_end)
                           : *reinterpret_cast<const int*>(x + r);
      const int xhi = TAIL ? (int)load4_tail(x + R, r, r_end)
                           : *reinterpret_cast<const int*>(x + R + r);
      xsum = __dp4a(xlo, 0x01010101, xsum);
      xsum = __dp4a(xhi, 0x01010101, xsum);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        uint32_t lo[4], hi[4], loc[4], hic[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint4 q = v[i];
          const uint32_t u =
              (c == 0 ? q.x : c == 1 ? q.y : c == 2 ? q.z : q.w) ^ 0x88888888u;
          lo[i] = u & 0x0F0F0F0Fu;
          hi[i] = (u >> 4) & 0x0F0F0F0Fu;
        }
        transpose4x4(lo, loc);
        transpose4x4(hi, hic);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[c * 4 + j] = __dp4a((int)loc[j], xlo, acc[c * 4 + j]);
          acc[c * 4 + j] = __dp4a((int)hic[j], xhi, acc[c * 4 + j]);
        }
      }
    }
  }
  // the 32 row slices: 4 a warp by shuffles, then the 8 warps
  int* wred = red + 8 * TV_BN;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    int s = acc[c] - 8 * xsum;
    s += __shfl_down_sync(0xffffffffu, s, 16);
    s += __shfl_down_sync(0xffffffffu, s, 8);
    if (lane < 8) wred[warp * TV_BN + lane * 16 + c] = s;
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  if (tid < TV_BN) {
    int s = 0;
#pragma unroll
    for (int wi = 0; wi < 8; ++wi) s += wred[wi * TV_BN + tid];
    red[tid] = s;
  }
}

template <int NB, bool TAIL, int U, int WL>
__global__ void __launch_bounds__(TV_THREADS)
    gemv_tc_kernel(const __grid_constant__ CUtensorMap wmap,
                   const int8_t* __restrict__ w, const int8_t* __restrict__ x,
                   int M, int K, int N, int rps, const float* __restrict__ xs,
                   const float* __restrict__ wsc, void* out, int out_kind) {
  namespace cg = cooperative_groups;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + TV_STAGES * TV_STAGE);
  uint64_t* empty = full + TV_STAGES;
  const int R = U == kI8 ? K : K / 2;  // weight rows
  const int r_begin = blockIdx.x * rps;
  const int r_end = min(R, r_begin + rps);
  const int steps = max(0, (r_end - r_begin + TV_BR - 1) / TV_BR);
  const int ch0 = blockIdx.y * TV_BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int grp = warp >> 2;         // consumers: stages grp, grp + 2, ...
  const int c = 8 * (warp & 3) + g;  // channels ch0 + 4c .. + 3

  if (threadIdx.x == 0) {
    for (int i = 0; i < TV_STAGES; ++i) {
      // TMA: the expect-tx arrival; the other loads: one per producer lane
      hopper::mbar_init(&full[i], WL == kTmaW ? 1 : 32);
      hopper::mbar_init(&empty[i], 4);  // one arrival per warp of a group
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  int acc[2][NB][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][nb][e] = 0;

  // the high plane's products (W4 only)
  constexpr bool kHi = U != kP0 && U != kI8;
  // one token row of the served unpack: dp4a_row, no TMA (the probe's
  // unpacks stay on the tensor cores at every M)
  if (U == kSigned && NB == 1 && M == 1) {
    if (warp < 8)
      dp4a_row<TAIL>(x, K, w, N, ch0, r_begin, r_end,
                     reinterpret_cast<int*>(smem));
  } else if (warp == 8) {  // producer: keeps the ring full
    if (WL == kTmaW && lane == 0) {  // one thread issues the TMA boxes
      hopper::prefetch_map(&wmap);
      const uint64_t once = hopper::policy_evict_first();
      for (int s = 0; s < steps; ++s) {
        const int slot = s % TV_STAGES;
        hopper::mbar_wait(&empty[slot], ((s / TV_STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[slot], TV_STAGE);
        hopper::tma_load_2d(smem + slot * TV_STAGE, &wmap, &full[slot], ch0,
                            r_begin + s * TV_BR, once);
      }
    } else if (WL != kTmaW) {
      for (int s = 0; s < steps; ++s) {
        const int slot = s % TV_STAGES;
        uint8_t* st = smem + slot * TV_STAGE;
        const int r0 = r_begin + s * TV_BR;
        if constexpr (WL == kCpAsyncW) {
          hopper::mbar_wait(&empty[slot], ((s / TV_STAGES) & 1) ^ 1);
          // 512 pieces of 8 bytes: a warp instruction covers two rows
#pragma unroll 4
          for (int i = 0; i < TV_STAGE / 8 / 32; ++i) {
            const int p = lane + 32 * i, r = p >> 4, cb = (p & 15) * 8;
            const int gr = r0 + r, col = ch0 + cb;
            const bool live = gr < R && col < N;
            hopper::cp_async8_zfill(
                st + r * 128 + (((cb >> 4) ^ (r & 7)) << 4) + (cb & 15),
                live ? w + (long)gr * N + col : w, live);
          }
          hopper::cp_async_mbar_arrive(&full[slot]);
        } else {
          // the stage's words are loaded before the slot is free
          GemvWords h;
          load_gemv_words(h, w, R, N, r0, ch0, lane);
          hopper::mbar_wait(&empty[slot], ((s / TV_STAGES) & 1) ^ 1);
          store_gemv_words(st, h, w, N, r0, ch0, lane);
          hopper::mbar_arrive(&full[slot]);
        }
      }
    }
  } else {
    // this stage's B fragments and the group's next stage's, loaded ahead
    uint32_t xb[NB][2][2], xn[NB][2][2] = {};
    if (grp < steps)
      load_x_frags<NB, TAIL, kHi>(x, M, K, r_begin + grp * TV_BR, r_end, g,
                                  t, xb);
    for (int s = grp; s < steps; s += 2) {
      if (s + 2 < steps)
        load_x_frags<NB, TAIL, kHi>(x, M, K, r_begin + (s + 2) * TV_BR,
                                    r_end, g, t, xn);
      const int slot = s % TV_STAGES;
      hopper::mbar_wait(&full[slot], (s / TV_STAGES) & 1);
      uint32_t rows[2][4];
      load_w_quads(smem + slot * TV_STAGE, 0, c, t, rows);
      // the stage's bytes are in registers: the slot may be refilled
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[slot]);
      uint32_t alo[2][4], ahi[2][4];
      if constexpr (kHi) {
        uint32_t lo[2][4], hi[2][4];
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            unpack_w4<U>(rows[q][i], lo[q][i], hi[q][i]);
        frags_from_rows(lo, alo[0], alo[1]);
        frags_from_rows(hi, ahi[0], ahi[1]);
      } else {  // P0, int8: the bytes are the A fragments as they are
        frags_from_rows(rows, alo[0], alo[1]);
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma_s8(acc[j][nb], alo[j], xb[nb][0]);
          if constexpr (kHi) mma_s8(acc[j][nb], ahi[j], xb[nb][1]);
        }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          xb[nb][h][0] = xn[nb][h][0];
          xb[nb][h][1] = xn[nb][h][1];
        }
    }
    // every consumer is done with the ring: it takes the partial tile,
    // red[token][channel] (token m's channels 4c..4c+3 from the fragments
    // d0 / d2 of both tiles at column 2t + e), group 0's, then group 1's
    // added
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    int* red = reinterpret_cast<int*>(smem);
    for (int turn = 0; turn < 2; ++turn) {
      if (grp == turn) {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            int4* dst = reinterpret_cast<int4*>(
                red + (nb * 8 + 2 * t + e) * TV_BN + 4 * c);
            int4 v = make_int4(acc[0][nb][e], acc[0][nb][2 + e],
                               acc[1][nb][e], acc[1][nb][2 + e]);
            if (turn == 1) {
              const int4 u = *dst;
              v.x += u.x;
              v.y += u.y;
              v.z += u.z;
              v.w += u.w;
            }
            *dst = v;
          }
      }
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
    }
  }

  // the K splits meet: block `rank` sums every cs-th group of 4 channels
  // over the cluster's partial tiles (int32, exact in any order)
  __syncwarp();
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const int cs = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  constexpr int kGroups = NB * 8 * (TV_BN / 4);
  for (int i = rank * TV_THREADS + threadIdx.x; i < kGroups;
       i += cs * TV_THREADS) {
    int4 sum = make_int4(0, 0, 0, 0);
    for (int q = 0; q < cs; ++q) {
      const int4 v = cl.map_shared_rank(reinterpret_cast<int4*>(smem), q)[i];
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const int m = i / (TV_BN / 4), n0 = ch0 + 4 * (i % (TV_BN / 4));
    if (m < M && n0 < N)
      store_out_any(out, out_kind, N, (long)m * N + n0, sum,
                    out_kind == 2 ? 0.f : xs[m], wsc, n0);
  }
  cl.sync();  // no block leaves while another still reads its tile
}

template <int NB, bool TAIL, int U, int WL = kTmaW>
int launch_gemv_tc(const CUtensorMap& wmap, const void* w, const void* x,
                   const void* xs, const void* wsc, void* out, int M, int K,
                   int N, int splits, int rps, int out_kind,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (N + TV_BN - 1) / TV_BN);
  cfg.blockDim = dim3(TV_THREADS);
  cfg.dynamicSmemBytes = TV_SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  // one split: no cluster (the cluster barrier then spans the block alone)
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, gemv_tc_kernel<NB, TAIL, U, WL>, wmap, (const int8_t*)w,
      (const int8_t*)x, M, K, N, rps, (const float*)xs, (const float*)wsc,
      out, out_kind);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <bool TAIL>
int launch_gemv_tc_m(const CUtensorMap& wmap, const void* w, const void* x,
                     const void* xs,
                     const void* wsc, void* out, int M, int K, int N,
                     int splits, int rps, int out_kind, cudaStream_t st) {
  switch ((M + 7) / 8) {
    case 1:
      return launch_gemv_tc<1, TAIL, kSigned>(wmap, w, x, xs, wsc, out, M, K,
                                              N, splits, rps, out_kind, st);
    case 2:
      return launch_gemv_tc<2, TAIL, kSigned>(wmap, w, x, xs, wsc, out, M, K,
                                              N, splits, rps, out_kind, st);
    case 3:
      return launch_gemv_tc<3, TAIL, kSigned>(wmap, w, x, xs, wsc, out, M, K,
                                              N, splits, rps, out_kind, st);
    default:
      return launch_gemv_tc<4, TAIL, kSigned>(wmap, w, x, xs, wsc, out, M, K,
                                              N, splits, rps, out_kind, st);
  }
}

// the probe's unpack `variant` (P0 .. P3) at M <= 8 (one n8 token tile),
// int32 out
template <bool TAIL>
int launch_unpack_gemv(const CUtensorMap& wmap, const void* w, const void* x,
                       void* acc, int M, int K, int N, int splits, int rps,
                       int variant, cudaStream_t st) {
  switch (variant) {
    case kP0:
      return launch_gemv_tc<1, TAIL, kP0>(wmap, w, x, nullptr, nullptr, acc,
                                          M, K, N, splits, rps, 2, st);
    case kP1:
      return launch_gemv_tc<1, TAIL, kP1>(wmap, w, x, nullptr, nullptr, acc,
                                          M, K, N, splits, rps, 2, st);
    case kP2:
      return launch_gemv_tc<1, TAIL, kP2>(wmap, w, x, nullptr, nullptr, acc,
                                          M, K, N, splits, rps, 2, st);
    default:
      return launch_gemv_tc<1, TAIL, kP3>(wmap, w, x, nullptr, nullptr, acc,
                                          M, K, N, splits, rps, 2, st);
  }
}

// a GEMV launch plan's contract: 1 <= splits <= 8 and rps a multiple of 32
// with the splits covering R rows, the last one non-empty
bool plan_ok(int R, int splits, int rps) {
  return splits >= 1 && splits <= TV_MAX_CLUSTER && rps >= TV_BR &&
         rps % TV_BR == 0 && (long)splits * rps >= R &&
         (long)(splits - 1) * rps < R;
}

// the tensor map of a GEMV weight of R rows x N channels (int8, or packed
// W4), boxes of 32 rows x 128 channels. 0 or an error.
int gemv_wmap(CUtensorMap* wmap, const void* w, int R, int N) {
  const uint64_t wd[2] = {(uint64_t)N, (uint64_t)R}, wst[1] = {(uint64_t)N};
  const uint32_t wbox[2] = {TV_BN, TV_BR};
  return hopper::encode_map(wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, wd,
                            wst, wbox);
}

// the W4 GEMV's contract (K1 and K13): M rows in 1 .. max_m, K even, N % 16
// == 0, a 16-byte aligned w and plan_ok over the K/2 packed rows; then the
// tensor map of w into wmap. 0 or an error.
int w4_gemv_map(CUtensorMap* wmap, const void* w, int M, int max_m, int K,
                int N, int splits, int rps) {
  if (M < 1 || M > max_m || K < 2 || K % 2 || N < 16 || N % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 || !plan_ok(K / 2, splits, rps))
    return (int)cudaErrorInvalidValue;
  return gemv_wmap(wmap, w, K / 2, N);
}

// K2's token tiles (1-4 n8 tiles of M <= 32 rows) for one W load path
template <int WL, bool TAIL>
int launch_i8_gemv(const CUtensorMap& wmap, const void* w, const void* x,
                   const void* xs, const void* wsc, void* out, int M, int K,
                   int N, int splits, int rps, int out_kind,
                   cudaStream_t st) {
  switch ((M + 7) / 8) {
    case 1:
      return launch_gemv_tc<1, TAIL, kI8, WL>(wmap, w, x, xs, wsc, out, M, K,
                                             N, splits, rps, out_kind, st);
    case 2:
      return launch_gemv_tc<2, TAIL, kI8, WL>(wmap, w, x, xs, wsc, out, M, K,
                                             N, splits, rps, out_kind, st);
    case 3:
      return launch_gemv_tc<3, TAIL, kI8, WL>(wmap, w, x, xs, wsc, out, M, K,
                                             N, splits, rps, out_kind, st);
    default:
      return launch_gemv_tc<4, TAIL, kI8, WL>(wmap, w, x, xs, wsc, out, M, K,
                                             N, splits, rps, out_kind, st);
  }
}

// ---------------------------------------------------------------------------
// K12: bf16 x (M <= 8) against int8 W on the tensor cores, one launch
// ---------------------------------------------------------------------------
//
// K1's design (gemv_tc_kernel) on int8 rows, in bf16 as the TPU kernel
// computes it: out^T (channels x tokens) = W^T x^T on
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32, the channels the m16 side
// and the M <= 8 tokens one n8 tile, so W is read once whatever M is. Block:
// 128 channels x one K split of `rps` rows (qmm._gemv_plan on K rows); the
// splits of a channel tile form one thread block cluster and meet through
// distributed shared memory. Warp 8 keeps a ring of 8 stages of 32 rows x
// 128 channels (4 KB, 128-byte swizzle) full: a TMA box where N % 16 == 0;
// where N % 16 == 8 W's rows are no legal TMA stride, and the warp's 32
// lanes copy the same tile with 8-byte cp.async, zero-filled past K and N.
// Two groups of 4 consumer warps take the even and the odd stages; thread
// (g, t) of warp w reads its quads (load_w_quads: channels 4c..4c+3, c = 8w
// + g, of rows 4t..4t+3 and 16 + the same) and builds the bf16 A fragments
// in registers (bf16_frags): a byte biased into the low mantissa of 2^23 is
// one prmt and one fadd from an exact f32, and one more prmt packs the
// upper halves of two rows' values (exact: every int8 is a bf16), so the
// 4x4 byte transpose of frags_from_rows costs nothing of its own. Inside a
// k16 product k is permuted (the fragments' k 2t, 2t+1, 2t+8, 2t+9 are rows
// 4t .. 4t+3), so that a thread's B fragment is 4 consecutive bf16 of x row
// g: one 8-byte load from L1 / L2, a stage ahead (zero past the split's
// rows, whose W the box may hold, and for tokens g >= M).
// What bounds it: 1 B of W per weight against ~3.35 TB/s (72 MB at (3584,
// 19968): 21 us); the products, 2 * 8 flops a byte on the tensor cores, are
// far below that, and the conversion is ~2.75 instructions a byte.
// Sums are f32 in a fixed order: by stage within a group, group 0 then
// group 1 in shared memory, then the splits in rank order; a call gives the
// same bits on every run. Epilogue: bf16(sum * ws[n]). One launch, no
// workspace, memset or atomics; graph-capturable.
// Contract (mq_w8_bf16_gemv checks it): 1 <= M <= 8, any K >= 1, N % 8 ==
// 0, an 8-byte aligned w, plan_ok over K rows.

// the A fragments (bf16) of the two m16 tiles for one k16 half, from its
// four row words rows[i] (row 4t + i of the half, channels 4c..4c+3): tile
// j's rows g / g+8 are channels 4c + 2j / 4c + 2j + 1; registers 0 / 1 hold
// rows 4t and 4t+1, registers 2 / 3 rows 4t+2 and 4t+3
// (magic: 2^23's f32 bits, 0x4B000000, passed in a register: with both
// operands of a prmt constant, the compiler makes the magic the immediate
// and materializes every selector in a register, an instruction each)
__device__ __forceinline__ void bf16_frags(const uint32_t rows[4],
                                           uint32_t magic, uint32_t a0[4],
                                           uint32_t a1[4]) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) u[i] = rows[i] ^ 0x80808080u;  // byte + 128
  // row i's byte b as the bits of an exact f32: 2^23 + byte + 128, less
  // 2^23 + 128
  auto f32 = [&](int i, int b) {
    return __float_as_uint(
        __uint_as_float(__byte_perm(u[i], magic, 0x7650 + b)) - 8388736.f);
  };
  // two f32 integers in [-128, 127] as one bf16x2 (their upper halves)
  auto pack = [](uint32_t lo, uint32_t hi) {
    return __byte_perm(lo, hi, 0x7632);
  };
  uint32_t* a[2] = {a0, a1};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    a[j][0] = pack(f32(0, 2 * j), f32(1, 2 * j));
    a[j][1] = pack(f32(0, 2 * j + 1), f32(1, 2 * j + 1));
    a[j][2] = pack(f32(2, 2 * j), f32(3, 2 * j));
    a[j][3] = pack(f32(2, 2 * j + 1), f32(3, 2 * j + 1));
  }
}

// x[k .. k+3] of one bf16 row as a B fragment, zero at or past `limit`
// (TAIL: any K and alignment, element by element)
template <bool TAIL>
__device__ __forceinline__ uint2 x_quad(const __nv_bfloat16* xr, bool live,
                                        int k, int limit) {
  if (!TAIL)
    return live && k < limit ? __ldg(reinterpret_cast<const uint2*>(xr + k))
                             : make_uint2(0u, 0u);
  const unsigned short* p = reinterpret_cast<const unsigned short*>(xr);
  uint32_t e[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = live && k + i < limit ? p[k + i] : 0u;
  return make_uint2(e[0] | (e[1] << 16), e[2] | (e[3] << 16));
}

template <bool TMA_W, bool TAIL>
__global__ void __launch_bounds__(TV_THREADS)
    w8_bf16_tc_kernel(const __grid_constant__ CUtensorMap wmap,
                      const int8_t* __restrict__ w,
                      const __nv_bfloat16* __restrict__ x, int M, int K,
                      int N, int rps, const float* __restrict__ ws,
                      __nv_bfloat16* __restrict__ out) {
  namespace cg = cooperative_groups;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + TV_STAGES * TV_STAGE);
  uint64_t* empty = full + TV_STAGES;
  const int r_begin = blockIdx.x * rps;
  const int r_end = min(K, r_begin + rps);
  const int steps = max(0, (r_end - r_begin + TV_BR - 1) / TV_BR);
  const int ch0 = blockIdx.y * TV_BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int grp = warp >> 2;         // consumers: stages grp, grp + 2, ...
  const int c = 8 * (warp & 3) + g;  // channels ch0 + 4c .. + 3

  if (threadIdx.x == 0) {
    for (int i = 0; i < TV_STAGES; ++i) {
      // TMA: the expect-tx arrival; cp.async: one per lane of warp 8
      hopper::mbar_init(&full[i], TMA_W ? 1 : 32);
      hopper::mbar_init(&empty[i], 4);  // one arrival per warp of a group
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // producer
    if (TMA_W && lane == 0) {
      hopper::prefetch_map(&wmap);
      const uint64_t once = hopper::policy_evict_first();
      for (int s = 0; s < steps; ++s) {
        const int slot = s % TV_STAGES;
        hopper::mbar_wait(&empty[slot], ((s / TV_STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[slot], TV_STAGE);
        hopper::tma_load_2d(smem + slot * TV_STAGE, &wmap, &full[slot], ch0,
                            r_begin + s * TV_BR, once);
      }
    } else if (!TMA_W) {
      for (int s = 0; s < steps; ++s) {
        const int slot = s % TV_STAGES;
        hopper::mbar_wait(&empty[slot], ((s / TV_STAGES) & 1) ^ 1);
        uint8_t* st = smem + slot * TV_STAGE;
        const int r0 = r_begin + s * TV_BR;
        // 512 pieces of 8 bytes: a warp instruction covers two rows
#pragma unroll 4
        for (int i = 0; i < TV_STAGE / 8 / 32; ++i) {
          const int p = lane + 32 * i, r = p >> 4, cb = (p & 15) * 8;
          const int gr = r0 + r, col = ch0 + cb;
          const bool live = gr < K && col < N;
          hopper::cp_async8_zfill(
              st + r * 128 + (((cb >> 4) ^ (r & 7)) << 4) + (cb & 15),
              live ? w + (long)gr * N + col : w, live);
        }
        hopper::cp_async_mbar_arrive(&full[slot]);
      }
    }
  } else {
    float acc[2][4] = {};
    // 0x4B000000, opaque to the compiler (threadIdx.x < 1024)
    const uint32_t magic = 0x4B000000u | (threadIdx.x >> 10);
    const __nv_bfloat16* xr = x + (long)g * K;
    const bool live = g < M;
    // this stage's B fragments (k16 halves h = 0, 1) and the group's next
    // stage's, loaded ahead
    uint2 xb[2], xn[2] = {};
    if (grp < steps)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        xb[h] = x_quad<TAIL>(xr, live, r_begin + grp * TV_BR + 16 * h + 4 * t,
                             r_end);
    for (int s = grp; s < steps; s += 2) {
      if (s + 2 < steps)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          xn[h] = x_quad<TAIL>(
              xr, live, r_begin + (s + 2) * TV_BR + 16 * h + 4 * t, r_end);
      const int slot = s % TV_STAGES;
      hopper::mbar_wait(&full[slot], (s / TV_STAGES) & 1);
      uint32_t rows[2][4];
      load_w_quads(smem + slot * TV_STAGE, 0, c, t, rows);
      // the stage's bytes are in registers: the slot may be refilled
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[slot]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t a0[4], a1[4];
        bf16_frags(rows[h], magic, a0, a1);
        hopper::mma_bf16(acc[0], a0, xb[h].x, xb[h].y);
        hopper::mma_bf16(acc[1], a1, xb[h].x, xb[h].y);
      }
      xb[0] = xn[0];
      xb[1] = xn[1];
    }
    // the block's partial tile red[token][channel] (f32): token 2t + e's
    // channels 4c..4c+3 from c_e / c_{2+e} of both tiles; group 0's, then
    // group 1's added
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    float* red = reinterpret_cast<float*>(smem);
    for (int turn = 0; turn < 2; ++turn) {
      if (grp == turn) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float4* dst =
              reinterpret_cast<float4*>(red + (2 * t + e) * TV_BN + 4 * c);
          float4 v = make_float4(acc[0][e], acc[0][2 + e], acc[1][e],
                                 acc[1][2 + e]);
          if (turn == 1) {
            const float4 u = *dst;
            v.x = u.x + v.x;
            v.y = u.y + v.y;
            v.z = u.z + v.z;
            v.w = u.w + v.w;
          }
          *dst = v;
        }
      }
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
    }
  }

  // the K splits meet: block `rank` sums every cs-th group of 4 channels
  // over the cluster's partial tiles, in rank order
  __syncwarp();
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const int cs = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  constexpr int kGroups = 8 * (TV_BN / 4);
  for (int i = rank * TV_THREADS + threadIdx.x; i < kGroups;
       i += cs * TV_THREADS) {
    float4 sum = cl.map_shared_rank(reinterpret_cast<float4*>(smem), 0)[i];
    for (int q = 1; q < cs; ++q) {
      const float4 v = cl.map_shared_rank(reinterpret_cast<float4*>(smem), q)[i];
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const int m = i / (TV_BN / 4), n0 = ch0 + 4 * (i % (TV_BN / 4));
    if (m < M && n0 < N) {
      __nv_bfloat162 p0 = __floats2bfloat162_rn(sum.x * ws[n0],
                                                sum.y * ws[n0 + 1]);
      __nv_bfloat162 p1 = __floats2bfloat162_rn(sum.z * ws[n0 + 2],
                                                sum.w * ws[n0 + 3]);
      uint2 u;
      u.x = *reinterpret_cast<uint32_t*>(&p0);
      u.y = *reinterpret_cast<uint32_t*>(&p1);
      *reinterpret_cast<uint2*>(out + (long)m * N + n0) = u;
    }
  }
  cl.sync();  // no block leaves while another still reads its tile
}

template <bool TMA_W, bool TAIL>
int launch_w8_bf16(const CUtensorMap& wmap, const void* w, const void* x,
                   const void* ws, void* out, int M, int K, int N, int splits,
                   int rps, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (N + TV_BN - 1) / TV_BN);
  cfg.blockDim = dim3(TV_THREADS);
  cfg.dynamicSmemBytes = TV_SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, w8_bf16_tc_kernel<TMA_W, TAIL>, wmap, (const int8_t*)w,
      (const __nv_bfloat16*)x, M, K, N, rps, (const float*)ws,
      (__nv_bfloat16*)out);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y (M, N) = epilogue(x (M, K) . W4 packed (K/2, N)), or the int32
// accumulator for out_kind 2, in one launch of gemv_tc_kernel: `splits`
// blocks of `rps` packed rows (a cluster) per 128 channels. Needs 1 <= M <=
// 32 and w4_gemv_map's contract.
int mq_w4a8_gemv(const void* x, const void* w, const void* xs, const void* wsc,
                 void* out, int M, int K, int N, int splits, int rps,
                 int out_kind, void* stream) {
  CUtensorMap wmap;
  const int err = w4_gemv_map(&wmap, w, M, 32, K, N, splits, rps);
  if (err) return err;
  // x words read as aligned words only where every one is 4-byte aligned
  const bool tail = (K / 2) % 4 || reinterpret_cast<uintptr_t>(x) % 4;
  const cudaStream_t st = (cudaStream_t)stream;
  return tail ? launch_gemv_tc_m<true>(wmap, w, x, xs, wsc, out, M, K, N,
                                       splits, rps, out_kind, st)
              : launch_gemv_tc_m<false>(wmap, w, x, xs, wsc, out, M, K, N,
                                        splits, rps, out_kind, st);
}

// y (M, N) = epilogue(x (M, K) . W (K, N)) for int8 W, or the int32
// accumulator for out_kind 2, in one launch of gemv_tc_kernel<NB, TAIL,
// kI8, WL>: `splits` blocks of `rps` rows (a cluster) per 128 channels.
// Needs 1 <= M <= 32, K >= 1, N >= 1 (qmm.int8_gemv_supports) and plan_ok
// over K rows; x's rows contiguous at stride K, any alignment. W by TMA
// where N % 16 == 0 and w is 16-byte aligned, by 8-byte cp.async where
// N % 8 == 0 and w is 8-byte aligned, by the producer's lanes otherwise
// (any N, any alignment).
int mq_int8_gemv(const void* x, const void* w, const void* xs, const void* wsc,
                 void* out, int M, int K, int N, int splits, int rps,
                 int out_kind, void* stream) {
  if (M < 1 || M > 32 || K < 1 || N < 1 || !plan_ok(K, splits, rps))
    return (int)cudaErrorInvalidValue;
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  const int wl = N % 16 == 0 && wa % 16 == 0 ? kTmaW
                 : N % 8 == 0 && wa % 8 == 0 ? kCpAsyncW
                                             : kThreadW;
  CUtensorMap wmap = {};
  if (wl == kTmaW) {
    const int err = gemv_wmap(&wmap, w, K, N);
    if (err) return err;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  // the other load paths (no shape of the main path) read x through the
  // predicated loads only: one instantiation each
  if (wl == kCpAsyncW)
    return launch_i8_gemv<kCpAsyncW, true>(wmap, w, x, xs, wsc, out, M, K, N,
                                           splits, rps, out_kind, st);
  if (wl == kThreadW)
    return launch_i8_gemv<kThreadW, true>(wmap, w, x, xs, wsc, out, M, K, N,
                                          splits, rps, out_kind, st);
  // x words read as aligned words only where every one is 4-byte aligned
  const bool tail = K % 4 || reinterpret_cast<uintptr_t>(x) % 4;
  return tail ? launch_i8_gemv<kTmaW, true>(wmap, w, x, xs, wsc, out, M, K, N,
                                            splits, rps, out_kind, st)
              : launch_i8_gemv<kTmaW, false>(wmap, w, x, xs, wsc, out, M, K,
                                             N, splits, rps, out_kind, st);
}

// acc (M, N) int32 = x (M, K) . W4 packed (K/2, N) by the unpack `variant`
// 1 .. 3 (P1 .. P3), or x[:, :K/2] . int8(packed) for variant 0 (P0): one
// launch of gemv_tc_kernel on mq_w4a8_gemv's plan, M <= 8 and
// w4_gemv_map's contract.
int mq_w4_unpack_gemv(const void* x, const void* w, void* acc, int M, int K,
                      int N, int splits, int rps, int variant, void* stream) {
  if (variant < kP0 || variant > kP3) return (int)cudaErrorInvalidValue;
  CUtensorMap wmap;
  const int err = w4_gemv_map(&wmap, w, M, 8, K, N, splits, rps);
  if (err) return err;
  const bool tail = (K / 2) % 4 || reinterpret_cast<uintptr_t>(x) % 4;
  const cudaStream_t st = (cudaStream_t)stream;
  return tail ? launch_unpack_gemv<true>(wmap, w, x, acc, M, K, N, splits,
                                         rps, variant, st)
              : launch_unpack_gemv<false>(wmap, w, x, acc, M, K, N, splits,
                                          rps, variant, st);
}

// out (M, N) bf16 = bf16((x . W) * ws) for bf16 x (M, K), int8 W (K, N)
// row-major, ws (N,) f32, f32 sums: one launch of w8_bf16_tc_kernel,
// `splits` blocks of `rps` rows (a cluster) per 128 channels. Needs 1 <= M
// <= 8, N % 8 == 0, an 8-byte aligned w and plan_ok over K rows; W by TMA
// where N % 16 == 0 and w is 16-byte aligned, by cp.async otherwise.
int mq_w8_bf16_gemv(const void* x, const void* w, const void* ws, void* out,
                    int M, int K, int N, int splits, int rps, void* stream) {
  if (M < 1 || M > 8 || K < 1 || N < 8 || N % 8 ||
      reinterpret_cast<uintptr_t>(w) % 8 || !plan_ok(K, splits, rps))
    return (int)cudaErrorInvalidValue;
  const bool tma = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  CUtensorMap wmap = {};
  if (tma) {
    const int err = gemv_wmap(&wmap, w, K, N);
    if (err) return err;
  }
  // 8-byte x loads only where every quad of a row is 8-byte aligned
  const bool tail = K % 4 || reinterpret_cast<uintptr_t>(x) % 8;
  const cudaStream_t st = (cudaStream_t)stream;
  if (tma)
    return tail ? launch_w8_bf16<true, true>(wmap, w, x, ws, out, M, K, N,
                                             splits, rps, st)
                : launch_w8_bf16<true, false>(wmap, w, x, ws, out, M, K, N,
                                              splits, rps, st);
  return tail ? launch_w8_bf16<false, true>(wmap, w, x, ws, out, M, K, N,
                                            splits, rps, st)
              : launch_w8_bf16<false, false>(wmap, w, x, ws, out, M, K, N,
                                             splits, rps, st);
}

// y (M, N) = epilogue(x (M, K) . W), W4 packed (K/2, N) if w4 else int8 (K, N):
// the TMA + wgmma kernel on blocks of 128 channels x `tokens` (128 or 256)
// tokens. x rows at stride ldx (bytes, a multiple of 16, >= K); needs
// 16-byte aligned x and w, N % 16 == 0 and, for W4, (K/2) % 16 == 0 (the
// host routes other shapes to mq_int8_gemm_ragged). Any K >= 1 on int8 W.
int mq_int8_gemm(const void* x, int ldx, const void* w, const void* xs,
                 const void* wsc, void* out, int M, int K, int N, int w4,
                 int out_kind, int tokens, void* stream) {
  if (M < 1 || K < 1 || ldx < K || ldx % 16 || N < 16 || N % 16 ||
      (w4 && (K % 2 || (K / 2) % 16)) ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 || (tokens != 128 && tokens != 256))
    return (int)cudaErrorInvalidValue;
  return launch_gemm<false>(x, ldx, K, K / 2, w, xs, wsc, out, M, K, N, w4,
                            out_kind, tokens, (cudaStream_t)stream);
}

// The same product for any N >= 1 and any w alignment (W4: K even): the same
// kernel with W's tile written by warpgroup 2 (aligned words shifted into
// place); x as for mq_int8_gemm, by TMA, whose boxes must start on 16
// bytes: for W4 with (K/2) % 16 != 0 x's rows hold the low plane at columns
// [0, K/2) and the high plane at [H, H + K/2), H = K/2 rounded up to 16
// (qmm._w4_planes writes them; ldx >= 2H).
int mq_int8_gemm_ragged(const void* x, int ldx, const void* w, const void* xs,
                        const void* wsc, void* out, int M, int K, int N,
                        int w4, int out_kind, int tokens, void* stream) {
  const int hoff = w4 ? (K / 2 + 15) / 16 * 16 : 0;
  const int xcols = w4 && hoff != K / 2 ? 2 * hoff : K;
  if (M < 1 || K < 1 || N < 1 || ldx < xcols || ldx % 16 || (w4 && K % 2) ||
      reinterpret_cast<uintptr_t>(x) % 16 || (tokens != 128 && tokens != 256))
    return (int)cudaErrorInvalidValue;
  return launch_gemm<true>(x, ldx, xcols, hoff, w, xs, wsc, out, M, K, N, w4,
                           out_kind, tokens, (cudaStream_t)stream);
}

}  // extern "C"
