// Hopper (sm_90a) primitives shared by the TMA + wgmma kernels of qmm.cu and
// attn.cu: mbarriers, TMA tile loads, the CUtensorMap encoder, wgmma
// shared-memory descriptors and the warpgroup fences, register reallocation.
//
// Shared-memory layout the kernels use with these: every operand tile is
// loaded by TMA with CU_TENSOR_MAP_SWIZZLE_128B into a 1024-byte aligned
// buffer whose rows are 128 bytes (64 bf16 or 128 int8 along the contiguous
// axis), so 8 rows form one 1024-byte swizzle atom.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------------------
// mbarrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async (TMA) proxy
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// one arrival that also announces `bytes` of TMA traffic for this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// waits until the barrier's phase with parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(addr),
      "r"(parity)
      : "memory");
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// L2 hints (createpolicy.fractional): operands read by many blocks stay,
// operands streamed once go first
__device__ __forceinline__ uint64_t policy_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t policy_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes.L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes.L2::cache_hint [%0], [%1, {%3, %4, %5, %6}], [%2], %7;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Host: encodes a tiled tensor map. cuTensorMapEncodeTiled lives in
// libcuda; it is looked up through the runtime's entry-point query, so the
// library needs no -lcuda. dims / strides: innermost first, strides in bytes
// for dims 1..; box: elements per dim (box[0] * element size == 128 for
// SWIZZLE_128B).
// Returns 0 or a cudaError_t.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) != cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

inline int encode_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                      const void* base, const uint64_t* dims,
                      const uint64_t* strides, const uint32_t* box) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i + 1 < rank) s[i] = strides[i];
  }
  const CUresult r = fn(map, type, (cuuint32_t)rank, const_cast<void*>(base), d,
                        s, b, e, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1 in bits
// 62-63); address, leading and stride byte offsets in 16-byte units. For a
// K-major operand of 128-byte rows the leading offset is unused and the
// stride offset is 1024 (one 8-row atom to the next); for an MN-major one
// the leading offset steps from one 64-element MN block to the next and the
// stride offset from one 8-row K group to the next.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = 0;
  d |= (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= 1ull << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of r across a wgmma
// boundary (the registers belong to the async unit in between)
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void reg_fence(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

}  // namespace hopper
