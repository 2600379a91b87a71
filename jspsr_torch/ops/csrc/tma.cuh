// Hopper's bulk-copy plumbing shared by the port's kernels (the deform
// forward K1, deform_fwd.cu, the deform backward K2, deform_bwd.cu, and
// K4's bf16 conv, conv_same_bf16.cu): mbarrier helpers, TMA tensor loads,
// libcuda's tensor-map encoder looked up through the runtime, so that no
// library needs -lcuda, and the host helpers of K1's, K2's and K3's
// persistent launches (their plane and window tensor maps, the SM count,
// the resident blocks per SM).
//
// A TMA load is issued by one thread; the hardware copies a box of a
// tensor map into shared memory, fills what lies outside the tensor with
// zero, and counts the bytes against a shared-memory mbarrier on which the
// consumers wait (expect_tx arms it with the box bytes, out-of-bounds fill
// included).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace jspsr {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

// makes the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// the spin loop stays inside the asm: a loop the compiler sees would make
// a warpgroup divergent before a wgmma that follows, and ptxas then
// serialises the wgmma
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity) : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(c2), "r"(bar) : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(bar) : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime once;
// nullptr where libcuda has none. The encoder is a driver call, which needs
// a current context, and the runtime binds its context to a thread only at
// that thread's first call that needs one: a launch from a thread that has
// not touched the card yet (autograd's device thread, when the deform op's
// backward is its first work) would fail to encode. So every call binds
// the current device's context first (cudaSetDevice does, and costs nothing
// once it is bound).
inline EncodeTiled encode_tiled() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaSetDevice(dev) != cudaSuccess)
    return nullptr;
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

// a 3-D fp32 tensor map over (W, H, planes), box (box_w, box_h, box_c)
inline CUresult encode_planes(EncodeTiled encode, CUtensorMap* map,
                              const float* ptr, int w, int h, int64_t planes,
                              int box_w, int box_h, int box_c) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(w) * 4,
                                 static_cast<cuuint64_t>(w) * 4 * h};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_w),
                             static_cast<cuuint32_t>(box_h),
                             static_cast<cuuint32_t>(box_c)};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<float*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// an fp32 image batch (B, 1, H, W) as a 4-D tensor map over (4, W/4, H, B),
// box (4, win_w / 4, win_h, 1): a window of rows of 16-byte groups (a TMA
// box row may be at most 256 bytes on an H100, a window row is wider)
inline CUresult encode_window(EncodeTiled encode, CUtensorMap* map,
                              const float* x, int w, int h, int64_t batch,
                              int win_h, int win_w) {
  const cuuint64_t dims[4] = {4, static_cast<cuuint64_t>(w / 4),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {16, static_cast<cuuint64_t>(w) * 4,
                                 static_cast<cuuint64_t>(w) * 4 * h};
  const cuuint32_t box[4] = {4, static_cast<cuuint32_t>(win_w / 4),
                             static_cast<cuuint32_t>(win_h), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(x),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// the current device's SM count, 0 where the runtime cannot say
inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

// ``kernel``'s dynamic shared-memory allowance (``smem`` bytes), set once
// per device, and how many of its blocks of ``threads`` one SM holds, in
// ``blocks``; ``resident`` is the caller's cache of that count per device
// (one array per kernel, 0 until asked)
template <class Kernel>
cudaError_t resident_blocks(Kernel* kernel, int threads, int smem,
                            int (&resident)[64], int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && resident[dev] > 0) {
    *blocks = resident[dev];
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                        threads, smem);
  if (err == cudaSuccess && *blocks < 1) err = cudaErrorInvalidConfiguration;
  if (err == cudaSuccess && dev < 64) resident[dev] = *blocks;
  return err;
}

}  // namespace jspsr
