// Hopper's asynchronous copy and barrier helpers, shared by the two wgmma
// GEMMs: the s8 one of K2/K4/K5/K7 (gemm_s8_wgmma.cuh) and the bf16 one of K1/K3
// (gemm.cuh). TMA descriptors are encoded on the host per call by
// cuTensorMapEncodeTiled, looked up with dlsym in the libcuda that the CUDA
// runtime has loaded, so nothing links against libcuda. Matrices are described as bytes (a bf16
// matrix has 2 * cols byte columns) in boxes of 128 bytes with the 128-byte
// swizzle, the span wgmma's swizzled layouts read.
#pragma once

#include <cuda.h>
#include <dlfcn.h>

#include "common.cuh"

namespace emr2a {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// the byte at (row, col) of a tile stored by TMA with the 128-byte swizzle:
// 16-byte chunk col / 16 of row r sits at chunk (col / 16) ^ (r % 8)
__device__ __forceinline__ int swz128(int row, int col) {
  return row * 128 + ((((col >> 4) ^ row) & 7) << 4) + (col & 15);
}

// wgmma's shared-memory descriptor of a K-major tile with the 128-byte
// swizzle: 8-row core groups 1024 bytes apart
__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void reg_fence(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// the current device's SM count: the persistent GEMMs' grid
inline cudaError_t current_sms(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  return err == cudaSuccess ? cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev)
                            : err;
}

// cuTensorMapEncodeTiled, from the libcuda that the runtime has loaded
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
inline EncodeTiledFn encode_tiled_fn() {
  static const EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// a (rows, cols) byte matrix, row stride cols bytes, as boxes of box_rows x 128
// bytes with the 128-byte swizzle; out-of-range elements read as 0
inline cudaError_t encode_u8_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                                 int box_rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {128u, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1u, 1u};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace emr2a
