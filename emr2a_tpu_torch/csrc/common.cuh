// Helpers shared by the port's kernels: the bf16 type, 16-byte vectors,
// warp reductions, the tanh gelu, CLIP's quick_gelu, the s8/int4 byte
// transposes and the per-device dynamic shared-memory attribute.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace emr2a {

using bf16 = __nv_bfloat16;

// Sets ``kernel``'s dynamic shared-memory limit to ``bytes`` on the current
// device, once per device: the attribute belongs to the device's context, so
// a process that launches on several cards sets it on each. ``sized`` holds
// one bit per device index below 64 (one record per kernel instance); a
// device at 64 or above sets the attribute on every launch.
template <typename Kernel>
inline cudaError_t smem_attr_once(Kernel* kernel, int bytes, std::atomic<uint64_t>& sized) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (sized.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) sized.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

union Vec8 {
  uint4 u;
  bf16 h[8];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// jax.nn.gelu(approximate=True), evaluated in f32
__device__ __forceinline__ float gelu_tanh(float v) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return v * (0.5f * (1.0f + tanhf(k0 * (v + 0.044715f * (v * v * v)))));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// jax.nn.gelu(approximate=True) of a bf16 value evaluated in bf16, as XLA
// evaluates it (act_dtype=bfloat16 in emr2a_tpu/ops/mlp.py): the constants
// rounded to bf16, every op computed in f32 and rounded to bf16, but the
// last product, v * c, which is exact in f32 (two bf16 operands) and is
// rounded by the caller to the output type.
__device__ __forceinline__ float gelu_tanh_bf16(float v) {
  const float k0 = 0.796875f;             // bf16(sqrt(2 / pi))
  const float k1 = 0.044677734375f;       // bf16(0.044715)
  float c = round_bf16(__fmul_rn(v, v));
  c = round_bf16(__fmul_rn(c, v));
  c = round_bf16(__fmul_rn(c, k1));
  c = round_bf16(__fadd_rn(v, c));
  c = round_bf16(__fmul_rn(c, k0));
  c = round_bf16(tanhf(c));
  c = round_bf16(__fadd_rn(c, 1.0f));
  c = round_bf16(__fmul_rn(c, 0.5f));
  return __fmul_rn(v, c);
}

// CLIP's quick_gelu, v * sigmoid(1.702 v), evaluated in f32 as
// v / (1 + exp(-1.702 v)) with the accurate expf (within 2 ulp), the
// division rounded once: within a few f32 ulp of the plain version's
// v * torch.sigmoid(1.702 v)
__device__ __forceinline__ float quick_gelu(float v) {
  return __fdiv_rn(v, __fadd_rn(1.0f, expf(__fmul_rn(-1.702f, v))));
}

// quick_gelu of a bf16 value evaluated in bf16, as XLA evaluates
// v * jax.nn.sigmoid(1.702 * v) on a bf16 array (act_dtype=bfloat16 in
// emr2a_tpu/ops/mlp.py): the constant rounded to bf16 (1.703125), each op
// of the logistic's expansion 1 / (1 + exp(-x)) computed in f32 and rounded
// to bf16, but the last product, which is exact in f32 and is rounded by
// the caller to the output type.
__device__ __forceinline__ float quick_gelu_bf16(float v) {
  const float k = 1.703125f;              // bf16(1.702)
  float c = round_bf16(__fmul_rn(k, v));
  c = round_bf16(expf(-c));
  c = round_bf16(__fadd_rn(1.0f, c));
  c = round_bf16(__fdiv_rn(1.0f, c));
  return __fmul_rn(v, c);
}

// the 4x4 byte transpose: byte i of c[j] is byte j of w_i, so c[j] holds
// column j of the four byte rows w0..w3
__device__ __forceinline__ void transpose4x4(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3,
                                             uint32_t* c) {
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140);
  const uint32_t t1 = __byte_perm(w2, w3, 0x5140);
  const uint32_t t2 = __byte_perm(w0, w1, 0x7362);
  const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

// the four low (or, after >> 4, high) nibbles of a packed int4 word as s8
// bytes (4-bit two's complement, sign-extended per byte): each byte
// 0x80 | (nibble ^ 8) minus 8 borrows from no other byte, and the xor with
// 0x80 leaves nibble - 16 * (nibble >= 8) in two's complement
__device__ __forceinline__ uint32_t sext_nibbles(uint32_t w) {
  return (((w & 0x0F0F0F0Fu) ^ 0x88888888u) - 0x08080808u) ^ 0x80808080u;
}

}  // namespace emr2a
