// Helpers shared by the port's kernels: the bf16 type, 16-byte vectors,
// warp reductions and the tanh gelu.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace emr2a {

using bf16 = __nv_bfloat16;

union Vec8 {
  uint4 u;
  bf16 h[8];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
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

}  // namespace emr2a
