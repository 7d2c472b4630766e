// Fused LN -> MLP -> residual block for Hopper (sm_90a).
//
// Replaces emr2a_tpu/ops/mlp.py:fused_ln_mlp (the Pallas kernel _mlp_kernel):
//   y = x + fc2(gelu_tanh(fc1(LN(x))))
// with f32 LN statistics, the LN output rounded to bf16, fc1 + b1 and the
// tanh gelu in f32, the activation rounded to bf16, fc2 accumulated in f32,
// + b2 rounded to bf16, then the residual add.
//
// Bound on the H100: at ViT-B (T = B*200, d = 768, m = 3072) the block is
// 4*T*d*m FLOPs against ~4*T*d + 2*T*m bytes, i.e. compute-bound on the
// tensor cores. The design spends its effort on the two products (both run
// through the hand-written wmma GEMM in gemm.cuh, LN fused into the first
// one's operand load, bias/gelu/residual fused into the epilogues).
// Not yet done: the (T, m) bf16 activation makes one round trip through
// device memory between the two GEMMs; keeping it on chip is the first
// optimisation queued for this kernel.
#include "gemm.cuh"

using namespace emr2a;

extern "C" const char* emr2a_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int emr2a_fused_ln_mlp(const void* x, const void* ln_scale, const void* ln_bias,
                                  const void* w1, const void* b1, const void* w2,
                                  const void* b2, void* h1, void* out, int T, int d,
                                  int m, float eps, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  GemmParams p1 = {};
  p1.a = static_cast<const bf16*>(x);
  p1.b[0] = static_cast<const bf16*>(w1);
  p1.bias[0] = static_cast<const bf16*>(b1);
  p1.out[0] = static_cast<bf16*>(h1);
  p1.ln_scale = static_cast<const bf16*>(ln_scale);
  p1.ln_bias = static_cast<const bf16*>(ln_bias);
  p1.eps = eps;
  p1.M = T;
  p1.N = m;
  p1.K = d;
  cudaError_t err = launch_gemm<EPI_BIAS_GELU, true>(p1, 1, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  GemmParams p2 = {};
  p2.a = static_cast<const bf16*>(h1);
  p2.b[0] = static_cast<const bf16*>(w2);
  p2.bias[0] = static_cast<const bf16*>(b2);
  p2.out[0] = static_cast<bf16*>(out);
  p2.residual = static_cast<const bf16*>(x);
  p2.M = T;
  p2.N = d;
  p2.K = m;
  return static_cast<int>(launch_gemm<EPI_BIAS_RESIDUAL, false>(p2, 1, st));
}
