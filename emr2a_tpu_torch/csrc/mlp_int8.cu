// Fused LN -> MLP -> residual block in W8A8 for Hopper (sm_90a).
//
// Replaces emr2a_tpu/ops/mlp.py:fused_ln_mlp_int8 (the Pallas kernel
// _mlp_kernel_int8):
//   h   = LN(x)                         f32 statistics, f32 output
//   q1  = q8(h)                         per-row s8 codes + f32 scale
//   h1  = gelu_tanh((q1 @ W1q) * s_row * s_col + b1)       s32 products, f32
//   q2  = q8(h1)                        over the whole f32 row of m values
//   y   = x + bf16((q2 @ W2q) * s_row * s_col + b2)
// With act_bf16 (JAX's act_dtype=bfloat16) the fc1 value is rounded to bf16
// and the gelu evaluated in bf16 (gelu_tanh_bf16 in common.cuh), carried
// back to f32 before the row quantize; the f32 path is unchanged.
//
// Bound on the H100: at ViT-B (T = B*200, d = 768, m = 3072) the products are
// 4*T*d*m integer operations, compute-bound on the tensor cores; the f32 h1
// row (4*m bytes) must be whole before its amax is known.
// Design: four launches. (1) quant.cuh's row pass fuses the LayerNorm and
// quantizes its f32 output; (2) the s8 GEMM (gemm_s8.cuh) computes fc1 with
// the rescale, b1 and gelu in its epilogue and writes h1 in f32; (3) the row
// pass quantizes h1 with the amax of its whole row; (4) the s8 GEMM computes
// fc2 with the rescale, b2 and the residual add in its epilogue.
// Not yet done: h1 makes a round trip through device memory in f32 (T*m*4
// bytes each way); keeping it on chip is the first optimisation queued.
#include "gemm_s8.cuh"
#include "quant.cuh"

using namespace emr2a;

// hq (T, d) s8, hs (T,) f32, h1 (T, m) f32, q2 (T, m) s8, s2 (T,) f32: scratch.
extern "C" int emr2a_fused_ln_mlp_int8(const void* x, const void* ln_scale,
                                       const void* ln_bias, const void* w1, const void* w1_scale,
                                       const void* b1, const void* w2, const void* w2_scale,
                                       const void* b2, void* hq, void* hs, void* h1, void* q2,
                                       void* s2, void* out, int T, int d, int m,
                                       int act_bf16, float eps, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  QuantParams qp = {};
  qp.x = x;
  qp.ln_scale = static_cast<const bf16*>(ln_scale);
  qp.ln_bias = static_cast<const bf16*>(ln_bias);
  qp.eps = eps;
  qp.q = static_cast<int8_t*>(hq);
  qp.scale = static_cast<float*>(hs);
  qp.rows = T;
  qp.K = d;
  cudaError_t err = launch_quantize_rows<bf16, true>(qp, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  GemmS8Params p1 = {};
  p1.a = static_cast<const int8_t*>(hq);
  p1.a_scale = static_cast<const float*>(hs);
  p1.b[0] = static_cast<const int8_t*>(w1);
  p1.b_scale[0] = static_cast<const float*>(w1_scale);
  p1.bias[0] = static_cast<const bf16*>(b1);
  p1.out[0] = h1;
  p1.M = T;
  p1.N = m;
  p1.K = d;
  err = act_bf16 ? launch_gemm_s8<EPI_S8_GELU_BF16>(p1, 1, st)
                 : launch_gemm_s8<EPI_S8_GELU_F32>(p1, 1, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  QuantParams qp2 = {};
  qp2.x = h1;
  qp2.q = static_cast<int8_t*>(q2);
  qp2.scale = static_cast<float*>(s2);
  qp2.rows = T;
  qp2.K = m;
  err = launch_quantize_rows<float, false>(qp2, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  GemmS8Params p2 = {};
  p2.a = static_cast<const int8_t*>(q2);
  p2.a_scale = static_cast<const float*>(s2);
  p2.b[0] = static_cast<const int8_t*>(w2);
  p2.b_scale[0] = static_cast<const float*>(w2_scale);
  p2.bias[0] = static_cast<const bf16*>(b2);
  p2.out[0] = out;
  p2.residual = static_cast<const bf16*>(x);
  p2.M = T;
  p2.N = d;
  p2.K = m;
  return static_cast<int>(launch_gemm_s8<EPI_S8_RESIDUAL>(p2, 1, st));
}
