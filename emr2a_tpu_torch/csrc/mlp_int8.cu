// Fused LN -> MLP -> residual block in W8A8 (K2) for Hopper (sm_90a).
//
// Replaces emr2a_tpu/ops/mlp.py:194 fused_ln_mlp_int8 (the Pallas kernel
// _mlp_kernel_int8, pallas_call at :214):
//   h   = LN(x)                         f32 output; statistics from exact
//                                       f64 row sums (quant.cuh)
//   q1  = q8(h)                         per-row s8 codes + f32 scale
//   h1  = gelu_tanh((q1 @ W1q) * s_row * s_col + b1)       s32 products, f32
//   q2  = q8(h1)                        over the whole f32 row of m values
//   y   = x + bf16((q2 @ W2q) * s_row * s_col + b2)
// With bit 0 of act (JAX's act_dtype=bfloat16) the fc1 value is rounded to bf16
// and the gelu evaluated in bf16 (gelu_tanh_bf16 in common.cuh), carried
// back to f32 before the row quantize; the f32 path is unchanged. With the
// quick_gelu flag (bit 1 of act, as in mlp.cu) the same two paths evaluate
// CLIP's quick_gelu / quick_gelu_bf16 instead.
//
// Bound on the H100: at ViT-B (T = B*200, d = 768, m = 3072) the products are
// 4*T*d*m s8 operations, 0.0305 ms at T = 6,400 over 1,979 TOP/s. The f32 h1
// row (4*m bytes) must be whole before its amax is known, so h1 goes through
// device memory: written by fc1's epilogue, read by the row pass, with q2
// written and read by fc2, some 197 MB at T = 6,400 (0.059 ms at 3.35 TB/s),
// a floor above the operations' whatever the products do.
// Design: four launches. (1) quant.cuh's row pass fuses the LayerNorm and
// quantizes its f32 output; (2) the persistent s8 wgmma GEMM
// (gemm_s8_wgmma.cuh) computes fc1 with the rescale, b1 and gelu in its
// epilogue and writes h1 in f32; (3) the row pass quantizes h1 with the
// amax of its whole row; (4) the same GEMM computes fc2 with the rescale,
// b2 and the residual add in its epilogue. The GEMM keeps the weights'
// (in, out) layout (the swapped operands) and picks its token tile by T,
// so that the last wave of tiles is not thin (fc2's N = 768).
// Not yet done: keeping h1 on chip (T*m*4 bytes each way).
#include "gemm_s8_wgmma.cuh"
#include "quant.cuh"

using namespace emr2a;

// hq (T, d) s8, hs (T,) f32, h1 (T, m) f32, q2 (T, m) s8, s2 (T,) f32: scratch.
// Rules the wrapper checks: d % 128 == 0, m % 128 == 0, T >= 1.
extern "C" int emr2a_fused_ln_mlp_int8(const void* x, const void* ln_scale,
                                       const void* ln_bias, const void* w1, const void* w1_scale,
                                       const void* b1, const void* w2, const void* w2_scale,
                                       const void* b2, void* hq, void* hs, void* h1, void* q2,
                                       void* s2, void* out, int T, int d, int m,
                                       int act, float eps, void* stream) {
  if (act < 0 || act > 3) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int sms = 0;
  cudaError_t err = current_sms(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  QuantParams qp = {};
  qp.x = x;
  qp.ln_scale = static_cast<const bf16*>(ln_scale);
  qp.ln_bias = static_cast<const bf16*>(ln_bias);
  qp.eps = eps;
  qp.q = static_cast<int8_t*>(hq);
  qp.scale = static_cast<float*>(hs);
  qp.rows = T;
  qp.K = d;
  err = launch_quantize_rows<bf16, true>(qp, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  WgmmaParams p1 = {};
  p1.x_scale = static_cast<const float*>(hs);
  p1.w_scale[0] = static_cast<const float*>(w1_scale);
  p1.bias[0] = static_cast<const bf16*>(b1);
  p1.out[0] = h1;
  p1.T = T;
  p1.K = d;
  p1.N = m;
  const int8_t* w1q = static_cast<const int8_t*>(w1);
  const int8_t* hqc = static_cast<const int8_t*>(hq);
  switch (act) {   // bit 0: bf16 act_dtype; bit 1: quick_gelu
    case 0: err = launch_gemm_s8_wgmma<false, EPI_S8_GELU_F32>(hqc, &w1q, p1, sms, st); break;
    case 1: err = launch_gemm_s8_wgmma<false, EPI_S8_GELU_BF16>(hqc, &w1q, p1, sms, st); break;
    case 2: err = launch_gemm_s8_wgmma<false, EPI_S8_QGELU_F32>(hqc, &w1q, p1, sms, st); break;
    default: err = launch_gemm_s8_wgmma<false, EPI_S8_QGELU_BF16>(hqc, &w1q, p1, sms, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  QuantParams qp2 = {};
  qp2.x = h1;
  qp2.q = static_cast<int8_t*>(q2);
  qp2.scale = static_cast<float*>(s2);
  qp2.rows = T;
  qp2.K = m;
  err = launch_quantize_rows<float, false>(qp2, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  WgmmaParams p2 = {};
  p2.x_scale = static_cast<const float*>(s2);
  p2.w_scale[0] = static_cast<const float*>(w2_scale);
  p2.bias[0] = static_cast<const bf16*>(b2);
  p2.out[0] = out;
  p2.residual = static_cast<const bf16*>(x);
  p2.T = T;
  p2.K = m;
  p2.N = d;
  const int8_t* w2q = static_cast<const int8_t*>(w2);
  return static_cast<int>(launch_gemm_s8_wgmma<false, EPI_S8_RESIDUAL>(
      static_cast<const int8_t*>(q2), &w2q, p2, sms, st));
}
