// Streaming W8A8 linear for Hopper (sm_90a), and the row quantize on its
// own.
//
// Replaces emr2a_tpu/ops/linear_int8.py:linear_w8a8 (the Pallas kernels
// _kernel_fused and _kernel_s8):
//   y = bf16((q8(x) @ Wq) * s_row * s_col + b)
// The TPU package has two paths, an in-kernel quantize for small T and a
// pre-quantized s8 stream for large T; both compute this one function with
// identical codes, so the port has one design for every T.
//
// Bound on the H100: at the PubMedBERT shapes (T = B*256, K and N in {768,
// 3072}) the product is 2*T*K*N integer operations, compute-bound at large
// T; at small T the weight stream (K*N bytes) bounds it.
// Design: two launches, quant.cuh's row pass (x -> s8 codes + row scales,
// T*K bytes to device memory) and the s8 GEMM (gemm_s8.cuh) with the rescale
// and bias in its epilogue.
#include "gemm_s8.cuh"
#include "quant.cuh"

using namespace emr2a;

// x (T, K) bf16; w (K, N) s8; w_scale (N,) f32; bias (N,) bf16 or null;
// scratch xq (T, K) s8, xs (T,) f32; out (T, N) bf16.
extern "C" int emr2a_linear_w8a8(const void* x, const void* w, const void* w_scale,
                                 const void* bias, void* xq, void* xs, void* out, int T, int K,
                                 int N, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  QuantParams qp = {};
  qp.x = x;
  qp.q = static_cast<int8_t*>(xq);
  qp.scale = static_cast<float*>(xs);
  qp.rows = T;
  qp.K = K;
  cudaError_t err = launch_quantize_rows<bf16, false>(qp, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  GemmS8Params p = {};
  p.a = static_cast<const int8_t*>(xq);
  p.a_scale = static_cast<const float*>(xs);
  p.b[0] = static_cast<const int8_t*>(w);
  p.b_scale[0] = static_cast<const float*>(w_scale);
  p.bias[0] = static_cast<const bf16*>(bias);
  p.out[0] = out;
  p.M = T;
  p.N = N;
  p.K = K;
  return static_cast<int>(launch_gemm_s8<EPI_S8_BF16>(p, 1, st));
}

// The row quantize alone: x (rows, K) bf16 (x_is_f32 = 0) or f32 (1).
extern "C" int emr2a_quantize_rows(const void* x, int x_is_f32, void* q, void* scale, int rows,
                                   int K, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  QuantParams qp = {};
  qp.x = x;
  qp.q = static_cast<int8_t*>(q);
  qp.scale = static_cast<float*>(scale);
  qp.rows = rows;
  qp.K = K;
  cudaError_t err = x_is_f32 ? launch_quantize_rows<float, false>(qp, st)
                             : launch_quantize_rows<bf16, false>(qp, st);
  return static_cast<int>(err);
}
