// The host side shared by K5 (linear_int8.cu) and K7 (linear_int4.cu): the
// choice between the decode GEMV (T <= 16, linear_gemv.cuh, one launch) and
// the row pass + wgmma GEMM (T > 16, quant.cuh + gemm_s8_wgmma.cuh), and the
// scratch each takes.
#pragma once

#include <atomic>

#include "gemm_s8_wgmma.cuh"
#include "linear_gemv.cuh"
#include "quant.cuh"

namespace emr2a {

// the device launches run_linear has issued, by kind (read through
// emr2a_linear_launches): what shows that a call of up to 16 rows is one
// launch, the row quantize inside it
enum LinearLaunch { GEMV_W8A8, GEMV_W4A8, ROW_QUANTIZE, WGMMA_W8A8, WGMMA_W4A8, LAUNCH_KINDS };
inline std::atomic<long long> linear_launches[LAUNCH_KINDS];

// the GEMV's partials for T <= 16, else the row codes (T, K) s8 and then the
// row scales (T,) f32 at the next 16-byte boundary
template <bool W4>
inline size_t linear_scratch_bytes(int T, int K, int N, int sms) {
  if (T <= GEMV_MAX_T) return gemv_partial_bytes<W4>(T, K, N, sms);
  return ((static_cast<size_t>(T) * K + 15) & ~size_t(15)) + 4 * static_cast<size_t>(T);
}

// x (T, K) bf16; w (K, N) s8 (K5) or (K/2, N) packed int4 (K7); w_scale
// (N,) or (K/128, N) f32; bias (N,) bf16 or null; scratch of
// linear_scratch_bytes; counters (N / 128,) u32, zero between launches;
// out (T, N) bf16.
template <bool W4>
inline cudaError_t run_linear(const void* x, const void* w, const void* w_scale, const void* bias,
                              void* scratch, void* counters, void* out, int T, int K, int N,
                              int sms, cudaStream_t st) {
  const bf16* b = static_cast<const bf16*>(bias);
  const float* ws = static_cast<const float*>(w_scale);
  if (T <= GEMV_MAX_T) {
    GemvParams p = {};
    p.x = static_cast<const bf16*>(x);
    p.w = static_cast<const int8_t*>(w);
    p.w_scale = ws;
    p.bias = b;
    p.out = static_cast<bf16*>(out);
    p.partial = scratch;
    p.counters = static_cast<unsigned*>(counters);
    p.T = T;
    p.K = K;
    p.N = N;
    const cudaError_t err = launch_gemv<W4>(p, sms, st);
    if (err == cudaSuccess) ++linear_launches[W4 ? GEMV_W4A8 : GEMV_W8A8];
    return err;
  }
  int8_t* xq = static_cast<int8_t*>(scratch);
  float* xs = reinterpret_cast<float*>(xq + ((static_cast<size_t>(T) * K + 15) & ~size_t(15)));
  QuantParams qp = {};
  qp.x = x;
  qp.q = xq;
  qp.scale = xs;
  qp.rows = T;
  qp.K = K;
  cudaError_t err = launch_quantize_rows<bf16, false>(qp, st);
  if (err != cudaSuccess) return err;
  ++linear_launches[ROW_QUANTIZE];
  WgmmaParams p = {};
  p.x_scale = xs;
  p.w_scale[0] = ws;
  p.bias[0] = b;
  p.out[0] = out;
  p.T = T;
  p.K = K;
  p.N = N;
  const int8_t* wq = static_cast<const int8_t*>(w);
  err = launch_gemm_s8_wgmma<W4, EPI_S8_BF16>(xq, &wq, p, sms, st);
  if (err == cudaSuccess) ++linear_launches[W4 ? WGMMA_W4A8 : WGMMA_W8A8];
  return err;
}

}  // namespace emr2a
