// Streaming W8A8 linear (K5) for Hopper (sm_90a), and the row quantize on its
// own.
//
// Replaces emr2a_tpu/ops/linear_int8.py:linear_w8a8 (the Pallas kernels
// _kernel_fused and _kernel_s8):
//   y = bf16(((f32(q8(x) @ Wq) * s_row) * s_col) + b)
// with exact s32 sums and each rescale step rounded once, in that order. The
// TPU package has two paths, an in-kernel quantize for small T and a
// pre-quantized s8 stream for large T; both give identical codes.
//
// Bound on the H100: at decode (T = 1) the weight stream, K*N bytes (4096 ->
// 12288: 50 MB, 15 us at 3.35 TB/s); at the PubMedBERT shapes (T = 8,192)
// and the judge's prefill (T = 2,048) the 2*T*K*N s8 operations.
//
// Two designs, chosen by T as K7 chooses:
// - T <= 16: linear_gemv.cuh, one launch that quantizes the rows in shared
//   memory and streams the weights with 16-byte loads and dp4a, its K split
//   across blocks (s32 partials, the strip's last block rescales).
// - T > 16: quant.cuh's row pass, then gemm_s8_wgmma.cuh, the persistent
//   s8 wgmma GEMM with TMA and an mbarrier ring, the rescale and bias in its
//   bf16 epilogue; K2 and K4 run their products on the same GEMM.
#include "linear_quantized.cuh"

using namespace emr2a;

// The scratch a linear of either kind (w4 = 1: K7) needs at (T, K, N).
extern "C" long long emr2a_linear_scratch_bytes(int w4, int T, int K, int N, int sms) {
  return static_cast<long long>(w4 ? linear_scratch_bytes<true>(T, K, N, sms)
                                   : linear_scratch_bytes<false>(T, K, N, sms));
}

// The device launches the two linears have issued, by kind: GEMV W8A8, GEMV
// W4A8, row quantize, wgmma GEMM W8A8, wgmma GEMM W4A8.
extern "C" long long emr2a_linear_launches(int kind) {
  return kind >= 0 && kind < LAUNCH_KINDS ? linear_launches[kind].load() : -1;
}

// x (T, K) bf16; w (K, N) s8; w_scale (N,) f32; bias (N,) bf16 or null;
// scratch of emr2a_linear_scratch_bytes(0, ...); counters (N / 128,) u32,
// zero (the GEMV leaves them zero); out (T, N) bf16; sms the card's SM count.
// Rules the wrapper checks: K % 32 == 0, N % 128 == 0, T >= 1, 16-byte
// aligned pointers.
extern "C" int emr2a_linear_w8a8(const void* x, const void* w, const void* w_scale,
                                 const void* bias, void* scratch, void* counters, void* out,
                                 int T, int K, int N, int sms, void* stream) {
  return static_cast<int>(run_linear<false>(x, w, w_scale, bias, scratch, counters, out, T, K, N,
                                           sms, reinterpret_cast<cudaStream_t>(stream)));
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
