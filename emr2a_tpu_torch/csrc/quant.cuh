// Per-row symmetric s8 quantize, shared by the W8A8 kernels (K2 mlp_int8.cu,
// K4 attention_block_int8.cu, K5 linear_int8.cu) and K7 (linear_int4.cu); the
// decode GEMV of K5 and K7 (linear_gemv.cuh) quantizes its rows in shared
// memory with the same row_scale and quantize_code.
//
// Port of emr2a_tpu/ops/quant.py:quantize_rows_s8, which every int8 path of
// the JAX package uses:
//   scale = max(amax(|row|), 1e-12) * f32(1/127)
//   code  = clip(round_half_even(x * (1 / scale)), -127, 127)
// The codes must equal the JAX package's bit for bit, so: the floor is
// applied to amax before the multiply by 1/127; 1/scale is an IEEE reciprocal
// (__frcp_rn) followed by a multiply; rounding is rintf (half to even); the
// library is built without fast-math.
//
// With LN = true the row is first LayerNorm-ed in f32, and the f32 LN output
// is quantized: the prologue of K2 and K4, which quantize the f32 LN output,
// not a bf16-rounded one. The statistics come from the row's sum and sum of
// squares in f64, which are exact for a bf16 row (8-bit significands, 16 for
// a square), so they do not depend on the order of the sums: mu = f32(sum /
// K), var = f32(sumsq / K - (sum / K)^2), rstd = 1 / sqrt(var + eps) in f32,
// each step rounded once, then ((x - mu) * rstd) * scale + bias with no fused
// multiply-add. The plain version (ops/mlp.py layer_norm_f32) computes the
// same bits; f32 sums in another order would differ by an ulp in many rows,
// and a code at a half-way point would then flip.
//
// Design: one warp per row, 8 rows per 256-thread block. A lane handles 8
// consecutive elements per step (one 16-byte load of bf16, two of f32). The
// row is read once for the amax and once more for the codes (from L1/L2);
// LN rows are read three times. Bound by device memory: T*K*(in + 1) bytes.
#pragma once

#include "common.cuh"

namespace emr2a {

// float(1.0 / 127.0), the constant both frameworks multiply by
constexpr float INV127 = 1.0f / 127.0f;
constexpr int QUANT_THREADS = 256;
constexpr int QUANT_ROWS = QUANT_THREADS / 32;

struct QuantParams {
  const void* x;          // (rows, K), bf16 or f32
  const bf16* ln_scale;   // (K,), LN only
  const bf16* ln_bias;    // (K,)
  float eps;
  int8_t* q;              // (rows, K) codes
  float* scale;           // (rows,)
  int rows, K;
};

__device__ __forceinline__ void load8(const bf16* p, float* v) {
  Vec8 u;
  u.u = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int t = 0; t < 8; ++t) v[t] = __bfloat162float(u.h[t]);
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// a row's scale from its amax: the 1e-12 floor, then the multiply by 1/127
__device__ __forceinline__ float row_scale(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-12f), INV127);
}

__device__ __forceinline__ int8_t quantize_code(float v, float inv) {
  const float r = fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(r));
}

template <typename InT, bool LN>
__global__ void __launch_bounds__(QUANT_THREADS) quantize_rows_kernel(QuantParams p) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * QUANT_ROWS + (threadIdx.x >> 5);
  if (row >= p.rows) return;
  const int K = p.K;
  const InT* x = static_cast<const InT*>(p.x) + (size_t)row * K;

  float mu = 0.f, rstd = 1.f;
  if (LN) {
    double s = 0.0, ss = 0.0;
    for (int k = lane * 8; k < K; k += 256) {
      float v[8];
      load8(x + k, v);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const double dv = v[t];
        s = __dadd_rn(s, dv);
        ss = __fma_rn(dv, dv, ss);
      }
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const double m = __ddiv_rn(s, (double)K);
    mu = __double2float_rn(m);
    const float var = __double2float_rn(__dsub_rn(__ddiv_rn(ss, (double)K), __dmul_rn(m, m)));
    rstd = __frcp_rn(__fsqrt_rn(__fadd_rn(var, p.eps)));
  }
  // the value to quantize: x itself, or its f32 LayerNorm
  auto values = [&](int k, float* v) {
    load8(x + k, v);
    if (LN) {
      float s[8], b[8];
      load8(p.ln_scale + k, s);
      load8(p.ln_bias + k, b);
#pragma unroll
      for (int t = 0; t < 8; ++t)
        v[t] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[t], mu), rstd), s[t]), b[t]);
    }
  };

  float amax = 0.f;
  for (int k = lane * 8; k < K; k += 256) {
    float v[8];
    values(k, v);
#pragma unroll
    for (int t = 0; t < 8; ++t) amax = fmaxf(amax, fabsf(v[t]));
  }
  amax = warp_max(amax);
  const float scale = row_scale(amax);
  const float inv = __frcp_rn(scale);
  int8_t* q = p.q + (size_t)row * K;
  for (int k = lane * 8; k < K; k += 256) {
    float v[8];
    values(k, v);
    union {
      uint2 u;
      int8_t c[8];
    } pk;
#pragma unroll
    for (int t = 0; t < 8; ++t) pk.c[t] = quantize_code(v[t], inv);
    *reinterpret_cast<uint2*>(q + k) = pk.u;
  }
  if (lane == 0) p.scale[row] = scale;
}

// Rules the wrappers check: K % 8 == 0, rows >= 1, 16-byte aligned rows.
template <typename InT, bool LN>
inline cudaError_t launch_quantize_rows(const QuantParams& p, cudaStream_t stream) {
  if (p.rows < 1 || p.K < 8 || p.K % 8) return cudaErrorInvalidValue;
  const int blocks = (p.rows + QUANT_ROWS - 1) / QUANT_ROWS;
  quantize_rows_kernel<InT, LN><<<blocks, QUANT_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace emr2a
