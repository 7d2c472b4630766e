// s8 x s8 -> s32 tensor-core GEMM written by hand for Hopper (sm_90a), the
// product of the W8A8 kernels K2 (mlp_int8.cu), K4 (attention_block_int8.cu)
// and K5 (linear_int8.cu).
//
//   y[z] = ((float)(A @ B[z]) * a_scale[row]) * b_scale[z][col] + bias[z][col]
//                                                    z = blockIdx.z < 3
//
// A is (M, K) row-major s8 codes with one f32 scale per row (quant.cuh); each
// B[z] is (K, N) row-major s8 with one f32 scale per column: the JAX
// package's (in, out) kernel_q layout, used as it is (no transposed copy).
// The rescale is two rounded multiplies and a rounded add, in that order, as
// emr2a_tpu/ops/linear_int8.py:_s8_dot and the fused int8 kernels compute it.
//
// Epilogues:
//   EPI_S8_BF16       out bf16 = bf16(y)                         (K5, K4 Q/K/V)
//   EPI_S8_GELU_F32   out f32  = gelu_tanh(y)                    (K2 fc1)
//   EPI_S8_RESIDUAL   out bf16 = residual + bf16(y)              (K2 fc2, K4 out-proj)
//
// Design: 128x128 block tile, 32-deep k-steps, 8 warps each owning a 32x64
// sub-tile of 16x16x16 wmma s8 fragments with s32 accumulation; the next
// k-step is prefetched into registers during the current one (two shared
// buffers). wmma takes B row-major for 8-bit types, so the (K, N) weights
// need no transpose. Shared tiles are stored in 16-byte-wide k-chunks (A) and
// n-chunks (B), so that every fragment starts 32-byte aligned as wmma
// requires. The s32 sums are exact; the only roundings are the epilogue's.
// No wgmma, TMA or ldmatrix yet: this is the simple first version.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace emr2a {

enum EpilogueS8 { EPI_S8_BF16 = 0, EPI_S8_GELU_F32 = 1, EPI_S8_RESIDUAL = 2 };

constexpr int S8_BM = 128;
constexpr int S8_BN = 128;
constexpr int S8_BK = 32;
constexpr int S8_THREADS = 256;
constexpr int S8_WARPS = S8_THREADS / 32;

struct GemmS8Params {
  const int8_t* a;          // (M, K) codes
  const float* a_scale;     // (M,)
  const int8_t* b[3];       // (K, N) codes per blockIdx.z
  const float* b_scale[3];  // (N,)
  const bf16* bias[3];      // (N,) or nullptr
  void* out[3];             // (M, N): f32 for EPI_S8_GELU_F32, else bf16
  const bf16* residual;     // (M, N), EPI_S8_RESIDUAL only
  int M, N, K;
};

template <int EPI>
__global__ void __launch_bounds__(S8_THREADS) gemm_s8_kernel(GemmS8Params p) {
  using namespace nvcuda;
  __shared__ __align__(128) int8_t As[2][S8_BK / 16][S8_BM][16];
  __shared__ __align__(128) int8_t Bs[2][S8_BN / 16][S8_BK][16];
  __shared__ __align__(128) int Cs[S8_WARPS][16 * 16];

  // select by value: indexing the parameter arrays with blockIdx.z would
  // copy them to local memory
  const int z = blockIdx.z;
  const int8_t* __restrict__ A = p.a;
  const int8_t* __restrict__ B = z == 0 ? p.b[0] : (z == 1 ? p.b[1] : p.b[2]);
  const int M = p.M, N = p.N, K = p.K;
  const int m0 = blockIdx.y * S8_BM;
  const int n0 = blockIdx.x * S8_BN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 1;   // 4 warps down M, 32 rows each
  const int wn = warp & 1;    // 2 warps across N, 64 columns each

  // Each thread moves one 16-byte vector of A and one of B per k-step.
  const int ar = tid >> 1, ac = tid & 1;     // A: row, k-chunk
  const int br = tid >> 3, bc = tid & 7;     // B: k-row, n-chunk
  uint4 a_reg, b_reg;
  auto load_tile = [&](int k0) {
    const int gr = m0 + ar;
    a_reg = gr < M ? *reinterpret_cast<const uint4*>(A + (size_t)gr * K + k0 + ac * 16)
                   : make_uint4(0u, 0u, 0u, 0u);
    b_reg = *reinterpret_cast<const uint4*>(B + (size_t)(k0 + br) * N + n0 + bc * 16);
  };
  auto store_tile = [&](int buf) {
    *reinterpret_cast<uint4*>(&As[buf][ac][ar][0]) = a_reg;
    *reinterpret_cast<uint4*>(&Bs[buf][bc][br][0]) = b_reg;
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0);

  const int nk = K / S8_BK;
  load_tile(0);
  store_tile(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load_tile((kt + 1) * S8_BK);
#pragma unroll
    for (int kk = 0; kk < S8_BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &As[buf][kk][wm * 32 + i * 16][0], 16);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[buf][wn * 4 + j][kk * 16][0], 16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    // The other buffer was last read in step kt-1, which ended at a barrier.
    if (kt + 1 < nk) store_tile(buf ^ 1);
    __syncthreads();
  }

  // Epilogue: one 16x16 fragment at a time through the warp's staging tile;
  // each lane finishes 8 consecutive columns of one row.
  int* cs = Cs[warp];
  const float* __restrict__ ws = z == 0 ? p.b_scale[0] : (z == 1 ? p.b_scale[1] : p.b_scale[2]);
  const bf16* __restrict__ bias = z == 0 ? p.bias[0] : (z == 1 ? p.bias[1] : p.bias[2]);
  void* out = z == 0 ? p.out[0] : (z == 1 ? p.out[1] : p.out[2]);
  const int r = lane >> 1, c = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + wm * 32 + i * 16 + r;
      const int gc = n0 + wn * 64 + j * 16 + c;
      if (gr < M) {
        const float xs = p.a_scale[gr];
        const float4 w0 = *reinterpret_cast<const float4*>(ws + gc);
        const float4 w1 = *reinterpret_cast<const float4*>(ws + gc + 4);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
        Vec8 bv;
        if (bias != nullptr) bv.u = *reinterpret_cast<const uint4*>(bias + gc);
        float y[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          y[t] = __fmul_rn(__fmul_rn(__int2float_rn(cs[r * 16 + c + t]), xs), wv[t]);
          if (bias != nullptr) y[t] = __fadd_rn(y[t], __bfloat162float(bv.h[t]));
        }
        const size_t at = (size_t)gr * N + gc;
        if (EPI == EPI_S8_GELU_F32) {
          float4* dst = reinterpret_cast<float4*>(static_cast<float*>(out) + at);
          dst[0] = make_float4(gelu_tanh(y[0]), gelu_tanh(y[1]), gelu_tanh(y[2]), gelu_tanh(y[3]));
          dst[1] = make_float4(gelu_tanh(y[4]), gelu_tanh(y[5]), gelu_tanh(y[6]), gelu_tanh(y[7]));
        } else {
          Vec8 o, res;
          if (EPI == EPI_S8_RESIDUAL) res.u = *reinterpret_cast<const uint4*>(p.residual + at);
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            o.h[t] = __float2bfloat16(y[t]);
            if (EPI == EPI_S8_RESIDUAL)
              o.h[t] = __float2bfloat16(__bfloat162float(res.h[t]) + __bfloat162float(o.h[t]));
          }
          *reinterpret_cast<uint4*>(static_cast<bf16*>(out) + at) = o.u;
        }
      }
      __syncwarp();
    }
  }
}

// Shape rules the wrappers check before they call: K % S8_BK == 0,
// N % S8_BN == 0, all pointers 16-byte aligned. M may be ragged.
template <int EPI>
inline cudaError_t launch_gemm_s8(const GemmS8Params& p, int nz, cudaStream_t stream) {
  if (p.N % S8_BN || p.K % S8_BK || p.M < 1 || p.K < S8_BK) return cudaErrorInvalidValue;
  dim3 grid(p.N / S8_BN, (p.M + S8_BM - 1) / S8_BM, nz);
  gemm_s8_kernel<EPI><<<grid, S8_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace emr2a
