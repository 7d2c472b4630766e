// bf16 tensor-core GEMM written by hand for Hopper (sm_90a), shared by the
// fused LN+MLP (mlp.cu) and fused LN+attention (attention_block.cu) kernels.
//
//   out[z] = epilogue(prologue(A) @ B[z] + bias[z])      z = blockIdx.z < 3
//
// A is (M, K) row-major bf16, each B[z] is (K, N) row-major bf16: the JAX
// package's (in, out) weight layout, so weights need no transpose.
//
// Prologue (LN = true): LayerNorm over A's rows with f32 statistics; the
// normalised row is rounded to bf16 before the product, the rounding point
// of emr2a_tpu/ops/mlp.py:_mlp_kernel and ops/attention_block.py.
//
// Epilogues, all on the f32 accumulator:
//   EPI_BIAS           bf16(acc + bias)                  (Q/K/V projections)
//   EPI_BIAS_GELU      bf16(gelu_tanh(acc + bias))       (MLP fc1)
//   EPI_BIAS_RESIDUAL  residual + bf16(acc + bias)       (fc2 / out-proj)
//   EPI_BIAS_GELU_BF16 bf16(gelu_tanh_bf16(bf16(acc + bias)))
//                                                        (fc1, act_dtype=bf16)
//
// Design: 128x128 block tile, 32-deep k-steps, 8 warps each owning a 32x64
// sub-tile of 16x16x16 wmma fragments with f32 accumulation. The next
// k-step's tiles are prefetched into registers while the tensor cores work
// on the current shared-memory buffer (two buffers, one barrier per step).
// No TMA, wgmma or warp specialisation yet: this is the simple first version.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace emr2a {

enum Epilogue { EPI_BIAS = 0, EPI_BIAS_GELU = 1, EPI_BIAS_RESIDUAL = 2, EPI_BIAS_GELU_BF16 = 3 };

constexpr int GEMM_BM = 128;
constexpr int GEMM_BN = 128;
constexpr int GEMM_BK = 32;
constexpr int GEMM_THREADS = 256;
constexpr int GEMM_WARPS = GEMM_THREADS / 32;
constexpr int GEMM_A_LD = GEMM_BK + 8;   // padded rows against bank conflicts
constexpr int GEMM_B_LD = GEMM_BN + 8;

struct GemmParams {
  const bf16* a;          // (M, K)
  const bf16* b[3];       // (K, N) per blockIdx.z
  const bf16* bias[3];    // (N,)
  bf16* out[3];           // (M, N)
  const bf16* residual;   // (M, N), EPI_BIAS_RESIDUAL only
  const bf16* ln_scale;   // (K,), LN prologue only
  const bf16* ln_bias;    // (K,)
  float eps;
  int M, N, K;
};

template <int EPI, bool LN>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_bf16_kernel(GemmParams p) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 As[2][GEMM_BM][GEMM_A_LD];
  __shared__ __align__(128) bf16 Bs[2][GEMM_BK][GEMM_B_LD];
  __shared__ __align__(128) float Cs[GEMM_WARPS][16 * 16];
  __shared__ float row_mu[GEMM_BM];
  __shared__ float row_rstd[GEMM_BM];

  // select by value: indexing the parameter arrays with blockIdx.z would
  // copy them to local memory
  const int z = blockIdx.z;
  const bf16* __restrict__ A = p.a;
  const bf16* __restrict__ B = z == 0 ? p.b[0] : (z == 1 ? p.b[1] : p.b[2]);
  const int M = p.M, N = p.N, K = p.K;
  const int m0 = blockIdx.y * GEMM_BM;
  const int n0 = blockIdx.x * GEMM_BN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 1;   // 4 warps down M, 32 rows each
  const int wn = warp & 1;    // 2 warps across N, 64 columns each

  if (LN) {
    // Row statistics in f32, two passes (mean, then centred variance) as
    // the JAX kernel computes them. Rows are re-read from L2.
    for (int r = warp; r < GEMM_BM; r += GEMM_WARPS) {
      const int gr = m0 + r;
      float mu = 0.f, rstd = 0.f;
      if (gr < M) {
        const bf16* row = A + (size_t)gr * K;
        float s = 0.f;
        for (int k = lane * 8; k < K; k += 32 * 8) {
          Vec8 v;
          v.u = *reinterpret_cast<const uint4*>(row + k);
#pragma unroll
          for (int t = 0; t < 8; ++t) s += __bfloat162float(v.h[t]);
        }
        mu = warp_sum(s) / (float)K;
        float q = 0.f;
        for (int k = lane * 8; k < K; k += 32 * 8) {
          Vec8 v;
          v.u = *reinterpret_cast<const uint4*>(row + k);
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const float dv = __bfloat162float(v.h[t]) - mu;
            q += dv * dv;
          }
        }
        rstd = rsqrtf(warp_sum(q) / (float)K + p.eps);
      }
      if (lane == 0) {
        row_mu[r] = mu;
        row_rstd[r] = rstd;
      }
    }
    __syncthreads();
  }

  // Each thread moves two 16-byte vectors of A and two of B per k-step.
  Vec8 a_reg[2], b_reg[2];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * GEMM_THREADS;
      const int r = v >> 2, c = (v & 3) * 8;
      const int gr = m0 + r;
      if (gr < M) {
        a_reg[i].u = *reinterpret_cast<const uint4*>(A + (size_t)gr * K + k0 + c);
      } else {
        a_reg[i].u = make_uint4(0u, 0u, 0u, 0u);
      }
      const int br = v >> 4, bc = (v & 15) * 8;
      b_reg[i].u = *reinterpret_cast<const uint4*>(B + (size_t)(k0 + br) * N + n0 + bc);
    }
  };
  auto store_tile = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * GEMM_THREADS;
      const int r = v >> 2, c = (v & 3) * 8;
      if (LN && m0 + r < M) {
        const float mu = row_mu[r], rstd = row_rstd[r];
        Vec8 s, b;
        s.u = *reinterpret_cast<const uint4*>(p.ln_scale + k0 + c);
        b.u = *reinterpret_cast<const uint4*>(p.ln_bias + k0 + c);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float h = (__bfloat162float(a_reg[i].h[t]) - mu) * rstd *
                              __bfloat162float(s.h[t]) +
                          __bfloat162float(b.h[t]);
          a_reg[i].h[t] = __float2bfloat16(h);
        }
      }
      *reinterpret_cast<uint4*>(&As[buf][r][c]) = a_reg[i].u;
      const int br = v >> 4, bc = (v & 15) * 8;
      *reinterpret_cast<uint4*>(&Bs[buf][br][bc]) = b_reg[i].u;
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = K / GEMM_BK;
  load_tile(0);
  store_tile(0, 0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load_tile((kt + 1) * GEMM_BK);
#pragma unroll
    for (int kk = 0; kk < GEMM_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &As[buf][wm * 32 + i * 16][kk], GEMM_A_LD);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[buf][kk][wn * 64 + j * 16], GEMM_B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    // The other buffer was last read in step kt-1, which ended at a barrier.
    if (kt + 1 < nk) store_tile(buf ^ 1, (kt + 1) * GEMM_BK);
    __syncthreads();
  }

  // Epilogue: one 16x16 fragment at a time through the warp's staging tile;
  // each lane finishes 8 consecutive columns of one row (one 16-byte store).
  float* cs = Cs[warp];
  const bf16* __restrict__ bias = z == 0 ? p.bias[0] : (z == 1 ? p.bias[1] : p.bias[2]);
  bf16* __restrict__ out = z == 0 ? p.out[0] : (z == 1 ? p.out[1] : p.out[2]);
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
        Vec8 bv, o;
        bv.u = *reinterpret_cast<const uint4*>(bias + gc);
        Vec8 res;
        if (EPI == EPI_BIAS_RESIDUAL)
          res.u = *reinterpret_cast<const uint4*>(p.residual + (size_t)gr * N + gc);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          float v = cs[r * 16 + c + t] + __bfloat162float(bv.h[t]);
          if (EPI == EPI_BIAS_GELU) v = gelu_tanh(v);
          if (EPI == EPI_BIAS_GELU_BF16) v = gelu_tanh_bf16(round_bf16(v));
          o.h[t] = __float2bfloat16(v);
          if (EPI == EPI_BIAS_RESIDUAL)
            o.h[t] = __float2bfloat16(__bfloat162float(res.h[t]) + __bfloat162float(o.h[t]));
        }
        *reinterpret_cast<uint4*>(out + (size_t)gr * N + gc) = o.u;
      }
      __syncwarp();
    }
  }
}

// Shape rules the wrappers check before they call: K % GEMM_BK == 0,
// N % GEMM_BN == 0, all pointers 16-byte aligned. M may be ragged.
template <int EPI, bool LN>
inline cudaError_t launch_gemm(const GemmParams& p, int nz, cudaStream_t stream) {
  if (p.N % GEMM_BN || p.K % GEMM_BK || p.M < 1) return cudaErrorInvalidValue;
  dim3 grid(p.N / GEMM_BN, (p.M + GEMM_BM - 1) / GEMM_BM, nz);
  gemm_bf16_kernel<EPI, LN><<<grid, GEMM_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace emr2a
