// The attention core shared by K3 (attention_block.cu) and K4
// (attention_block_int8.cu): per (item, head),
//   p = softmax(q k^T * hd^-0.5 + mask)   f32 logits and softmax; keys at or
//                                         past valid_len get -1e30; p rounded
//                                         to bf16
//   o = p v                               f32 accumulation
// from bf16 q/k/v. K3 stores o rounded to bf16 (OutT = bf16), the rounding
// point of emr2a_tpu/ops/attention_block.py:_attn_block_kernel; K4 stores it
// in f32 (OutT = float), since _attn_block_kernel_i8 quantizes the f32 P.V.
//
// Design: the block holds one head's K and V (S padded to 16, at most 384)
// in shared memory and gives each of its 4 warps 16 query rows, whose whole
// f32 logits row stays on chip; 16x16x16 bf16 wmma fragments for both
// products. The bf16 probabilities overwrite their own logits row in place.
#pragma once

#include <math_constants.h>
#include <mma.h>

#include "common.cuh"

namespace emr2a {

constexpr int ATT_HD = 64;                 // head dim the core supports
constexpr int ATT_WARPS = 4;
constexpr int ATT_THREADS = ATT_WARPS * 32;
constexpr int ATT_QROWS = ATT_WARPS * 16;  // query rows per block
constexpr int ATT_KV_LD = ATT_HD + 8;      // padded bf16 rows
constexpr int ATT_MAX_SP = 384;            // keys padded to 16, at most this
constexpr int ATT_MAX_COLS = ATT_MAX_SP / 32;
constexpr float ATT_NEG_INF = -1e30f;

// f32 row stride of a warp's logits tile; it also stages the 16 x 64 output
__host__ __device__ inline int logits_ld(int sp) { return (sp > ATT_HD ? sp : ATT_HD) + 8; }

inline int attention_smem_bytes(int sp) {
  return 2 * sp * ATT_KV_LD * 2                    // K, V
         + ATT_WARPS * 16 * ATT_KV_LD * 2          // Q rows of each warp
         + ATT_WARPS * 16 * logits_ld(sp) * 4;     // f32 logits of each warp
}

// 32 consecutive f32 values of the staging tile to the output row
__device__ __forceinline__ void store_row32(bf16* dst, const float* src) {
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    Vec8 o;
#pragma unroll
    for (int t = 0; t < 8; ++t) o.h[t] = __float2bfloat16(src[g * 8 + t]);
    *reinterpret_cast<uint4*>(dst + g * 8) = o.u;
  }
}

__device__ __forceinline__ void store_row32(float* dst, const float* src) {
#pragma unroll
  for (int g = 0; g < 8; ++g)
    reinterpret_cast<float4*>(dst)[g] = reinterpret_cast<const float4*>(src)[g];
}

// grid (ceil(S / 64), heads, B); q/k/v/out are (B*S, d) with head h in
// columns [h*64, h*64+64).
template <typename OutT>
__global__ void __launch_bounds__(ATT_THREADS)
attention_core_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, OutT* __restrict__ out, int S, int d,
                      int valid_len, float scale, int sp) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ls_ld = logits_ld(sp);
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + sp * ATT_KV_LD;
  bf16* Qs = Vs + sp * ATT_KV_LD;
  float* Ls = reinterpret_cast<float*>(Qs + ATT_WARPS * 16 * ATT_KV_LD);

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * ATT_QROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t base = (size_t)b * S * d + (size_t)h * ATT_HD;

  // K and V of this (item, head): rows past S are zero (and masked below).
  for (int i = tid; i < sp * (ATT_HD / 8); i += ATT_THREADS) {
    const int r = i >> 3, c = (i & 7) * 8;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
    if (r < S) {
      kv = *reinterpret_cast<const uint4*>(k + base + (size_t)r * d + c);
      vv = *reinterpret_cast<const uint4*>(v + base + (size_t)r * d + c);
    }
    *reinterpret_cast<uint4*>(Ks + r * ATT_KV_LD + c) = kv;
    *reinterpret_cast<uint4*>(Vs + r * ATT_KV_LD + c) = vv;
  }
  const int row0 = q0 + warp * 16;
  bf16* qs = Qs + warp * 16 * ATT_KV_LD;
  for (int i = lane; i < 16 * (ATT_HD / 8); i += 32) {
    const int r = i >> 3, c = (i & 7) * 8;
    uint4 qv = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) qv = *reinterpret_cast<const uint4*>(q + base + (size_t)(row0 + r) * d + c);
    *reinterpret_cast<uint4*>(qs + r * ATT_KV_LD + c) = qv;
  }
  __syncthreads();
  if (row0 >= S) return;  // no barrier follows

  // logits (16 x sp) = q k^T, f32, into this warp's rows of Ls
  float* ls = Ls + warp * 16 * ls_ld;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fq[ATT_HD / 16];
#pragma unroll
  for (int kk = 0; kk < ATT_HD / 16; ++kk)
    wmma::load_matrix_sync(fq[kk], qs + kk * 16, ATT_KV_LD);
  for (int n = 0; n < sp; n += 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < ATT_HD / 16; ++kk) {
      // k^T as a column-major (64 x 16) operand: element (c, n) at Ks[n][c]
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fk;
      wmma::load_matrix_sync(fk, Ks + n * ATT_KV_LD + kk * 16, ATT_KV_LD);
      wmma::mma_sync(acc, fq[kk], fk, acc);
    }
    wmma::store_matrix_sync(ls + n, acc, ls_ld, wmma::mem_row_major);
  }
  __syncwarp();

  // Softmax row by row in f32; the bf16 probabilities overwrite the front
  // half of their own f32 row (read fully into registers first).
  bf16* ps = reinterpret_cast<bf16*>(ls);
  const int ps_ld = 2 * ls_ld;
  for (int r = 0; r < 16; ++r) {
    float vals[ATT_MAX_COLS];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int t = 0; t < ATT_MAX_COLS; ++t) {
      const int c = lane + 32 * t;
      float l = -CUDART_INF_F;
      if (c < sp) {
        l = ls[r * ls_ld + c] * scale;
        if (c >= valid_len) l += ATT_NEG_INF;
      }
      vals[t] = l;
      mx = fmaxf(mx, l);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < ATT_MAX_COLS; ++t) {
      const float e = (lane + 32 * t < sp) ? expf(vals[t] - mx) : 0.f;
      vals[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    __syncwarp();
#pragma unroll
    for (int t = 0; t < ATT_MAX_COLS; ++t) {
      const int c = lane + 32 * t;
      if (c < sp) ps[r * ps_ld + c] = __float2bfloat16(vals[t] / sum);
    }
    __syncwarp();
  }

  // o (16 x 64) = p v, f32 accumulation
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> fo[ATT_HD / 16];
#pragma unroll
  for (int j = 0; j < ATT_HD / 16; ++j) wmma::fill_fragment(fo[j], 0.f);
  for (int kk = 0; kk < sp; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp;
    wmma::load_matrix_sync(fp, ps + kk, ps_ld);
#pragma unroll
    for (int j = 0; j < ATT_HD / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
      wmma::load_matrix_sync(fv, Vs + kk * ATT_KV_LD + j * 16, ATT_KV_LD);
      wmma::mma_sync(fo[j], fp, fv, fo[j]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < ATT_HD / 16; ++j)
    wmma::store_matrix_sync(ls + j * 16, fo[j], ATT_HD, wmma::mem_row_major);
  __syncwarp();
  {
    const int r = lane >> 1, c = (lane & 1) * 32;
    if (row0 + r < S) store_row32(out + base + (size_t)(row0 + r) * d + c, ls + r * ATT_HD + c);
  }
}

// Rules the wrappers check: head dim 64 (d == heads * 64), S <= 384,
// 1 <= valid_len (clipped to S).
template <typename OutT>
inline cudaError_t launch_attention_core(const bf16* q, const bf16* k, const bf16* v, OutT* out,
                                         int B, int S, int d, int num_heads, int valid_len,
                                         cudaStream_t stream) {
  if (valid_len > S) valid_len = S;
  const int sp = (S + 15) / 16 * 16;
  if (sp > ATT_MAX_SP || d != num_heads * ATT_HD || valid_len < 1 || B < 1)
    return cudaErrorInvalidValue;
  const int smem = attention_smem_bytes(sp);
  cudaError_t err = cudaFuncSetAttribute(attention_core_kernel<OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + ATT_QROWS - 1) / ATT_QROWS, num_heads, B);
  attention_core_kernel<OutT><<<grid, ATT_THREADS, smem, stream>>>(
      q, k, v, out, S, d, valid_len, 1.0f / sqrtf((float)ATT_HD), sp);
  return cudaGetLastError();
}

}  // namespace emr2a
