// The attention core shared by K3 (attention_block.cu) and K4
// (attention_block_int8.cu), the softmax attention inside
// emr2a_tpu/ops/attention_block.py:_attn_block_kernel (:102) and
// _attn_block_kernel_i8. Per (item, head), from bf16 q/k/v with head dim 64:
//   logits = q k^T * hd^-0.5             f32; keys at or past valid_len get
//                                        -1e30
//   p = bf16(exp(logits - max) / sum)    the exact row max; p normalised
//                                        before it is rounded (the TPU
//                                        kernels' rounding point)
//   o = p v                              f32 accumulation
// K3 stores o rounded to bf16 (OutT = bf16); K4 stores it in f32 (OutT =
// float), since _attn_block_kernel_i8 quantizes the unrounded P.V.
//
// Bound on the H100: 4*B*H*S*valid_len*64 bf16 operations against the bytes
// of q, k, v and o (ViT-B at batch 32, S = 200: 3.9 GFLOP and 39 MB, the
// bytes bound it at 12 us).
//
// Design: any sequence length, in two passes over 64-key tiles, with the
// logits in registers only. A block of 8 warps owns 128 query rows of one
// (item, head), 16 a warp, so at S = 200 each head's K/V is read by two
// blocks. Pass 1 computes each tile's logits and carries each row's running
// max and sum (rescaled as the max grows); pass 2 recomputes them, forms p =
// bf16(exp2(logit - max) / sum) straight into the A fragments of P.V
// (FlashAttention-2's register reuse) and accumulates o, which needs no
// rescale. Products run on mma.sync m16n8k16 (bf16 in, f32 accumulate); K
// fragments come by ldmatrix, V fragments by ldmatrix.trans. The K/V tiles
// live in shared memory with the 128-byte swizzle (chunk c of key row r at
// chunk c ^ (r % 8), free of bank conflicts for ldmatrix), 16 KB a tile
// pair in 4 slots (64 KB a block, so two blocks, 16 warps, share an SM):
// up to 256 valid keys, K and V are loaded once by cp.async and stay for
// both passes; past that they stream from L2 through the slots as a ring (K
// alone in pass 1, K and V in pass 2), two tiles in flight. Only tiles
// holding a key below valid_len are visited: a masked key's probability is
// exactly 0 in f32 (exp of about -1e30), so -inf stands for the -1e30 mask.
#pragma once

#include <math_constants.h>

#include "flash.cuh"

namespace emr2a {

constexpr int ATT_HD = 64;                      // head dim the core supports
constexpr int ATT_WARPS = 8;
constexpr int ATT_THREADS = ATT_WARPS * 32;
constexpr int ATT_BQ = ATT_WARPS * 16;          // query rows a block
constexpr int ATT_BK = 64;                      // keys a tile
constexpr int ATT_SLOTS = 4;                    // K/V tiles in shared memory
constexpr int ATT_TILE = ATT_BK * ATT_HD * 2;   // bytes of one K or V tile
constexpr int ATT_SMEM = ATT_SLOTS * 2 * ATT_TILE;

// the byte offset of 16-byte chunk c of row r in a swizzled tile
__device__ __forceinline__ int att_swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// keys k0 .. k0 + 63 of K (and V) into a slot, zero past S
__device__ __forceinline__ void att_issue(uint8_t* ks, uint8_t* vs, const bf16* k, const bf16* v,
                                          size_t base, int d, int k0, int S, bool with_v,
                                          int tid) {
#pragma unroll
  for (int j = 0; j < ATT_BK * 8 / ATT_THREADS; ++j) {
    const int r = (tid + j * ATT_THREADS) >> 3, c = tid & 7;
    const bool ok = k0 + r < S;
    const size_t off = ok ? base + static_cast<size_t>(k0 + r) * d + c * 8 : 0;
    const int n = ok ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     fa_smem_u32(ks + att_swz(r, c))),
                 "l"(k + off), "r"(n));
    if (with_v)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       fa_smem_u32(vs + att_swz(r, c))),
                   "l"(v + off), "r"(n));
  }
}

// this warp's logits (16 rows x 64 keys, m16n8 C fragments) of the tile at
// ks, keys at or past valid_len (k0 + key) set to -inf
__device__ __forceinline__ void att_logits(float (&s)[ATT_BK / 8][4],
                                           const uint32_t (&qa)[ATT_HD / 16][4], const uint8_t* ks,
                                           int k0, int valid_len, int lane) {
  const int tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < ATT_BK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < ATT_HD / 16; ++kc) {
    uint32_t b[ATT_BK / 16][4];
#pragma unroll
    for (int np = 0; np < ATT_BK / 16; ++np) {
      const int key = (2 * np + (lane >> 4)) * 8 + (lane & 7);
      fa_ldmatrix_x4(b[np], ks + att_swz(key, kc * 2 + ((lane >> 3) & 1)));
    }
#pragma unroll
    for (int np = 0; np < ATT_BK / 16; ++np) {
      mma_bf16_16816(s[2 * np], qa[kc], b[np][0], b[np][1]);
      mma_bf16_16816(s[2 * np + 1], qa[kc], b[np][2], b[np][3]);
    }
  }
  if (k0 + ATT_BK > valid_len) {
#pragma unroll
    for (int nt = 0; nt < ATT_BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + nt * 8 + tq * 2 + (e & 1) >= valid_len) s[nt][e] = -CUDART_INF_F;
  }
}

__device__ __forceinline__ void att_store2(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void att_store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

// grid (ceil(S / 128), heads, B); q/k/v/out are (B*S, d) with head h in
// columns [h*64, h*64+64).
template <typename OutT>
__global__ void __launch_bounds__(ATT_THREADS, 2)
attention_core_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, OutT* __restrict__ out, int S, int d,
                      int valid_len, float scale_log2) {
  extern __shared__ __align__(128) uint8_t att_smem[];
  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const size_t base = static_cast<size_t>(b) * S * d + static_cast<size_t>(h) * ATT_HD;
  const int nt = (valid_len + ATT_BK - 1) / ATT_BK;   // tiles holding a valid key
  const bool resident = nt <= ATT_SLOTS;
  const int loads = resident ? nt : 2 * nt;
  auto slot = [&](int i) { return att_smem + (i % ATT_SLOTS) * 2 * ATT_TILE; };
  // load i: tile i % nt, with V when resident or in pass 2
  auto issue = [&](int i) {
    uint8_t* st = slot(i);
    att_issue(st, st + ATT_TILE, k, v, base, d, (i % nt) * ATT_BK, S, resident || i >= nt, tid);
  };
  const int ahead = resident ? nt : ATT_SLOTS - 1;
  for (int i = 0; i < ahead; ++i) {
    if (i < loads) issue(i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // this warp's 16 query rows as A fragments, straight from device memory
  const int row0 = blockIdx.x * ATT_BQ + warp * 16;
  const bool active = row0 < S;
  uint32_t qa[ATT_HD / 16][4];
#pragma unroll
  for (int kc = 0; kc < ATT_HD / 16; ++kc)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + gq + ((e & 1) ? 8 : 0);
      const int col = kc * 16 + tq * 2 + ((e & 2) ? 8 : 0);
      qa[kc][e] = row < S ? *reinterpret_cast<const uint32_t*>(q + base + static_cast<size_t>(row) * d + col)
                          : 0u;
    }

  float o[ATT_HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < ATT_HD / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  // rows gq and gq + 8: the running max (log2 domain) and sum of pass 1,
  // then the max and 1 / sum of pass 2
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

  for (int i = 0; i < 2 * nt; ++i) {
    if (!resident) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(ATT_SLOTS - 2) : "memory");
      __syncthreads();  // load i has landed; every warp is done with load i - 1
      if (i + ATT_SLOTS - 1 < loads) issue(i + ATT_SLOTS - 1);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    } else if (i == 0) {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
    }
    if (!active) continue;
    const int t = i % nt;
    const uint8_t* ks = resident ? slot(t) : slot(i);
    float s[ATT_BK / 8][4];
    att_logits(s, qa, ks, t * ATT_BK, valid_len, lane);

    if (i < nt) {
      // pass 1: the tile's row max (a quad of lanes shares a row), then the
      // running max and the rescaled running sum; tile 0 holds key 0, so
      // the max is finite from the first tile on
      float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < ATT_BK / 8; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0 * scale_log2), mn1 = fmaxf(m1, mx1 * scale_log2);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < ATT_BK / 8; ++n) {
        sum0 += fa_exp2(fmaf(s[n][0], scale_log2, -mn0)) + fa_exp2(fmaf(s[n][1], scale_log2, -mn0));
        sum1 += fa_exp2(fmaf(s[n][2], scale_log2, -mn1)) + fa_exp2(fmaf(s[n][3], scale_log2, -mn1));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
      }
      l0 = l0 * fa_exp2(m0 - mn0) + sum0;
      l1 = l1 * fa_exp2(m1 - mn1) + sum1;
      m0 = mn0;
      m1 = mn1;
      if (i == nt - 1) {
        l0 = 1.0f / l0;
        l1 = 1.0f / l1;
      }
      continue;
    }

    // pass 2: the normalised probabilities in bf16 as P.V's A fragments,
    // then o += p v
    uint32_t pa[ATT_BK / 16][4];
#pragma unroll
    for (int kc = 0; kc < ATT_BK / 16; ++kc) {
      float p[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[half][e] = fa_exp2(fmaf(s[2 * kc + half][e], scale_log2, -(e < 2 ? m0 : m1))) *
                       (e < 2 ? l0 : l1);
      pa[kc][0] = pack_bf16(p[0][0], p[0][1]);
      pa[kc][1] = pack_bf16(p[0][2], p[0][3]);
      pa[kc][2] = pack_bf16(p[1][0], p[1][1]);
      pa[kc][3] = pack_bf16(p[1][2], p[1][3]);
    }
    const uint8_t* vs = ks + ATT_TILE;
#pragma unroll
    for (int kc = 0; kc < ATT_BK / 16; ++kc) {
      uint32_t bv[ATT_HD / 16][4];
      const int key = kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dp = 0; dp < ATT_HD / 16; ++dp)
        fa_ldmatrix_x4_trans(bv[dp], vs + att_swz(key, dp * 2 + (lane >> 4)));
#pragma unroll
      for (int dp = 0; dp < ATT_HD / 16; ++dp) {
        mma_bf16_16816(o[2 * dp], pa[kc], bv[dp][0], bv[dp][1]);
        mma_bf16_16816(o[2 * dp + 1], pa[kc], bv[dp][2], bv[dp][3]);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  if (!active) return;

  const int r0 = row0 + gq, r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < ATT_HD / 8; ++dt) {
    const int col = dt * 8 + tq * 2;
    if (r0 < S) att_store2(out + base + static_cast<size_t>(r0) * d + col, o[dt][0], o[dt][1]);
    if (r1 < S) att_store2(out + base + static_cast<size_t>(r1) * d + col, o[dt][2], o[dt][3]);
  }
}

// Rules the wrappers check: head dim 64 (d == heads * 64), S >= 1,
// 1 <= valid_len (clipped to S).
template <typename OutT>
inline cudaError_t launch_attention_core(const bf16* q, const bf16* k, const bf16* v, OutT* out,
                                         int B, int S, int d, int num_heads, int valid_len,
                                         cudaStream_t stream) {
  if (valid_len > S) valid_len = S;
  if (d != num_heads * ATT_HD || valid_len < 1 || B < 1) return cudaErrorInvalidValue;
  static std::atomic<uint64_t> sized{0};   // the devices whose attribute is set
  const cudaError_t err = smem_attr_once(attention_core_kernel<OutT>, ATT_SMEM, sized);
  if (err != cudaSuccess) return err;
  dim3 grid((S + ATT_BQ - 1) / ATT_BQ, num_heads, B);
  attention_core_kernel<OutT><<<grid, ATT_THREADS, ATT_SMEM, stream>>>(
      q, k, v, out, S, d, valid_len, 1.4426950408889634f / sqrtf(static_cast<float>(ATT_HD)));
  return cudaGetLastError();
}

}  // namespace emr2a
