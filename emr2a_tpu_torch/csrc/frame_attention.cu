// Per-frame (per-item) non-causal softmax attention for Hopper (sm_90a), one
// kernel behind two entry points:
//
//   K8  emr2a_frame_attention  replaces emr2a_tpu/ops/vision_flash.py:
//       frame_flash_attention (JAX's library TPU flash kernel): q, k, v
//       (F, S, H, hd) post-RoPE, the Qwen3-VL vision tower's uniform
//       frame-batched layout (F = 7, S = 1024, H = 16, hd = 72 for the 8B
//       judge's 7-image audit prompts);
//   K9  emr2a_fused_attention  replaces emr2a_tpu/ops/attention.py:
//       fused_attention (_attn_kernel): the same function on (B, S, H, D),
//       keys at or past S masked (ViT-B: 197 tokens, 12 heads of 64).
//
//   out[f, i, h] = sum_j softmax_j(q[f,i,h] . k[f,j,h] * scale) v[f,j,h]
//
// logits, running max and running sum in f32; probabilities rounded to bf16
// for the P.V product, which accumulates in f32; the output is rounded to
// bf16 once, after the division by the sum.
//
// Bound on the H100: 4*F*H*S*S*hd bf16 operations (K8 at the judge's shape:
// 33.8 GFLOP, 34 us at 989 TFLOP/s); K9 at ViT-B batch 32 moves more bytes
// than it computes (q, k, v and out, 38.7 MB, 11.6 us).
//
// Design: a streaming online-softmax ("flash") kernel. One head's K and V at
// S = 1024, hd = 72 take 295 KB in bf16, more than a block's 227 KB of shared
// memory, so K and V stream through shared memory in tiles of 64 keys. A
// block of 4 warps owns 64 query rows of one (frame, head); each warp keeps
// its 16 rows of Q, its 16 x 64 logits tile and its 16 x hd output in
// registers, in the fragment layouts of mma.sync m16n8k16 (bf16 in, f32
// accumulate), so the probabilities go from the logits accumulators straight
// into the A operand of P.V. The head dim is padded to a multiple of 16 in
// shared memory with zeros (72 -> 80, not 128: the TPU kernel lost 44 % of its
// matrix lanes to its 128 pad). Keys at or past S are masked by bounds; no
// padded copy of the inputs is made. V is stored transposed in shared memory
// so that the B operand of P.V is a 32-bit load. No TMA, wgmma or
// double-buffering yet: this is the simple first version.
#include <math_constants.h>

#include "common.cuh"

namespace emr2a {

constexpr int FA_BQ = 64;  // query rows per block
constexpr int FA_BK = 64;  // keys per tile
constexpr int FA_THREADS = 128;
constexpr int FA_VLD = FA_BK + 8;

__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// grid (ceil(S / 64), H, F); HDP = hd rounded up to 16.
template <int HDP>
__global__ void __launch_bounds__(FA_THREADS)
frame_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out, int S, int H, int hd,
                       float scale) {
  constexpr int KLD = HDP + 8;
  __shared__ __align__(16) bf16 Ks[FA_BK][KLD];
  __shared__ __align__(16) bf16 Vt[HDP][FA_VLD];

  const int f = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * FA_BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const size_t ld = (size_t)H * hd;  // elements between consecutive tokens
  const size_t base = (size_t)f * S * ld + (size_t)h * hd;

  // the pad columns (hd .. HDP) stay zero: tiles overwrite only columns < hd
  for (int i = tid; i < FA_BK * KLD; i += FA_THREADS) (&Ks[0][0])[i] = __float2bfloat16(0.f);
  for (int i = tid; i < HDP * FA_VLD; i += FA_THREADS) (&Vt[0][0])[i] = __float2bfloat16(0.f);

  // this warp's 16 query rows as A fragments, straight from device memory
  const int r0 = q0 + warp * 16 + gq, r1 = r0 + 8;
  uint32_t qa[HDP / 16][4];
#pragma unroll
  for (int kc = 0; kc < HDP / 16; ++kc)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = (e & 1) ? r1 : r0;
      const int col = kc * 16 + tq * 2 + ((e & 2) ? 8 : 0);
      qa[kc][e] = (row < S && col < hd)
                      ? *reinterpret_cast<const uint32_t*>(q + base + (size_t)row * ld + col)
                      : 0u;
    }

  float o[HDP / 8][4];
#pragma unroll
  for (int dt = 0; dt < HDP / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

  const int vecs = hd / 8;
  for (int k0 = 0; k0 < S; k0 += FA_BK) {
    __syncthreads();  // the previous tile has been read by every warp
    for (int i = tid; i < FA_BK * vecs; i += FA_THREADS) {
      const int r = i / vecs, c = (i - r * vecs) * 8;
      Vec8 kv, vv;
      kv.u = vv.u = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < S) {
        kv.u = *reinterpret_cast<const uint4*>(k + base + (size_t)(k0 + r) * ld + c);
        vv.u = *reinterpret_cast<const uint4*>(v + base + (size_t)(k0 + r) * ld + c);
      }
      *reinterpret_cast<uint4*>(&Ks[r][c]) = kv.u;
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[c + j][r] = vv.h[j];
    }
    __syncthreads();

    // logits (16 x 64) = q k^T
    float s[FA_BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < FA_BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < HDP / 16; ++kc)
#pragma unroll
      for (int nt = 0; nt < FA_BK / 8; ++nt) {
        const bf16* kr = &Ks[nt * 8 + gq][kc * 16 + tq * 2];
        mma_bf16_16816(s[nt], qa[kc], *reinterpret_cast<const uint32_t*>(kr),
                       *reinterpret_cast<const uint32_t*>(kr + 8));
      }

    // scale, mask, row max (rows gq and gq + 8; a quad of lanes shares a row)
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int nt = 0; nt < FA_BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + tq * 2 + (e & 1);
        const float val = key < S ? s[nt][e] * scale : -CUDART_INF_F;
        s[nt][e] = val;
        if (e < 2) mx0 = fmaxf(mx0, val);
        else mx1 = fmaxf(mx1, val);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // every tile holds key k0 < S, so the new maxima are finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < FA_BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - (e < 2 ? mn0 : mn1));
        s[nt][e] = p;
        if (e < 2) sum0 += p;
        else sum1 += p;
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int dt = 0; dt < HDP / 8; ++dt) {
      o[dt][0] *= a0;
      o[dt][1] *= a0;
      o[dt][2] *= a1;
      o[dt][3] *= a1;
    }

    // o (16 x HDP) += p v, the probabilities in bf16
#pragma unroll
    for (int kc = 0; kc < FA_BK / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dt = 0; dt < HDP / 8; ++dt) {
        const bf16* vr = &Vt[dt * 8 + gq][kc * 16 + tq * 2];
        mma_bf16_16816(o[dt], pa, *reinterpret_cast<const uint32_t*>(vr),
                       *reinterpret_cast<const uint32_t*>(vr + 8));
      }
    }
  }

#pragma unroll
  for (int dt = 0; dt < HDP / 8; ++dt) {
    const int col = dt * 8 + tq * 2;
    if (col >= hd) continue;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(out + base + (size_t)r0 * ld + col) =
          __floats2bfloat162_rn(__fdiv_rn(o[dt][0], l0), __fdiv_rn(o[dt][1], l0));
    if (r1 < S)
      *reinterpret_cast<__nv_bfloat162*>(out + base + (size_t)r1 * ld + col) =
          __floats2bfloat162_rn(__fdiv_rn(o[dt][2], l1), __fdiv_rn(o[dt][3], l1));
  }
}

template <int HDP>
cudaError_t launch_frame_attention_hdp(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                                       int F, int S, int H, int hd, float scale,
                                       cudaStream_t st) {
  dim3 grid((S + FA_BQ - 1) / FA_BQ, H, F);
  frame_attention_kernel<HDP><<<grid, FA_THREADS, 0, st>>>(q, k, v, out, S, H, hd, scale);
  return cudaGetLastError();
}

// Rules the wrappers check: F, S, H >= 1; hd % 8 == 0 and hd <= 128;
// contiguous (F, S, H, hd) bf16 tensors, 16-byte aligned.
inline cudaError_t launch_frame_attention(const void* q, const void* k, const void* v, void* out,
                                          int F, int S, int H, int hd, float scale,
                                          cudaStream_t st) {
  if (F < 1 || S < 1 || H < 1 || hd < 8 || hd > 128 || hd % 8) return cudaErrorInvalidValue;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(out);
  switch ((hd + 15) / 16) {
    case 1: return launch_frame_attention_hdp<16>(qp, kp, vp, op, F, S, H, hd, scale, st);
    case 2: return launch_frame_attention_hdp<32>(qp, kp, vp, op, F, S, H, hd, scale, st);
    case 3: return launch_frame_attention_hdp<48>(qp, kp, vp, op, F, S, H, hd, scale, st);
    case 4: return launch_frame_attention_hdp<64>(qp, kp, vp, op, F, S, H, hd, scale, st);
    case 5: return launch_frame_attention_hdp<80>(qp, kp, vp, op, F, S, H, hd, scale, st);
    case 6: return launch_frame_attention_hdp<96>(qp, kp, vp, op, F, S, H, hd, scale, st);
    case 7: return launch_frame_attention_hdp<112>(qp, kp, vp, op, F, S, H, hd, scale, st);
    default: return launch_frame_attention_hdp<128>(qp, kp, vp, op, F, S, H, hd, scale, st);
  }
}

}  // namespace emr2a

using namespace emr2a;

// K8: q, k, v, out (F, S, H, hd) bf16.
extern "C" int emr2a_frame_attention(const void* q, const void* k, const void* v, void* out,
                                     int F, int S, int H, int hd, float scale, void* stream) {
  return static_cast<int>(launch_frame_attention(q, k, v, out, F, S, H, hd, scale,
                                                 reinterpret_cast<cudaStream_t>(stream)));
}

// K9: q, k, v, out (B, S, H, D) bf16.
extern "C" int emr2a_fused_attention(const void* q, const void* k, const void* v, void* out,
                                     int B, int S, int H, int D, float scale, void* stream) {
  return static_cast<int>(launch_frame_attention(q, k, v, out, B, S, H, D, scale,
                                                 reinterpret_cast<cudaStream_t>(stream)));
}
