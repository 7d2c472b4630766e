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
// Design: a streaming online-softmax ("flash") kernel, FlashAttention-2's
// schedule on mma.sync. One head's K and V at S = 1024, hd = 72 take 295 KB
// in bf16, more than a block's 227 KB of shared memory, so K and V stream
// through a 3-stage ring of 64-key tiles filled by cp.async (zero-filled
// past S): tile t + 2 is in flight while tile t is computed, with one
// __syncthreads per tile. A block of 8 warps owns 256 query rows of one
// (frame, head) for S >= 512 (4 warps and 128 rows for shorter sequences,
// 64 rows for hd > 96), so each K/V tile read from L2 serves 256 rows; each
// warp keeps its 32 rows of Q, their 32 x 64 logits and their
// 32 x hd output in registers, in the fragment layouts of mma.sync m16n8k16
// (bf16 in, f32 accumulate), so that every K or V fragment read by ldmatrix
// feeds two MMAs, and the probabilities go from the logits accumulators
// straight into the A operand of P.V. With hd = 72 the ninth output column
// tile is computed alone, not with a zero pad tile. K fragments come by ldmatrix, V fragments by
// ldmatrix.trans from V as stored (no transpose in shared memory); the rows
// of both are padded by 16 bytes, which makes every ldmatrix free of bank
// conflicts. The fragments of a step are loaded together ahead of its MMAs
// (ldmatrix and mma issue in program order). The head dim is padded to a
// multiple of 16 with zeros in shared memory (72 -> 80: wgmma's and mma's
// bf16 depth is 16). The softmax runs in the log2 domain: the scale times
// log2(e) is folded into one FFMA with the running maximum, the
// exponentials are ex2.approx, and only a ragged last tile is masked. A
// warp whose rows all lie past S skips the arithmetic. Not wgmma/TMA: a
// 72-wide bf16 row (144 bytes) fits no TMA swizzle span, and the mma.sync
// schedule could be checked on the card within one change; a wgmma
// version is not queued, and the gap to SDPA stays recorded in PERF.md,
// section 7.
#include <math_constants.h>

#include "flash.cuh"

namespace emr2a {

constexpr int FA_BK = 64;   // keys per tile
constexpr int FA_NST = 3;   // ring stages
constexpr int FA_LONG_S = 512;  // sequences from this length take 8-warp blocks

// m16 tiles of query rows a warp owns: 2 (32 rows) while the registers
// allow, so each K and V fragment read from shared memory feeds two MMAs;
// WARPS warps a block (8 for long sequences: each K/V tile read from L2
// then serves 256 query rows)
template <int HDP, int WARPS>
struct FaShape {
  static constexpr int MT = HDP <= 96 ? 2 : 1;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int BQ = WARPS * 16 * MT;  // query rows per block
};

// one 64-key tile of K and V (rows k0 .. k0 + 63, zero past S) into a
// stage: THREADS / 64 threads a row, 16 bytes a copy
template <int LD, int THREADS>
__device__ __forceinline__ void fa_issue(bf16* ks, bf16* vs, const bf16* k, const bf16* v,
                                         size_t base, size_t ld, int k0, int S, int vecs,
                                         int tid) {
  constexpr int TPR = THREADS / FA_BK;
  const int r = tid / TPR;
  const bool ok = k0 + r < S;
  const size_t row = ok ? base + (size_t)(k0 + r) * ld : 0;
  const int n = ok ? 16 : 0;
  for (int c = (tid % TPR) * 8; c < vecs * 8; c += 8 * TPR) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(fa_smem_u32(ks + r * LD + c)),
                 "l"(k + row + (ok ? c : 0)), "r"(n));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(fa_smem_u32(vs + r * LD + c)),
                 "l"(v + row + (ok ? c : 0)), "r"(n));
  }
}

// grid (ceil(S / BQ), H, F); HDP = hd rounded up to 16.
template <int HDP, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, WARPS == 4 ? 2 : 1)
frame_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out, int S, int H, int hd,
                       float scale_log2) {
  constexpr int LD = HDP + 8;            // shared row stride (elements)
  constexpr int TILE = FA_BK * LD;       // one K or V tile
  using Shape = FaShape<HDP, WARPS>;
  constexpr int MT = Shape::MT, THREADS = Shape::THREADS;
  extern __shared__ __align__(16) unsigned char fa_smem_raw[];
  bf16* fa_smem = reinterpret_cast<bf16*>(fa_smem_raw);

  const int f = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * Shape::BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const size_t ld = (size_t)H * hd;  // elements between consecutive tokens
  const size_t base = (size_t)f * S * ld + (size_t)h * hd;
  const int vecs = hd / 8;
  const int ntiles = (S + FA_BK - 1) / FA_BK;
  const int nd = hd / 8;             // output column tiles (the pad tile skipped)

  // the pad columns (hd .. LD) stay zero: copies write only columns < hd
  for (int row = tid; row < FA_NST * 2 * FA_BK; row += THREADS)
    for (int col = hd; col < LD; col += 2)
      *reinterpret_cast<uint32_t*>(fa_smem + row * LD + col) = 0u;
#pragma unroll
  for (int s = 0; s < FA_NST - 1; ++s) {
    if (s < ntiles)
      fa_issue<LD, THREADS>(fa_smem + s * 2 * TILE, fa_smem + s * 2 * TILE + TILE, k, v, base, ld,
                   s * FA_BK, S, vecs, tid);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // this warp's 16 * MT query rows as A fragments, straight from device
  // memory; rows rw[mt] and rw[mt] + 8 of m-tile mt
  const int wrow = q0 + warp * 16 * MT;
  const bool active = wrow < S;
  uint32_t qa[MT][HDP / 16][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kc = 0; kc < HDP / 16; ++kc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = wrow + mt * 16 + gq + ((e & 1) ? 8 : 0);
        const int col = kc * 16 + tq * 2 + ((e & 2) ? 8 : 0);
        qa[mt][kc][e] = (row < S && col < hd)
                            ? *reinterpret_cast<const uint32_t*>(q + base + (size_t)row * ld + col)
                            : 0u;
      }

  float o[MT][HDP / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int dt = 0; dt < HDP / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][dt][e] = 0.f;
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = -CUDART_INF_F;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(FA_NST - 2) : "memory");
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    {
      const int nx = t + FA_NST - 1;
      if (nx < ntiles) {
        bf16* st = fa_smem + (nx % FA_NST) * 2 * TILE;
        fa_issue<LD, THREADS>(st, st + TILE, k, v, base, ld, nx * FA_BK, S, vecs, tid);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    if (!active) continue;
    const bf16* Ks = fa_smem + (t % FA_NST) * 2 * TILE;
    const bf16* Vs = Ks + TILE;
    const int k0 = t * FA_BK;

    // logits (16 x 64 per m-tile) = q k^T
    float s[MT][FA_BK / 8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < FA_BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
    // each step's K fragments are loaded together, ahead of its MMAs
    // (ldmatrix and mma issue in program order)
#pragma unroll
    for (int kc = 0; kc < HDP / 16; ++kc) {
      uint32_t b[FA_BK / 16][4];
#pragma unroll
      for (int np = 0; np < FA_BK / 16; ++np) {
        const int key = (2 * np + (lane >> 4)) * 8 + (lane & 7);
        fa_ldmatrix_x4(b[np], Ks + key * LD + kc * 16 + ((lane >> 3) & 1) * 8);
      }
#pragma unroll
      for (int np = 0; np < FA_BK / 16; ++np)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16_16816(s[mt][2 * np], qa[mt][kc], b[np][0], b[np][1]);
          mma_bf16_16816(s[mt][2 * np + 1], qa[mt][kc], b[np][2], b[np][3]);
        }
    }

    uint32_t pa[MT][FA_BK / 16][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // row max of the raw logits (rows gq and gq + 8; a quad of lanes
      // shares a row); keys past S masked in a ragged last tile
      if (k0 + FA_BK > S) {
#pragma unroll
        for (int nt = 0; nt < FA_BK / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + nt * 8 + tq * 2 + (e & 1) >= S) s[mt][nt][e] = -CUDART_INF_F;
      }
      float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
      for (int nt = 0; nt < FA_BK / 8; ++nt) {
        mx0 = fmaxf(mx0, fmaxf(s[mt][nt][0], s[mt][nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[mt][nt][2], s[mt][nt][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      // the running maxima, in the log2 domain (scale > 0); every tile
      // holds key k0 < S, so they are finite
      const float mn0 = fmaxf(m[mt][0], mx0 * scale_log2);
      const float mn1 = fmaxf(m[mt][1], mx1 * scale_log2);
      const float a0 = fa_exp2(m[mt][0] - mn0), a1 = fa_exp2(m[mt][1] - mn1);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < FA_BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = fa_exp2(fmaf(s[mt][nt][e], scale_log2, -(e < 2 ? mn0 : mn1)));
          s[mt][nt][e] = p;
          if (e < 2) sum0 += p;
          else sum1 += p;
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
      }
      l[mt][0] = l[mt][0] * a0 + sum0;
      l[mt][1] = l[mt][1] * a1 + sum1;
      m[mt][0] = mn0;
      m[mt][1] = mn1;
#pragma unroll
      for (int dt = 0; dt < HDP / 8; ++dt) {
        o[mt][dt][0] *= a0;
        o[mt][dt][1] *= a0;
        o[mt][dt][2] *= a1;
        o[mt][dt][3] *= a1;
      }
      // the probabilities in bf16, as P.V's A fragments
#pragma unroll
      for (int kc = 0; kc < FA_BK / 16; ++kc) {
        pa[mt][kc][0] = pack_bf16(s[mt][2 * kc][0], s[mt][2 * kc][1]);
        pa[mt][kc][1] = pack_bf16(s[mt][2 * kc][2], s[mt][2 * kc][3]);
        pa[mt][kc][2] = pack_bf16(s[mt][2 * kc + 1][0], s[mt][2 * kc + 1][1]);
        pa[mt][kc][3] = pack_bf16(s[mt][2 * kc + 1][2], s[mt][2 * kc + 1][3]);
      }
    }

    // o (16 x hd per m-tile) += p v; a last odd column tile (hd % 16 == 8)
    // takes the first half of its pair
#pragma unroll
    for (int kc = 0; kc < FA_BK / 16; ++kc) {
      uint32_t b[HDP / 16][4];
      const int key = kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dp = 0; dp < HDP / 16; ++dp)
        fa_ldmatrix_x4_trans(b[dp], Vs + key * LD + dp * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int dp = 0; dp < HDP / 16; ++dp)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16_16816(o[mt][2 * dp], pa[mt][kc], b[dp][0], b[dp][1]);
          if (2 * dp + 1 < nd) mma_bf16_16816(o[mt][2 * dp + 1], pa[mt][kc], b[dp][2], b[dp][3]);
        }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  if (!active) return;

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r0 = wrow + mt * 16 + gq, r1 = r0 + 8;
#pragma unroll
    for (int dt = 0; dt < HDP / 8; ++dt) {
      const int col = dt * 8 + tq * 2;
      if (col >= hd) continue;
      if (r0 < S)
        *reinterpret_cast<__nv_bfloat162*>(out + base + (size_t)r0 * ld + col) =
            __floats2bfloat162_rn(__fdiv_rn(o[mt][dt][0], l[mt][0]),
                                  __fdiv_rn(o[mt][dt][1], l[mt][0]));
      if (r1 < S)
        *reinterpret_cast<__nv_bfloat162*>(out + base + (size_t)r1 * ld + col) =
            __floats2bfloat162_rn(__fdiv_rn(o[mt][dt][2], l[mt][1]),
                                  __fdiv_rn(o[mt][dt][3], l[mt][1]));
    }
  }
}

template <int HDP, int WARPS>
cudaError_t launch_frame_attention_shape(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                                         int F, int S, int H, int hd, float scale,
                                         cudaStream_t st) {
  using Shape = FaShape<HDP, WARPS>;
  constexpr size_t smem = (size_t)FA_NST * 2 * FA_BK * (HDP + 8) * sizeof(bf16);
  static std::atomic<uint64_t> sized{0};   // the devices whose attribute is set
  const cudaError_t e = smem_attr_once(frame_attention_kernel<HDP, WARPS>, (int)smem, sized);
  if (e != cudaSuccess) return e;
  dim3 grid((S + Shape::BQ - 1) / Shape::BQ, H, F);
  frame_attention_kernel<HDP, WARPS><<<grid, Shape::THREADS, smem, st>>>(
      q, k, v, out, S, H, hd, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// 8 warps a block where a sequence fills 256-row blocks and two m-tiles a
// warp fit the registers, else 4
template <int HDP>
cudaError_t launch_frame_attention_hdp(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                                       int F, int S, int H, int hd, float scale,
                                       cudaStream_t st) {
  if constexpr (FaShape<HDP, 8>::MT == 2)
    if (S >= FA_LONG_S)
      return launch_frame_attention_shape<HDP, 8>(q, k, v, out, F, S, H, hd, scale, st);
  return launch_frame_attention_shape<HDP, 4>(q, k, v, out, F, S, H, hd, scale, st);
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
