// GQA decode attention over the Qwen3-VL judge's bf16 KV cache, for Hopper
// (sm_90a):
//
//   K10  emr2a_decode_attention  replaces no TPU kernel: the JAX package
//        lowers the decoder's small-S attention (emr2a_tpu/models/
//        qwen3_vl.py, the S <= 16 einsums) to XLA, with no Pallas kernel.
//        The port's plain version upcast the whole cache to f32 on every
//        decode step and ran f32 GEMVs on permuted copies, moving about 14
//        bytes for each byte the attention needs.
//
//   out[b, s, h] = sum_l softmax_l(q[b,s,h] . k[b,l,h/G] * scale + mask[b,s,l])
//                  v[b,l,h/G]
//
// q (B, S <= 16, H, 128) bf16 after the QK-norm and rope; k and v the caches
// (B, L, KV, 128) bf16 as ``cache_write`` leaves them, read through their
// strides (never copied); mask (B, S, L) f32 additive, the one the caller
// built (ring layout, per-row offsets, a shared prefix, verify's causal
// rows keep their meaning); out (B, S, H * 128) bf16. G = H / KV query heads
// share a kv head. Rounding points: f32 logits from bf16 products, times the
// scale, plus the mask in f32; softmax statistics in f32; the unnormalised
// probabilities rounded to bf16 for P.V (as K8's flash kernel does); f32
// accumulation; one division and one rounding to bf16 at the end.
//
// Bound on the H100: bytes. At S = 1 the kernel does about 4 operations a
// byte of K and V (the card's balance point is 295), so the one goal is to
// read each K and V byte once at full bandwidth with every SM busy: at 8
// slots and L = 2,240 the cache is 73.4 MB a layer (21.9 us at 3.35 TB/s),
// at B = 1 9.2 MB (2.7 us).
//
// Design: split-KV ("flash-decoding"). Blocks cover (split of L, kv head,
// batch row); the split is a fixed number of 64-position tiles, chosen by
// the wrapper from B * KV, L and the SM count so that about two blocks an
// SM are resident, and at least the ring's 3 stages (never from the data,
// so a replayed graph step is bit-identical to the eager one). A block of
// 4 warps keeps the G * S <= 64 query rows of its kv head (m16 tiles:
// WR = 1, 2 or 4 of them, one a warp) and streams K, V and the mask's S rows
// through a 3-stage cp.async ring of 64-position tiles (16-byte copies for K
// and V, rows padded by 16 bytes so every ldmatrix is conflict-free; 4-byte
// copies for the mask, which any stride allows). The 4 / WR warps that share
// an m-tile take 64 / (4 / WR) positions of each tile each, so every warp has
// work even at S = 1 (4 rows). Logits and P.V run on mma.sync m16n8k16 (bf16
// in, f32 accumulate), the probabilities going from the logits' accumulators
// straight into P.V's A fragments; the online softmax keeps (m, l, acc) per
// row in registers. At the end the warps of an m-tile merge their (m, l, acc)
// in shared memory in a fixed order, and the block writes either the output
// (one split) or its partial (m, l, acc) in f32 to scratch; a second small
// launch then merges the splits of each row in split order. No atomics
// anywhere. A split (or a warp's share) whose positions are all masked
// carries weight 0, never NaN; a row with no visible position at all gives 0
// (the plain version gives NaN there; no caller builds such a row). Nothing
// reads back to the host or allocates (the wrapper passes torch.empty
// scratch), so the kernel runs inside the generator's and the batcher's CUDA
// graphs.
#include <math_constants.h>

#include "flash.cuh"

namespace emr2a {

constexpr int DA_HD = 128;                // head dim
constexpr int DA_BK = 64;                 // positions a tile
constexpr int DA_NST = 3;                 // ring stages
constexpr int DA_LD = DA_HD + 8;          // shared row stride of K and V (elements)
constexpr int DA_TILE = DA_BK * DA_LD;    // one K or V tile (elements)
constexpr int DA_THREADS = 128;           // 4 warps
constexpr int DA_MAX_S = 16;
constexpr int DA_MAX_ROWS = 64;           // G * S
constexpr int DA_RED_LD = DA_HD + 4;      // the epilogue's f32 row stride
constexpr float DA_LOG2E = 1.4426950408889634f;

struct DecodeArgs {
  const bf16* q;
  long long qb, qs, qh;       // strides (elements) of q's batch, position, head
  const bf16* k;
  long long kb, kl, kh;
  const bf16* v;
  long long vb, vl, vh;
  const float* mask;
  long long mb, ms;           // strides of the mask's batch and query position
  bf16* out;                  // (B, S, H * 128)
  float* part_o;              // (B, KV, nsplit, R, 128) when nsplit > 1
  float* part_ml;             // (B, KV, nsplit, R, 2): running max, sum
  int S, H, KV, L, G, R, chunk, nsplit;
  float scale;
};

__host__ __device__ constexpr int da_stage_bytes(int S) {
  return 2 * DA_TILE * (int)sizeof(bf16) + S * DA_BK * (int)sizeof(float);
}

__host__ __device__ constexpr int da_red_bytes() {
  return 4 * 16 * DA_RED_LD * (int)sizeof(float) + 4 * 16 * 2 * (int)sizeof(float);
}

// positions p0 .. p0 + 63 of K, V and the mask's S rows into a stage; rows
// at or past L are zero-filled (the compute masks them by bounds)
__device__ __forceinline__ void da_issue(unsigned char* stage, const DecodeArgs& a,
                                         const bf16* kbase, const bf16* vbase,
                                         const float* mbase, int p0, int tid) {
  bf16* ks = reinterpret_cast<bf16*>(stage);
  bf16* vs = ks + DA_TILE;
  float* mk = reinterpret_cast<float*>(vs + DA_TILE);
  const int c = (tid & 15) * 8;  // a warp copies two whole 256-byte rows at once
  for (int r = tid >> 4; r < DA_BK; r += DA_THREADS / 16) {
    const int pos = p0 + r;
    const bool ok = pos < a.L;
    const long long row = ok ? pos : p0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     fa_smem_u32(ks + r * DA_LD + c)),
                 "l"(kbase + row * a.kl + c), "r"(ok ? 16 : 0));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     fa_smem_u32(vs + r * DA_LD + c)),
                 "l"(vbase + row * a.vl + c), "r"(ok ? 16 : 0));
  }
  for (int e = tid; e < a.S * DA_BK; e += DA_THREADS) {
    const int s = e / DA_BK, pos = p0 + (e % DA_BK);
    const bool ok = pos < a.L;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(fa_smem_u32(mk + e)),
                 "l"(mbase + s * a.ms + (ok ? pos : p0)), "r"(ok ? 4 : 0));
  }
}

// grid (nsplit, KV, B), 128 threads; WR m16 tiles of query rows, one a warp,
// and 4 / WR warps sharing each m-tile's positions
template <int WR>
__global__ void __launch_bounds__(DA_THREADS, 2) decode_attention_kernel(const DecodeArgs a) {
  constexpr int WK = 4 / WR;          // warps sharing an m-tile
  constexpr int KPW = DA_BK / WK;     // positions of a tile a warp takes
  constexpr int NT = KPW / 8;         // its n8 logit tiles
  constexpr int NP = KPW / 16;        // its k16 steps of P.V
  extern __shared__ __align__(16) unsigned char da_smem[];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int mt = warp % WR, kw = warp / WR;
  const int stage_bytes = da_stage_bytes(a.S);
  const int l0 = split * a.chunk;
  const int l1 = min(a.L, l0 + a.chunk);
  const int ntiles = (l1 - l0 + DA_BK - 1) / DA_BK;
  const bf16* kbase = a.k + b * a.kb + kvh * a.kh;
  const bf16* vbase = a.v + b * a.vb + kvh * a.vh;
  const float* mbase = a.mask + b * a.mb;

#pragma unroll
  for (int s = 0; s < DA_NST - 1; ++s) {
    if (s < ntiles) da_issue(da_smem + s * stage_bytes, a, kbase, vbase, mbase, l0 + s * DA_BK, tid);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // this warp's rows r0 = mt * 16 + gq and r1 = r0 + 8: row r is query
  // position r / G of head kvh * G + r % G
  const int r0 = mt * 16 + gq, r1 = r0 + 8;
  const bool active = mt * 16 < a.R;
  const int s0 = min(r0 / a.G, a.S - 1), s1 = min(r1 / a.G, a.S - 1);
  uint32_t qa[DA_HD / 16][4];
  {
    const bf16* q0 = a.q + b * a.qb + (long long)(r0 / a.G) * a.qs + (long long)(kvh * a.G + r0 % a.G) * a.qh;
    const bf16* q1 = a.q + b * a.qb + (long long)(r1 / a.G) * a.qs + (long long)(kvh * a.G + r1 % a.G) * a.qh;
#pragma unroll
    for (int kc = 0; kc < DA_HD / 16; ++kc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kc * 16 + tq * 2 + ((e & 2) ? 8 : 0);
        const bool lo = !(e & 1);
        qa[kc][e] = ((lo ? r0 : r1) < a.R)
                        ? *reinterpret_cast<const uint32_t*>((lo ? q0 : q1) + col)
                        : 0u;
      }
  }

  float o[DA_HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < DA_HD / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, lsum0 = 0.f, lsum1 = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(DA_NST - 2) : "memory");
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    {
      const int nx = t + DA_NST - 1;
      if (nx < ntiles)
        da_issue(da_smem + (nx % DA_NST) * stage_bytes, a, kbase, vbase, mbase,
                 l0 + nx * DA_BK, tid);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    if (!active) continue;
    const bf16* Ks = reinterpret_cast<const bf16*>(da_smem + (t % DA_NST) * stage_bytes);
    const bf16* Vs = Ks + DA_TILE;
    const float* Ms = reinterpret_cast<const float*>(Vs + DA_TILE);
    const int p0 = l0 + t * DA_BK;
    const int kb0 = kw * KPW;  // this warp's first position in the tile

    // logits (16 rows x KPW positions) = q k^T
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DA_HD / 16; ++kc) {
      uint32_t bk[NP][4];
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        const int key = kb0 + (2 * np + (lane >> 4)) * 8 + (lane & 7);
        fa_ldmatrix_x4(bk[np], Ks + key * DA_LD + kc * 16 + ((lane >> 3) & 1) * 8);
      }
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        mma_bf16_16816(sc[2 * np], qa[kc], bk[np][0], bk[np][1]);
        mma_bf16_16816(sc[2 * np + 1], qa[kc], bk[np][2], bk[np][3]);
      }
    }

    // times the scale, plus the mask (two roundings, as the plain version);
    // positions at or past L masked by bounds
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int key = kb0 + nt * 8 + tq * 2;
      const float2 ma = *reinterpret_cast<const float2*>(Ms + s0 * DA_BK + key);
      const float2 mb = *reinterpret_cast<const float2*>(Ms + s1 * DA_BK + key);
      const bool in0 = p0 + key < a.L, in1 = p0 + key + 1 < a.L;
      sc[nt][0] = in0 ? __fadd_rn(__fmul_rn(sc[nt][0], a.scale), ma.x) : -CUDART_INF_F;
      sc[nt][1] = in1 ? __fadd_rn(__fmul_rn(sc[nt][1], a.scale), ma.y) : -CUDART_INF_F;
      sc[nt][2] = in0 ? __fadd_rn(__fmul_rn(sc[nt][2], a.scale), mb.x) : -CUDART_INF_F;
      sc[nt][3] = in1 ? __fadd_rn(__fmul_rn(sc[nt][3], a.scale), mb.y) : -CUDART_INF_F;
      mx0 = fmaxf(mx0, fmaxf(sc[nt][0], sc[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[nt][2], sc[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // a quad of lanes shares a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // the running maxima; while every position so far is masked the base is
    // 0, so exp(-inf - base) = 0 and nothing becomes NaN
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float base0 = mn0 == -CUDART_INF_F ? 0.f : mn0;
    const float base1 = mn1 == -CUDART_INF_F ? 0.f : mn1;
    const float al0 = fa_exp2((m0 - base0) * DA_LOG2E), al1 = fa_exp2((m1 - base1) * DA_LOG2E);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      sc[nt][0] = fa_exp2((sc[nt][0] - base0) * DA_LOG2E);
      sc[nt][1] = fa_exp2((sc[nt][1] - base0) * DA_LOG2E);
      sc[nt][2] = fa_exp2((sc[nt][2] - base1) * DA_LOG2E);
      sc[nt][3] = fa_exp2((sc[nt][3] - base1) * DA_LOG2E);
      sum0 += sc[nt][0] + sc[nt][1];
      sum1 += sc[nt][2] + sc[nt][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    lsum0 = lsum0 * al0 + sum0;
    lsum1 = lsum1 * al1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int dt = 0; dt < DA_HD / 8; ++dt) {
      o[dt][0] *= al0;
      o[dt][1] *= al0;
      o[dt][2] *= al1;
      o[dt][3] *= al1;
    }

    // o (16 x 128) += p v, the probabilities in bf16 as P.V's A fragments
#pragma unroll
    for (int kc = 0; kc < NP; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * kc][0], sc[2 * kc][1]);
      pa[1] = pack_bf16(sc[2 * kc][2], sc[2 * kc][3]);
      pa[2] = pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]);
      pa[3] = pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3]);
      uint32_t bv[DA_HD / 16][4];
      const int key = kb0 + kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dp = 0; dp < DA_HD / 16; ++dp)
        fa_ldmatrix_x4_trans(bv[dp], Vs + key * DA_LD + dp * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int dp = 0; dp < DA_HD / 16; ++dp) {
        mma_bf16_16816(o[2 * dp], pa, bv[dp][0], bv[dp][1]);
        mma_bf16_16816(o[2 * dp + 1], pa, bv[dp][2], bv[dp][3]);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();  // the ring is free: it holds the epilogue's partials now

  float* red_o = reinterpret_cast<float*>(da_smem);   // [warp][16][DA_RED_LD]
  float* red_ml = red_o + 4 * 16 * DA_RED_LD;         // [warp][16][2]
  if (active) {
    float* w0 = red_o + (warp * 16 + gq) * DA_RED_LD;
    float* w1 = w0 + 8 * DA_RED_LD;
#pragma unroll
    for (int dt = 0; dt < DA_HD / 8; ++dt) {
      *reinterpret_cast<float2*>(w0 + dt * 8 + tq * 2) = make_float2(o[dt][0], o[dt][1]);
      *reinterpret_cast<float2*>(w1 + dt * 8 + tq * 2) = make_float2(o[dt][2], o[dt][3]);
    }
    if (tq == 0) {
      *reinterpret_cast<float2*>(red_ml + (warp * 16 + gq) * 2) = make_float2(m0, lsum0);
      *reinterpret_cast<float2*>(red_ml + (warp * 16 + gq + 8) * 2) = make_float2(m1, lsum1);
    }
  }
  __syncthreads();

  // each (row, column) merges the WK warps of its m-tile in warp order
  for (int e = tid; e < a.R * DA_HD; e += DA_THREADS) {
    const int r = e / DA_HD, d = e % DA_HD, rr = r % 16;
    const int w0 = r / 16;  // the m-tile's first warp; the others follow every WR
    float M = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < WK; ++j) M = fmaxf(M, red_ml[((w0 + j * WR) * 16 + rr) * 2]);
    const float base = M == -CUDART_INF_F ? 0.f : M;
    float lsum = 0.f, acc = 0.f;
#pragma unroll
    for (int j = 0; j < WK; ++j) {
      const int w = (w0 + j * WR) * 16 + rr;
      const float wt = fa_exp2((red_ml[w * 2] - base) * DA_LOG2E);
      lsum += red_ml[w * 2 + 1] * wt;
      acc += red_o[w * DA_RED_LD + d] * wt;
    }
    if (a.nsplit == 1) {
      const int s = r / a.G, h = kvh * a.G + r % a.G;
      a.out[(((long long)b * a.S + s) * a.H + h) * DA_HD + d] =
          __float2bfloat16(lsum > 0.f ? __fdiv_rn(acc, lsum) : 0.f);
    } else {
      const long long row = (((long long)b * a.KV + kvh) * a.nsplit + split) * a.R + r;
      a.part_o[row * DA_HD + d] = acc;
      if (d == 0) *reinterpret_cast<float2*>(a.part_ml + row * 2) = make_float2(M, lsum);
    }
  }
}

// merges the splits of each (b, kv head, row), in split order: one warp a
// row, four columns a lane
__global__ void __launch_bounds__(128) decode_combine_kernel(const DecodeArgs a, int rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 4 + warp;
  if (row >= rows) return;
  const int r = row % a.R, bk = row / a.R, kvh = bk % a.KV, b = bk / a.KV;
  const long long first = (long long)bk * a.nsplit * a.R + r;  // split j at first + j * R
  float M = -CUDART_INF_F;
  for (int j = 0; j < a.nsplit; ++j) M = fmaxf(M, a.part_ml[(first + (long long)j * a.R) * 2]);
  const float base = M == -CUDART_INF_F ? 0.f : M;
  float lsum = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < a.nsplit; ++j) {
    const long long at = first + (long long)j * a.R;
    const float2 ml = *reinterpret_cast<const float2*>(a.part_ml + at * 2);
    const float wt = fa_exp2((ml.x - base) * DA_LOG2E);
    lsum += ml.y * wt;
    const float4 p = *reinterpret_cast<const float4*>(a.part_o + at * DA_HD + lane * 4);
    acc.x += p.x * wt;
    acc.y += p.y * wt;
    acc.z += p.z * wt;
    acc.w += p.w * wt;
  }
  const bool any = lsum > 0.f;
  const int s = r / a.G, h = kvh * a.G + r % a.G;
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
      a.out + (((long long)b * a.S + s) * a.H + h) * DA_HD + lane * 4);
  dst[0] = __floats2bfloat162_rn(any ? __fdiv_rn(acc.x, lsum) : 0.f,
                                 any ? __fdiv_rn(acc.y, lsum) : 0.f);
  dst[1] = __floats2bfloat162_rn(any ? __fdiv_rn(acc.z, lsum) : 0.f,
                                 any ? __fdiv_rn(acc.w, lsum) : 0.f);
}

template <int WR>
cudaError_t launch_decode_attention_wr(const DecodeArgs& a, int B, cudaStream_t st) {
  // the attribute is set once, at the largest stage (16 mask rows)
  constexpr int most = DA_NST * da_stage_bytes(DA_MAX_S);
  static std::atomic<uint64_t> sized{0};
  cudaError_t e = smem_attr_once(decode_attention_kernel<WR>, most, sized);
  if (e != cudaSuccess) return e;
  const int ring = DA_NST * da_stage_bytes(a.S);
  const int smem = ring > da_red_bytes() ? ring : da_red_bytes();
  decode_attention_kernel<WR><<<dim3(a.nsplit, a.KV, B), DA_THREADS, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.nsplit == 1) return e;
  const int rows = B * a.KV * a.R;
  decode_combine_kernel<<<(rows + 3) / 4, 128, 0, st>>>(a, rows);
  return cudaGetLastError();
}

}  // namespace emr2a

using namespace emr2a;

// K10. Rules the wrapper (ops/decode_attention.py) checks: q (B, S, H, 128),
// k and v (B, L, KV, 128), bf16, innermost stride 1, other strides multiples
// of 8 elements, 16-byte aligned; mask (B, S, L) f32, innermost stride 1;
// out (B, S, H * 128) bf16 contiguous; 1 <= S <= 16, H % KV == 0,
// (H / KV) * S <= 64; chunk a positive multiple of 64 and nsplit =
// ceil(L / chunk); with nsplit > 1 the f32 scratch part_o (B * KV * nsplit *
// R * 128) and part_ml (B * KV * nsplit * R * 2), R = (H / KV) * S.
extern "C" int emr2a_decode_attention(const void* q, long long qb, long long qs, long long qh,
                                      const void* k, long long kb, long long kl, long long kh,
                                      const void* v, long long vb, long long vl, long long vh,
                                      const void* mask, long long mb, long long ms, void* out,
                                      void* part_o, void* part_ml, int B, int S, int H, int KV,
                                      int L, int chunk, int nsplit, float scale, void* stream) {
  if (B < 1 || S < 1 || S > DA_MAX_S || KV < 1 || H < KV || H % KV || L < 1 || chunk < DA_BK ||
      chunk % DA_BK || nsplit != (L + chunk - 1) / chunk || (H / KV) * S > DA_MAX_ROWS ||
      (nsplit > 1 && (part_o == nullptr || part_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a;
  a.q = static_cast<const bf16*>(q);
  a.qb = qb, a.qs = qs, a.qh = qh;
  a.k = static_cast<const bf16*>(k);
  a.kb = kb, a.kl = kl, a.kh = kh;
  a.v = static_cast<const bf16*>(v);
  a.vb = vb, a.vl = vl, a.vh = vh;
  a.mask = static_cast<const float*>(mask);
  a.mb = mb, a.ms = ms;
  a.out = static_cast<bf16*>(out);
  a.part_o = static_cast<float*>(part_o);
  a.part_ml = static_cast<float*>(part_ml);
  a.S = S, a.H = H, a.KV = KV, a.L = L, a.G = H / KV, a.R = (H / KV) * S;
  a.chunk = chunk, a.nsplit = nsplit, a.scale = scale;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int mts = (a.R + 15) / 16;
  cudaError_t e;
  if (mts == 1) e = launch_decode_attention_wr<1>(a, B, st);
  else if (mts == 2) e = launch_decode_attention_wr<2>(a, B, st);
  else e = launch_decode_attention_wr<4>(a, B, st);
  return static_cast<int>(e);
}
