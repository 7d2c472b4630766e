// The decode path of the two quantized linears, K5 (W8A8, linear_int8.cu) and
// K7 (W4A8, linear_int4.cu), for T <= 16 rows: a weight-streaming GEMV with
// the row quantize folded in, in one launch.
//
// Bound on the H100: the weights, read once (K*N bytes in s8, K*N/2 packed
// int4), over 3.35 TB/s; the x rows (T*K bf16) are a few per cent of it.
//
// Design. Grid (N / 128, splits), 128 threads a block. A block owns a strip
// of 128 columns and 16 segments of seg_rows consecutive byte rows of the
// weights (seg_rows = 64, 32 or 16, the largest that still gives two blocks
// per SM; byte row r is weight row r in s8, and weight rows r % 64 and
// 64 + r % 64 of group r / 64 in packed int4). Lane l & 7 takes 16 columns,
// (thread >> 3) a segment.
// 1. Quantize: every block computes all T row scales (the block reads each
//    whole bf16 row, from L2 after the first block) and the codes of its
//    own k-range into shared memory, with quant.cuh's row_scale and
//    quantize_code, so the codes equal ops/quant.quantize_rows_s8_reference
//    byte for byte.
// 2. Stream: each thread reads its segment four byte rows at a time with
//    16-byte loads (two quads, 128 bytes, in flight a thread), transposes each
//    4x4 byte block so that a column's four consecutive rows sit in one word
//    (transpose4x4; int4: sext_nibbles of the low and high nibbles) and takes
//    dp4a against the codes. T rows are taken TR at a time (TR <= 8 keeps
//    the s32 sums, TR x 16 a thread, in registers); a second pass over the
//    block's weights (T > 8) reads them from L2.
// 3. Reduce, keeping the plain versions' rounding points:
//    - K5: the s32 sums are exact in any order. A block adds its segments'
//      sums (shuffles, then shared memory) and writes one s32 partial a
//      (split, row, column); the strip's last block adds the splits' partials
//      and rescales once, ((acc * x_scale) * w_scale) + bias.
//    - K7: a segment lies inside one group; the group's s32 sum (its
//      64 / seg_rows segments are lanes of one warp: shuffles) is rounded to
//      f32 and multiplied by w_scale[g], and the rounded product is written to
//      a (G, T, N) f32 scratch; the strip's last block sums the products in
//      group order, then applies the row scale and the bias, as
//      ops/linear_int4.linear_w4a8_reference does.
//    The last block is the one that takes the strip's counter to splits - 1
//    (an atomic on a zeroed (N / 128,) buffer, which it sets back to 0 for
//    the next launch on the stream).
// The result is bit-identical to the plain versions.
#pragma once

#include "quant.cuh"

namespace emr2a {

constexpr int GEMV_THREADS = 128;
constexpr int GEMV_COLS = 128;                  // a block's strip of columns
constexpr int GEMV_SEGS = GEMV_THREADS / 8;     // segments a block
constexpr int GEMV_MAX_T = 16;
constexpr int GEMV_TR = 8;                      // rows of one pass, at most
constexpr int GEMV_GROUP = 128;                 // K7's quantization group

struct GemvParams {
  const bf16* x;          // (T, K)
  const int8_t* w;        // (KB, N) byte rows: s8 (KB = K) or packed int4 (KB = K / 2)
  const float* w_scale;   // (N,) K5; (K / 128, N) K7
  const bf16* bias;       // (N,) or null
  bf16* out;              // (T, N)
  void* partial;          // K5: (splits, T, N) s32; K7: (K / 128, T, N) f32
  unsigned* counters;     // (N / 128,), 0 between launches
  int T, K, N;
  int seg_rows;           // 16, 32 or 64
  int splits;             // blocks along the byte rows of a strip
};

// the byte rows a block covers, and the k-range (in weight rows) of its codes
__host__ __device__ inline int gemv_block_rows(int seg_rows) { return GEMV_SEGS * seg_rows; }
template <bool W4>
__host__ __device__ inline int gemv_block_k(int seg_rows) {
  return gemv_block_rows(seg_rows) * (W4 ? 2 : 1);
}

template <bool W4>
inline size_t gemv_smem(int T, int seg_rows) {
  const size_t codes = static_cast<size_t>(T) * gemv_block_k<W4>(seg_rows);
  const size_t red = W4 ? 0 : static_cast<size_t>(GEMV_THREADS / 32) * GEMV_TR * GEMV_COLS * 4;
  return codes + red;
}

__device__ __forceinline__ uint4 ldg_stream(const int8_t* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t lane_word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

template <int TR, bool W4>
__global__ void __launch_bounds__(GEMV_THREADS) linear_gemv_kernel(GemvParams p) {
  extern __shared__ __align__(16) int8_t gemv_smem_buf[];
  __shared__ float row_scales[GEMV_MAX_T];
  __shared__ int is_last;
  const int T = p.T, K = p.K, N = p.N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int strip = blockIdx.x, n0 = strip * GEMV_COLS;
  const int block_k = gemv_block_k<W4>(p.seg_rows);
  const int k_lo = blockIdx.y * block_k;
  const int k_n = min(block_k, K - k_lo);
  int8_t* codes = gemv_smem_buf;                                   // [T][block_k]
  int* red = reinterpret_cast<int*>(gemv_smem_buf + static_cast<size_t>(T) * block_k);

  // 1. the row scales (all of K, every thread on each row), then this
  // block's codes
  __shared__ float warp_amax[GEMV_THREADS / 32][GEMV_MAX_T];
  for (int t = 0; t < T; ++t) {
    const bf16* xr = p.x + static_cast<size_t>(t) * K;
    float amax = 0.f;
#pragma unroll 4
    for (int k = tid * 8; k < K; k += GEMV_THREADS * 8) {
      float v[8];
      load8(xr + k, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
    }
    amax = warp_max(amax);
    if (lane == 0) warp_amax[warp][t] = amax;
  }
  __syncthreads();
  if (tid < T)
    row_scales[tid] = row_scale(fmaxf(fmaxf(warp_amax[0][tid], warp_amax[1][tid]),
                                      fmaxf(warp_amax[2][tid], warp_amax[3][tid])));
  __syncthreads();
  for (int idx = tid * 8; idx < T * block_k; idx += GEMV_THREADS * 8) {
    const int t = idx / block_k, kk = idx - t * block_k;
    union {
      uint2 u;
      int8_t c[8];
    } pk;
    pk.u = make_uint2(0u, 0u);
    if (kk < k_n) {
      float v[8];
      load8(p.x + static_cast<size_t>(t) * K + k_lo + kk, v);
      const float inv = __frcp_rn(row_scales[t]);
#pragma unroll
      for (int e = 0; e < 8; ++e) pk.c[e] = quantize_code(v[e], inv);
    }
    *reinterpret_cast<uint2*>(codes + idx) = pk.u;
  }
  __syncthreads();

  // 2. stream this thread's segment: 16 columns, seg_rows byte rows
  const int cq = lane & 7, seg = tid >> 3;
  const int n = n0 + cq * 16;
  const int KB = W4 ? K / 2 : K;
  const int seg_lo = blockIdx.y * gemv_block_rows(p.seg_rows) + seg * p.seg_rows;
  const int quads = max(0, min(p.seg_rows, KB - seg_lo)) / 4;
  // the local k offset of a byte row's (low-nibble) code
  auto code_k = [&](int r) { return W4 ? (r / 64) * GEMV_GROUP + (r % 64) - k_lo : r - k_lo; };

  for (int t0 = 0; t0 < T; t0 += TR) {
    int acc[TR][16];
#pragma unroll
    for (int t = 0; t < TR; ++t)
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[t][c] = 0;

    for (int q = 0; q < quads; q += 2) {
      uint4 v[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[h][i] = (q + h < quads)
                        ? ldg_stream(p.w + static_cast<size_t>(seg_lo + 4 * (q + h) + i) * N + n)
                        : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (q + h >= quads) break;
        const int kc = code_k(seg_lo + 4 * (q + h));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t c[4];
          transpose4x4(lane_word(v[h][0], j), lane_word(v[h][1], j), lane_word(v[h][2], j),
                       lane_word(v[h][3], j), c);
#pragma unroll
          for (int t = 0; t < TR; ++t) {
            if (t0 + t >= T) break;
            const int8_t* xr = codes + static_cast<size_t>(t0 + t) * block_k + kc;
            const int xl = *reinterpret_cast<const int*>(xr);
            if (W4) {
              const int xh = *reinterpret_cast<const int*>(xr + GEMV_GROUP / 2);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                acc[t][j * 4 + e] = __dp4a(static_cast<int>(sext_nibbles(c[e])), xl, acc[t][j * 4 + e]);
                acc[t][j * 4 + e] = __dp4a(static_cast<int>(sext_nibbles(c[e] >> 4)), xh, acc[t][j * 4 + e]);
              }
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[t][j * 4 + e] = __dp4a(static_cast<int>(c[e]), xl, acc[t][j * 4 + e]);
            }
          }
        }
      }
    }

    // 3. reduce this pass's rows
    if (W4) {
      // the group's segments are lanes cq + 8 * (seg % per) of this warp
      const int per = 64 / p.seg_rows;
#pragma unroll
      for (int t = 0; t < TR; ++t)
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          if (per >= 2) acc[t][c] += __shfl_xor_sync(0xffffffffu, acc[t][c], 8);
          if (per >= 4) acc[t][c] += __shfl_xor_sync(0xffffffffu, acc[t][c], 16);
        }
      if (seg % per == 0 && quads > 0) {
        const int g = seg_lo / 64;
        const float* ws = p.w_scale + static_cast<size_t>(g) * N + n;
        float s[16];
#pragma unroll
        for (int c = 0; c < 16; c += 4) {
          const float4 f = *reinterpret_cast<const float4*>(ws + c);
          s[c] = f.x; s[c + 1] = f.y; s[c + 2] = f.z; s[c + 3] = f.w;
        }
        float* prod = static_cast<float*>(p.partial);
#pragma unroll
        for (int t = 0; t < TR; ++t) {
          if (t0 + t >= T) break;
          float* dst = prod + (static_cast<size_t>(g) * T + t0 + t) * N + n;
#pragma unroll
          for (int c = 0; c < 16; c += 4)
            *reinterpret_cast<float4*>(dst + c) = make_float4(
                __fmul_rn(__int2float_rn(acc[t][c]), s[c]),
                __fmul_rn(__int2float_rn(acc[t][c + 1]), s[c + 1]),
                __fmul_rn(__int2float_rn(acc[t][c + 2]), s[c + 2]),
                __fmul_rn(__int2float_rn(acc[t][c + 3]), s[c + 3]));
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < TR; ++t)
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          acc[t][c] += __shfl_xor_sync(0xffffffffu, acc[t][c], 8);
          acc[t][c] += __shfl_xor_sync(0xffffffffu, acc[t][c], 16);
        }
      if (lane < 8) {
#pragma unroll
        for (int t = 0; t < TR; ++t)
#pragma unroll
          for (int c = 0; c < 16; c += 4)
            *reinterpret_cast<int4*>(red + (warp * GEMV_TR + t) * GEMV_COLS + cq * 16 + c) =
                make_int4(acc[t][c], acc[t][c + 1], acc[t][c + 2], acc[t][c + 3]);
      }
      __syncthreads();
      int* part = static_cast<int*>(p.partial);
      for (int t = 0; t < TR && t0 + t < T; ++t) {
        int s = 0;
#pragma unroll
        for (int w = 0; w < GEMV_THREADS / 32; ++w) s += red[(w * GEMV_TR + t) * GEMV_COLS + tid];
        part[(static_cast<size_t>(blockIdx.y) * T + t0 + t) * N + n0 + tid] = s;
      }
      __syncthreads();
    }
  }

  // 4. the strip's last block finishes it
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(p.counters + strip, 1u) == static_cast<unsigned>(p.splits - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int col = n0 + tid;
  const float bias = p.bias != nullptr ? __bfloat162float(p.bias[col]) : 0.f;
  for (int t = 0; t < T; ++t) {
    float y;
    if (W4) {
      // the group products in group order, 32 loads in flight at a time
      const float* prod = static_cast<const float*>(p.partial) + static_cast<size_t>(t) * N + col;
      const size_t stride = static_cast<size_t>(T) * N;
      const int G = K / GEMV_GROUP;
      y = 0.f;
      for (int g0 = 0; g0 < G; g0 += 32) {
        float v[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) v[i] = g0 + i < G ? __ldcg(prod + (g0 + i) * stride) : 0.f;
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (g0 + i < G) y = __fadd_rn(y, v[i]);
      }
      y = __fmul_rn(y, row_scales[t]);
    } else {
      const int* part = static_cast<const int*>(p.partial) + static_cast<size_t>(t) * N + col;
      int s = 0;
      for (int sp = 0; sp < p.splits; ++sp) s += __ldcg(part + static_cast<size_t>(sp) * T * N);
      y = __fmul_rn(__fmul_rn(__int2float_rn(s), row_scales[t]), p.w_scale[col]);
    }
    if (p.bias != nullptr) y = __fadd_rn(y, bias);
    p.out[static_cast<size_t>(t) * N + col] = __float2bfloat16(y);
  }
  if (tid == 0) p.counters[strip] = 0u;
}

// seg_rows and splits for a call: the largest segment that still gives two
// blocks per SM, else 16.
template <bool W4>
inline void gemv_plan(GemvParams& p, int sms) {
  const int KB = W4 ? p.K / 2 : p.K;
  const int strips = p.N / GEMV_COLS;
  for (int seg : {64, 32, 16}) {
    p.seg_rows = seg;
    p.splits = (KB + gemv_block_rows(seg) - 1) / gemv_block_rows(seg);
    if (strips * p.splits >= 2 * sms) break;
  }
}

template <int TR, bool W4>
inline cudaError_t launch_gemv_tr(const GemvParams& p, cudaStream_t st) {
  const size_t smem = gemv_smem<W4>(p.T, p.seg_rows);  // at most 32 KB
  dim3 grid(p.N / GEMV_COLS, p.splits);
  linear_gemv_kernel<TR, W4><<<grid, GEMV_THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

// Rules the callers check: 1 <= T <= 16, K % 32 == 0 (K7: K % 128 == 0),
// N % 128 == 0, 16-byte aligned pointers; p.partial sized by gemv_partial_bytes.
template <bool W4>
inline cudaError_t launch_gemv(GemvParams p, int sms, cudaStream_t st) {
  if (p.T < 1 || p.T > GEMV_MAX_T || p.K % (W4 ? GEMV_GROUP : 32) || p.N % GEMV_COLS)
    return cudaErrorInvalidValue;
  gemv_plan<W4>(p, sms);
  if (p.T == 1) return launch_gemv_tr<1, W4>(p, st);
  if (p.T == 2) return launch_gemv_tr<2, W4>(p, st);
  if (p.T <= 4) return launch_gemv_tr<4, W4>(p, st);
  return launch_gemv_tr<GEMV_TR, W4>(p, st);
}

// the scratch the GEMV needs at (T, K, N): K5's split partials or K7's
// group products
template <bool W4>
inline size_t gemv_partial_bytes(int T, int K, int N, int sms) {
  GemvParams p = {};
  p.T = T;
  p.K = K;
  p.N = N;
  gemv_plan<W4>(p, sms);
  const size_t planes = W4 ? K / GEMV_GROUP : p.splits;
  return planes * T * static_cast<size_t>(N) * 4;
}

}  // namespace emr2a
