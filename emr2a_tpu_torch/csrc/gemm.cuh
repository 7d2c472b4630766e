// bf16 tensor-core GEMM for Hopper (sm_90a), shared by K1 (mlp.cu: fc1 and
// fc2) and K3 (attention_block.cu: the Q/K/V projections and the
// out-projection), with the LayerNorm row pass that precedes their first
// product. Together they take the place of the bodies of
// emr2a_tpu/ops/mlp.py:_mlp_kernel and
// emr2a_tpu/ops/attention_block.py:_attn_block_kernel.
//
//   h = bf16(LN(x))                                     (layer_norm_rows)
//   out[z] = epilogue(A @ B[z] + bias[z])    z < nz <= 3 (gemm_bf16_kernel)
//
// LN: f32 statistics in two passes (mean, then centred variance), the
// normalised row rounded to bf16: the rounding point of the TPU kernels,
// which round the LN output to the activation type before the product.
// A is (M, K) bf16, K-major; each B[z] is (K, N) bf16 row-major, N-major:
// the JAX package's (in, out) weight layout, so weights need no transpose.
//
// Epilogues, all on the f32 accumulator:
//   EPI_BIAS           bf16(acc + bias)                  (Q/K/V projections)
//   EPI_BIAS_GELU      bf16(gelu_tanh(acc + bias))       (MLP fc1)
//   EPI_BIAS_RESIDUAL  residual + bf16(acc + bias)       (fc2 / out-proj)
//   EPI_BIAS_GELU_BF16 bf16(gelu_tanh_bf16(bf16(acc + bias)))
//                                                        (fc1, act_dtype=bf16)
//   EPI_BIAS_QGELU, EPI_BIAS_QGELU_BF16: the same two with CLIP's quick_gelu
//                      (quick_gelu, quick_gelu_bf16 in common.cuh)
//
// Bound on the H100: 2*M*N*K bf16 operations over 989 TFLOP/s; at ViT-B
// (M = B * 200, K and N 768 or 3072) every product does some 400 to 1,000
// operations a byte, so the tensor cores bound it. wgmma is the only way to
// their full rate, and TMA feeds it without spending registers or
// instructions on the copy.
//
// Design: a persistent warp-specialised kernel. A block takes output tiles
// of 128 rows x BN columns (BN = 256 for N >= 2048, else 128: the tile and
// so the instruction shape depend on N only, never on M, so a row's result
// is the same at every M; K3m relies on that for its bit-identity with K3),
// tile t, t + grid, ... Warpgroup 2 is the producer: one lane issues the TMA
// loads of each 64-deep k stage (A: 128 rows x 128 bytes; B: BN / 64 boxes of
// 64 k rows x 128 bytes), both with the 128-byte swizzle, into a ring of
// stages (4 at BN 256, 6 at 128) with a full and an empty mbarrier each; it
// runs ahead across tiles, so the next tile's loads overlap this tile's
// epilogue. Its registers go to the consumers by setmaxnreg (40 and 232).
// Warpgroups 0 and 1 each own 64 rows of the tile and issue per stage four
// wgmma m64nBNk16 f32 += bf16 x bf16: A K-major from shared memory, B
// N-major from shared memory through the instruction's transpose bit (the
// descriptor's leading offset steps between 64-column boxes, its stride
// offset between 8-row core groups). One wgmma group stays in flight; a
// stage is released once its group has completed. The epilogue runs on
// the accumulator registers; each quad of lanes transposes its packed bf16
// pairs so that every lane stores (and, for the residual, loads) 16
// contiguous bytes, a quarter of the instructions of pair stores. Rows past
// M (TMA's zero fill) and columns past N are not stored. The tile shape and
// the epilogue were chosen on the card (PERF.md section 6): 128 x 64 tiles,
// and 128 x 128 tiles at two blocks an SM, measured slower.
#pragma once

#include "tma.cuh"

namespace emr2a {

enum Epilogue {
  EPI_BIAS = 0, EPI_BIAS_GELU = 1, EPI_BIAS_RESIDUAL = 2, EPI_BIAS_GELU_BF16 = 3,
  EPI_BIAS_QGELU = 4, EPI_BIAS_QGELU_BF16 = 5
};

constexpr int GEMM_BM = 128;                        // rows of a tile
constexpr int GEMM_BK = 64;                         // k of a stage: 128 bytes of A's row
constexpr int GEMM_CONSUMERS = 256;                 // two consumer warpgroups
constexpr int GEMM_THREADS = GEMM_CONSUMERS + 128;  // and a producer warpgroup
constexpr int GEMM_RING_BYTES = 192 * 1024;         // the stages of a block
constexpr int LN_THREADS = 256;                     // the row pass: a warp a row

template <int BN>
struct GemmTile {
  static constexpr int A_BYTES = GEMM_BM * GEMM_BK * 2;
  static constexpr int B_BOX = GEMM_BK * 128;       // 64 k rows x 64 columns
  static constexpr int STAGE = A_BYTES + (BN / 64) * B_BOX;
  static constexpr int STAGES = GEMM_RING_BYTES / STAGE;
  static constexpr size_t SMEM = 1024 + static_cast<size_t>(STAGES) * STAGE + 2 * STAGES * 8;
};

struct GemmParams {
  const bf16* bias[3];    // (N,) per z
  bf16* out[3];           // (M, N) per z
  const bf16* residual;   // (M, N), EPI_BIAS_RESIDUAL only
  int M, N, K, nz;
};

// h = bf16(LN(x)), one warp a row; K % 8 == 0 (static: each including
// translation unit keeps its own copy)
static __global__ void __launch_bounds__(LN_THREADS)
layer_norm_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ scale,
                       const bf16* __restrict__ bias, bf16* __restrict__ h, int rows, int K,
                       float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (LN_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const bf16* xr = x + static_cast<size_t>(row) * K;
  float s = 0.f;
  for (int k = lane * 8; k < K; k += 256) {
    Vec8 v;
    v.u = *reinterpret_cast<const uint4*>(xr + k);
#pragma unroll
    for (int t = 0; t < 8; ++t) s += __bfloat162float(v.h[t]);
  }
  const float mu = warp_sum(s) / static_cast<float>(K);
  float q = 0.f;
  for (int k = lane * 8; k < K; k += 256) {
    Vec8 v;
    v.u = *reinterpret_cast<const uint4*>(xr + k);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float dv = __bfloat162float(v.h[t]) - mu;
      q += dv * dv;
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / static_cast<float>(K) + eps);
  bf16* hr = h + static_cast<size_t>(row) * K;
  for (int k = lane * 8; k < K; k += 256) {
    Vec8 v, sc, b;
    v.u = *reinterpret_cast<const uint4*>(xr + k);
    sc.u = *reinterpret_cast<const uint4*>(scale + k);
    b.u = *reinterpret_cast<const uint4*>(bias + k);
#pragma unroll
    for (int t = 0; t < 8; ++t)
      v.h[t] = __float2bfloat16((__bfloat162float(v.h[t]) - mu) * rstd * __bfloat162float(sc.h[t]) +
                                __bfloat162float(b.h[t]));
    *reinterpret_cast<uint4*>(hr + k) = v.u;
  }
}

// Rules the wrappers check: rows >= 1, K % 8 == 0, 16-byte aligned rows.
inline cudaError_t launch_layer_norm_rows(const bf16* x, const bf16* scale, const bf16* bias,
                                          bf16* h, int rows, int K, float eps,
                                          cudaStream_t st) {
  if (rows < 1 || K < 8 || K % 8) return cudaErrorInvalidValue;
  const int per_block = LN_THREADS / 32;
  layer_norm_rows_kernel<<<(rows + per_block - 1) / per_block, LN_THREADS, 0, st>>>(
      x, scale, bias, h, rows, K, eps);
  return cudaGetLastError();
}

// wgmma's shared-memory descriptor of an MN-major tile with the 128-byte
// swizzle: 64-column boxes lbo bytes apart, 8-row core groups 1024 apart
__device__ __forceinline__ uint64_t wg_desc_mn(const void* p, int lbo) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// a 4 x 4 transpose across the 4 lanes of a quad: lane tq's w[k] goes to
// lane k's w[tq]. Two butterfly steps (lane bits 1, then 0), each swapping
// the two words whose index bit differs from the lane's.
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4], int tq) {
  const bool b = tq & 2, a = tq & 1;
  const uint32_t r0 = __shfl_xor_sync(0xffffffffu, b ? w[0] : w[2], 2);
  const uint32_t r1 = __shfl_xor_sync(0xffffffffu, b ? w[1] : w[3], 2);
  // y[r][c]: from lane (tq & 1) | 2 r, word 2 * (tq >> 1) + c
  const uint32_t y00 = b ? r0 : w[0], y01 = b ? r1 : w[1];
  const uint32_t y10 = b ? w[2] : r0, y11 = b ? w[3] : r1;
  const uint32_t s0 = __shfl_xor_sync(0xffffffffu, a ? y00 : y01, 1);
  const uint32_t s1 = __shfl_xor_sync(0xffffffffu, a ? y10 : y11, 1);
  const uint32_t o0 = a ? y01 : y00, o1 = a ? y11 : y10;
  w[0] = a ? s0 : o0;
  w[1] = a ? o0 : s0;
  w[2] = a ? s1 : o1;
  w[3] = a ? o1 : s1;
}

// D (64 x N f32) (+)= A (64 x 16 bf16, K-major, shared) x B (16 x N bf16,
// N-major, shared); accumulate = 0 ignores D's old value
template <int N>
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t a, uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_bf16<256>(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <int BN, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap amap,
                 const __grid_constant__ CUtensorMap bmap0,
                 const __grid_constant__ CUtensorMap bmap1,
                 const __grid_constant__ CUtensorMap bmap2, GemmParams p) {
  using Tile = GemmTile<BN>;
  constexpr int STAGES = Tile::STAGES, STAGE = Tile::STAGE;
  extern __shared__ uint8_t gemm_smem_raw[];
  uint8_t* base = gemm_smem_raw + ((1024 - (smem_u32(gemm_smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + STAGES * STAGE);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mt = (p.M + GEMM_BM - 1) / GEMM_BM, nt = (p.N + BN - 1) / BN;
  const int tiles = p.nz * mt * nt;
  const int nk = (p.K + GEMM_BK - 1) / GEMM_BK;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, GEMM_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= GEMM_CONSUMERS / 32) {
    // the producer warpgroup: one lane issues the loads of every stage of
    // every tile of this block; its registers go to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == GEMM_CONSUMERS) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int z = t / (mt * nt), r = t % (mt * nt);
        const int m0 = (r / nt) * GEMM_BM, n0 = (r % nt) * BN;
        const CUtensorMap* bmap = z == 0 ? &bmap0 : (z == 1 ? &bmap1 : &bmap2);
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(empty + s, ((it / STAGES) - 1) & 1);
          uint8_t* st = base + s * STAGE;
          mbar_expect_tx(full + s, STAGE);
          tma_load_2d(st, &amap, kb * GEMM_BK * 2, m0, full + s);
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            tma_load_2d(st + Tile::A_BYTES + c * Tile::B_BOX, bmap, (n0 + c * 64) * 2,
                        kb * GEMM_BK, full + s);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");

  const int wg = warp >> 2, wl = warp & 3, gq = lane >> 2, tq = lane & 3;
  float acc[BN / 2];
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int z = t / (mt * nt), r = t % (mt * nt);
    const int m0 = (r / nt) * GEMM_BM, n0 = (r % nt) * BN;
    for (int kb = 0; kb < nk; ++kb, ++it) {
      const int s = it % STAGES;
      mbar_wait(full + s, (it / STAGES) & 1);
      const uint8_t* a = base + s * STAGE + wg * 64 * 128;
      const uint8_t* b = base + s * STAGE + Tile::A_BYTES;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) reg_fence(acc[i]);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < GEMM_BK / 16; ++ks)
        wgmma_bf16<BN>(acc, wg_desc(a + ks * 32), wg_desc_mn(b + ks * 16 * 128, Tile::B_BOX),
                       kb > 0 || ks > 0);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) reg_fence(acc[i]);
      if (kb > 0) {
        // the previous stage's group has completed: release its stage
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + (it - 1) % STAGES);
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) reg_fence(acc[i]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + (it - 1) % STAGES);

    // epilogue: acc[4 j + 2 h + e] is row m0 + 64 wg + 16 wl + gq + 8 h,
    // column n0 + 8 j + 2 tq + e. Per row and 32 columns (octets j0 .. j0 +
    // 3), each lane packs its four bf16 pairs, the quad transposes them, and
    // lane tq stores octet j0 + tq as one 16-byte vector.
    const bf16* __restrict__ bias = z == 0 ? p.bias[0] : (z == 1 ? p.bias[1] : p.bias[2]);
    bf16* __restrict__ out = z == 0 ? p.out[0] : (z == 1 ? p.out[1] : p.out[2]);
    const int row0 = m0 + wg * 64 + wl * 16 + gq;
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += 4) {
      if (n0 + j0 * 8 >= p.N) break;
      float2 bv[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        bv[jj] = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(bias + n0 + (j0 + jj) * 8 + 2 * tq));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t w[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float v0 = acc[4 * (j0 + jj) + 2 * h] + bv[jj].x;
          float v1 = acc[4 * (j0 + jj) + 2 * h + 1] + bv[jj].y;
          if (EPI == EPI_BIAS_GELU) {
            v0 = gelu_tanh(v0);
            v1 = gelu_tanh(v1);
          } else if (EPI == EPI_BIAS_GELU_BF16) {
            v0 = gelu_tanh_bf16(round_bf16(v0));
            v1 = gelu_tanh_bf16(round_bf16(v1));
          } else if (EPI == EPI_BIAS_QGELU) {
            v0 = quick_gelu(v0);
            v1 = quick_gelu(v1);
          } else if (EPI == EPI_BIAS_QGELU_BF16) {
            v0 = quick_gelu_bf16(round_bf16(v0));
            v1 = quick_gelu_bf16(round_bf16(v1));
          }
          __nv_bfloat162 pk = __floats2bfloat162_rn(v0, v1);
          w[jj] = *reinterpret_cast<uint32_t*>(&pk);
        }
        quad_transpose(w, tq);
        const int row = row0 + 8 * h;
        if (row >= p.M) continue;
        const size_t at = static_cast<size_t>(row) * p.N + n0 + (j0 + tq) * 8;
        Vec8 o;
        o.u = make_uint4(w[0], w[1], w[2], w[3]);
        if (EPI == EPI_BIAS_RESIDUAL) {
          Vec8 res;
          res.u = *reinterpret_cast<const uint4*>(p.residual + at);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            o.h[e] = __float2bfloat16(__bfloat162float(res.h[e]) + __bfloat162float(o.h[e]));
        }
        *reinterpret_cast<uint4*>(out + at) = o.u;
      }
    }
  }
}

template <int BN, int EPI>
inline cudaError_t launch_gemm_tile(const CUtensorMap& amap, const CUtensorMap* bmap,
                                    const GemmParams& p, cudaStream_t st) {
  static std::atomic<uint64_t> sized{0};   // the devices whose attribute is set
  cudaError_t err = smem_attr_once(gemm_bf16_kernel<BN, EPI>,
                                   static_cast<int>(GemmTile<BN>::SMEM), sized);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = current_sms(&sms);
  if (err != cudaSuccess) return err;
  const int tiles = p.nz * ((p.M + GEMM_BM - 1) / GEMM_BM) * ((p.N + BN - 1) / BN);
  gemm_bf16_kernel<BN, EPI><<<tiles < sms ? tiles : sms, GEMM_THREADS, GemmTile<BN>::SMEM, st>>>(
      amap, bmap[0], bmap[1], bmap[2], p);
  return cudaGetLastError();
}

// The TMA maps of the operands: A (M, K) in boxes of 128 rows, B (K, N) in
// boxes of 64 k rows, both 128 bytes wide. A caller that runs several
// products on one operand encodes its map once.
inline cudaError_t encode_gemm_a(CUtensorMap* map, const void* a, int M, int K) {
  return encode_u8_map(map, a, M, 2 * K, GEMM_BM);
}

inline cudaError_t encode_gemm_b(CUtensorMap* map, const void* b, int K, int N) {
  return encode_u8_map(map, b, K, 2 * N, GEMM_BK);
}

// amap: A (p.M, p.K); bmap[z]: B[z] (p.K, p.N) for z < p.nz. Rules the
// wrappers check: N % 128 == 0, K % 64 == 0, M >= 1, 16-byte aligned
// pointers.
template <int EPI>
inline cudaError_t launch_gemm(const CUtensorMap& amap, const CUtensorMap* bmap,
                               const GemmParams& p, cudaStream_t st) {
  if (p.M < 1 || p.N % 128 || p.K % GEMM_BK || p.nz < 1 || p.nz > 3)
    return cudaErrorInvalidValue;
  const CUtensorMap b3[3] = {bmap[0], bmap[p.nz > 1 ? 1 : 0], bmap[p.nz > 2 ? 2 : 0]};
  return p.N >= 2048 ? launch_gemm_tile<256, EPI>(amap, b3, p, st)
                     : launch_gemm_tile<128, EPI>(amap, b3, p, st);
}

}  // namespace emr2a
