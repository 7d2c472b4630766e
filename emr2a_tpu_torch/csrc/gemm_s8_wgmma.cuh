// The s8 tensor-core GEMM of the port's W8A8 and W4A8 kernels on Hopper's
// wgmma, fed by TMA through an mbarrier ring, persistent. Its users:
// - K2 (mlp_int8.cu, replacing emr2a_tpu/ops/mlp.py:_mlp_kernel_int8): fc1
//   with the gelu epilogue into the f32 h1 scratch, fc2 with the residual;
// - K4 (attention_block_int8.cu, replacing
//   emr2a_tpu/ops/attention_block.py:_attn_block_kernel_i8): the Q/K/V
//   projections in one launch over three weights, the out-projection with
//   the residual;
// - K5 (linear_int8.cu) and K7 (linear_int4.cu, W4A8) above 16 rows.
// The rows are quantized first by quant.cuh's row pass (x codes (T, K) s8,
// scales (T,) f32).
//
// Epilogues (EPI), each on y = ((f32(acc) * x_scale) * w_scale) + bias, two
// rounded multiplies and a rounded add (__fmul_rn / __fadd_rn), as
// emr2a_tpu/ops/linear_int8.py:_s8_dot and the fused int8 kernels round:
//   EPI_S8_BF16       out bf16 = bf16(y)                  (K5; K4 Q/K/V)
//   EPI_S8_GELU_F32   out f32  = gelu_tanh(y)             (K2 fc1)
//   EPI_S8_RESIDUAL   out bf16 = residual + bf16(y)       (K2 fc2, K4 out-proj)
//   EPI_S8_GELU_BF16  out f32  = gelu_tanh_bf16(bf16(y))  (K2 fc1, act_dtype=bf16)
//   EPI_S8_QGELU_F32, EPI_S8_QGELU_BF16: the same two with CLIP's quick_gelu
// (the gelu expressions of common.cuh; K7 folds its group sums first, below).
// The s32 sums are exact, so every output is the plain version's
// (torch._int_mm or the f32 matmul of the codes, then the same rescale) bit
// for bit.
//
// Bound on the H100: the 2*T*K*N s8 operations over 1,979 TOP/s at every
// shape of the tower (at ViT-B and T = 6,400: K2 2 x 30.2 GOP, K4 4 x 7.5
// GOP a block) and at the judge's prefill; K2's f32 h1 (T x 3,072 x 4
// bytes written here, read back by the row pass) is a byte floor of its
// own, 0.059 ms at T = 6,400 with the codes, whatever this GEMM does.
//
// Layout, and why the operands are swapped. For 8-bit types wgmma takes both
// operands K-major only. The x codes (T, K) are K-major; the weights are
// stored (K, N) with N contiguous (the JAX package's kernel_q and the packed
// w_p), which is N-major. Rather than keep a second, transposed copy of every
// weight on the card (the int8 decoder alone is 9.87 GiB), the block computes
// Y^T = W^T X^T: the weight tile is wgmma's A operand, taken from registers,
// and the x codes are its B operand, read from shared memory. Each thread
// builds its A fragments from the TMA-loaded weight tile: shared loads of
// its columns from four k rows, a byte transpose (transpose4x4, as in the
// GEMV) and, for int4, sext_nibbles of the low and high nibbles.
// The M rows of a warp's A fragment are permuted so that a thread's
// fragment rows (rows g and g + 8 of each m64 tile it takes) are
// consecutive weight columns: one shared load a k row gives them all, and
// the epilogue writes them as consecutive outputs (4 columns: 16 bytes of
// f32 h1, 8 of bf16).
//
// Design: a persistent warp-specialised kernel, one block an SM (grid =
// min(tiles, SMs)), walking tiles b, b + grid, ... (K7 takes one tile a
// block: its f32 group sums leave no registers for the loop). A tile is
// 128 weight columns x BT token rows of one weight; the column blocks of
// all NZ weights (K4's Q/K/V: 3) of a token block are consecutive tiles, so
// the blocks in flight share their x rows through L2. 384 threads.
// Warpgroup 2 is the producer, its registers handed to the consumers by
// setmaxnreg (40 and 232 a thread): one lane issues the TMA loads of each
// 128-deep stage (x codes: BT rows x 128 bytes; weights: 128 rows x 128
// columns in s8, or one group's 64 packed byte rows), both with the
// 128-byte swizzle, into a ring of 4 stages (8 where 8 fit in 192 KB), with
// a full and an empty mbarrier each; it runs ahead across tiles, so the
// next tile's loads overlap this tile's epilogue. Warpgroups 0 and 1 are
// the consumers:
// - W8A8 (K2, K4, K5; two m64 tiles a warpgroup, 4 columns a thread): the
//   warpgroups split the tokens, BT = 2 NT. Each k-step (32 deep) of MT
//   wgmma m64nNTk32 s8 x s8 -> s32 is its own commit group, and up to four
//   stay in flight: the A fragments of k-step s are rebuilt for the next
//   stage as soon as that k-step's group has completed, while the other
//   three run, and a stage is released once its last group has completed;
//   the next stage's weight words are read from shared memory meanwhile.
// - K7 (one m64 tile, 2 columns a thread): its f32 group sums double the
//   registers a thread holds, so the warpgroups split the columns instead,
//   64 each, over BT = NT token rows; a stage is one 128-deep group, and
//   after its wgmma group completes each thread folds the s32 tile into f32
//   sums in group order, y + f32(acc_g) * w_scale[g] (each one rounded
//   multiply and one rounded add); the epilogue then applies the row scale
//   and the bias, as linear_w4a8_reference.
// The epilogue loads the row scales (and the residual) of a group of 4
// token octets before it stores any of them: the output stores, which the
// compiler cannot tell apart from those loads, otherwise kept one load
// latency per token pair in the way (K4's out-projection took 0.042 ms at
// T = 6,400 on the H100 that way, 0.025 with the groups). Ping-pong
// consumers (one warpgroup a tile, their mainloops in turn) measured no
// faster for fc1 and slower for K5, so the warpgroups share each tile.
// The token tile BT is chosen per call (wg_block_rows_for): the candidate
// with the least ceil(tiles / SMs) x (BT + WG_STAGE_ROWS), i.e. whole waves
// of tiles times a tile's cost, a stage's fixed work (the weight tile's
// copy, its fragments) counted as WG_STAGE_ROWS token rows. At T = 6,400
// that is 256 rows for N = 3,072 and 2,304 (4.5 and 3.4 waves) and 160 for
// N = 768 (240 tiles, 1.8 waves, where 256-row tiles give 150 tiles and
// 1.14 waves). Rows past T and k past K are TMA's zero fill; rows past T
// are not stored.
#pragma once

#include "tma.cuh"

namespace emr2a {

enum EpilogueS8 {
  EPI_S8_BF16 = 0, EPI_S8_GELU_F32 = 1, EPI_S8_RESIDUAL = 2, EPI_S8_GELU_BF16 = 3,
  EPI_S8_QGELU_F32 = 4, EPI_S8_QGELU_BF16 = 5
};

constexpr int WG_BM = 128;       // weight columns of a tile (two m64 tiles)
constexpr int WG_BK = 128;       // k of a stage (K7: one group)
constexpr int WG_RING_BYTES = 192 * 1024;        // the stages of a block
constexpr int WG_CONSUMERS = 256;                // two consumer warpgroups
constexpr int WG_THREADS = WG_CONSUMERS + 128;   // and a producer warpgroup
constexpr int WG_STAGE_ROWS = 128;               // a stage's fixed work, in token rows

struct WgmmaParams {
  const float* x_scale;     // (T,)
  const float* w_scale[3];  // per weight: (N,); K7 (K / 128, N)
  const bf16* bias[3];      // per weight: (N,) or null
  void* out[3];             // per weight: (T, N), f32 for the gelu epilogues, else bf16
  const bf16* residual;     // (T, N), EPI_S8_RESIDUAL only
  int T, K, N;
};

// the token rows of a block: MT m64 tiles and NT token rows (wgmma's N) a
// consumer warpgroup
template <int MT, int NT>
__host__ __device__ constexpr int wg_block_rows() { return MT == 2 ? 2 * NT : NT; }
template <bool W4>
__host__ __device__ constexpr int wg_w_rows() { return W4 ? WG_BK / 2 : WG_BK; }

template <bool W4, int MT, int NT>
struct WgTile {
  static constexpr int XB = wg_block_rows<MT, NT>() * WG_BK;   // x codes of a stage
  static constexpr int STAGE = XB + wg_w_rows<W4>() * WG_BM;
  // 4 or 8, a power of two: a stage's slot and phase are a mask and a shift
  static constexpr int STAGES = WG_RING_BYTES / STAGE >= 8 ? 8 : 4;
  static constexpr size_t SMEM = 1024 + static_cast<size_t>(STAGES) * STAGE + 2 * STAGES * 8;
};

// D (64 x N s32) (+)= A (64 x 32 s8, registers) x B (32 x N s8, shared);
// accumulate = 0 ignores D's old value
template <int N>
__device__ __forceinline__ void wgmma_s8(int* d, const uint32_t* a, uint64_t desc, int accumulate);

template <>
__device__ __forceinline__ void wgmma_s8<64>(int* d, const uint32_t* a, uint64_t desc,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<80>(int* d, const uint32_t* a, uint64_t desc,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<96>(int* d, const uint32_t* a, uint64_t desc,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int* d, const uint32_t* a, uint64_t desc,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<192>(int* d, const uint32_t* a, uint64_t desc,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// A thread's weight words of one stage: with MT = 2 m64 tiles a warpgroup,
// 4 consecutive columns (col .. col + 3), one 32-bit word a k row; with MT =
// 1, 2 columns, one 16-bit load a k row, rows paired into words. s8: k-step
// s (0..3) takes rows 32 s + 4 tq + i and 32 s + 16 + 4 tq + i, words
// raw[8 s .. 8 s + 7] (MT = 2). int4: byte rows 32 s + 4 tq + i (+ 16) for
// s = 0, 1 hold k-steps s (low nibbles) and s + 2 (high). Rows are read in
// the order i ^ (tq & 2), which puts the four tq of a warp on distinct banks.
template <bool W4, int MT>
__host__ __device__ constexpr int wg_raw_words() { return (W4 ? 2 : 4) * 2 * (MT == 2 ? 4 : 2); }

template <bool W4, int MT>
__device__ __forceinline__ void wg_load_words(const int8_t* tile, int tq, int col,
                                              uint32_t (&raw)[wg_raw_words<W4, MT>()]) {
  const int sw = tq & 2;
#pragma unroll
  for (int s = 0; s < (W4 ? 2 : 4); ++s)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r0 = 32 * s + 16 * half + 4 * tq;
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* q = tile + swz128(r0 + (i ^ sw), col);
        v[i] = MT == 2 ? *reinterpret_cast<const uint32_t*>(q)
                       : *reinterpret_cast<const uint16_t*>(q);
      }
      // v[i] holds row i ^ sw
      const uint32_t r[4] = {sw ? v[2] : v[0], sw ? v[3] : v[1], sw ? v[0] : v[2],
                             sw ? v[1] : v[3]};
      if constexpr (MT == 2) {
        const int o = (s * 2 + half) * 4;
#pragma unroll
        for (int i = 0; i < 4; ++i) raw[o + i] = r[i];
      } else {
        const int o = (s * 2 + half) * 2;
        raw[o] = r[0] | (r[1] << 16);        // rows 0, 1: bytes c0 c1 c0 c1
        raw[o + 1] = r[2] | (r[3] << 16);    // rows 2, 3
      }
    }
}

// RAW words of step s (W4: of k-steps s and s + 2) -> A fragments
// a[k-step][m tile][4]: the fragment rows g and g + 8 of m tile m are
// columns col + 2m and col + 2m + 1
template <bool W4, int MT>
__device__ __forceinline__ void wg_fragments_step(const uint32_t (&raw)[wg_raw_words<W4, MT>()],
                                                  int s, uint32_t (&a)[4][MT][4]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t c[2 * MT];   // c[j]: column col + j, four consecutive k
    if constexpr (MT == 2) {
      const int o = (s * 2 + half) * 4;
      transpose4x4(raw[o], raw[o + 1], raw[o + 2], raw[o + 3], c);
    } else {
      const int o = (s * 2 + half) * 2;
      c[0] = __byte_perm(raw[o], raw[o + 1], 0x6420);
      c[1] = __byte_perm(raw[o], raw[o + 1], 0x7531);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t word = c[2 * m + h];
        if (W4) {
          a[s][m][2 * half + h] = sext_nibbles(word);
          a[s + 2][m][2 * half + h] = sext_nibbles(word >> 4);
        } else {
          a[s][m][2 * half + h] = word;
        }
      }
  }
}

template <bool W4, int MT>
__device__ __forceinline__ void wg_fragments(const uint32_t (&raw)[wg_raw_words<W4, MT>()],
                                             uint32_t (&a)[4][MT][4]) {
#pragma unroll
  for (int s = 0; s < (W4 ? 2 : 4); ++s) wg_fragments_step<W4, MT>(raw, s, a);
}

template <int MT>
__device__ __forceinline__ void fence_fragments(uint32_t (&a)[MT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[m][i])::"memory");
}

// the 2 MT columns c of a thread at one token: v[c] -> EPI's output at
// element at of the (T, N) output; residual: the residual's 4 bf16 there
template <int EPI, int MT>
__device__ __forceinline__ void wg_store(void* out, uint2 residual, size_t at,
                                         float (&v)[2 * MT]) {
  if constexpr (EPI == EPI_S8_GELU_F32 || EPI == EPI_S8_GELU_BF16 || EPI == EPI_S8_QGELU_F32 ||
                EPI == EPI_S8_QGELU_BF16) {
    static_assert(MT == 2, "the f32 epilogues take 4 columns a thread");
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if constexpr (EPI == EPI_S8_GELU_F32) v[c] = gelu_tanh(v[c]);
      else if constexpr (EPI == EPI_S8_GELU_BF16) v[c] = gelu_tanh_bf16(round_bf16(v[c]));
      else if constexpr (EPI == EPI_S8_QGELU_F32) v[c] = quick_gelu(v[c]);
      else v[c] = quick_gelu_bf16(round_bf16(v[c]));
    }
    *reinterpret_cast<float4*>(static_cast<float*>(out) + at) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint32_t pk[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      __nv_bfloat162 b2 = __floats2bfloat162_rn(v[2 * m], v[2 * m + 1]);
      if constexpr (EPI == EPI_S8_RESIDUAL) {
        const uint32_t rw = m == 0 ? residual.x : residual.y;
        const __nv_bfloat162 r2 = *reinterpret_cast<const __nv_bfloat162*>(&rw);
        b2 = __floats2bfloat162_rn(
            __fadd_rn(__bfloat162float(r2.x), __bfloat162float(b2.x)),
            __fadd_rn(__bfloat162float(r2.y), __bfloat162float(b2.y)));
      }
      pk[m] = *reinterpret_cast<uint32_t*>(&b2);
    }
    bf16* dst = static_cast<bf16*>(out) + at;
    if constexpr (MT == 2)
      *reinterpret_cast<uint2*>(dst) = make_uint2(pk[0], pk[1]);
    else
      *reinterpret_cast<uint32_t*>(dst) = pk[0];
  }
}

// MT m64 tiles of weight columns and NT token rows a consumer warpgroup:
// MT = 2 (W8A8), the two warpgroups take token rows t0 .. + NT - 1 and
// t0 + NT .. of the tile's 2 NT; MT = 1 (K7), they take columns 0-63 and
// 64-127 of the tile's NT token rows. NZ weights (K4's Q/K/V: 3) share the
// x codes; tile t is token block t / (NZ nb), weight (t % (NZ nb)) / nb.
template <bool W4, int MT, int NT, int EPI, int NZ>
__global__ void __launch_bounds__(WG_THREADS, 1)
gemm_s8_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap0,
                     const __grid_constant__ CUtensorMap wmap1,
                     const __grid_constant__ CUtensorMap wmap2, WgmmaParams p) {
  static_assert(MT == 2 || EPI == EPI_S8_BF16, "K7's layout has the bf16 epilogue only");
  using Tile = WgTile<W4, MT, NT>;
  constexpr int STAGES = Tile::STAGES, SB = Tile::STAGE, XB = Tile::XB;
  constexpr int BT = wg_block_rows<MT, NT>();
  // K7 takes one tile a block: its f32 group sums leave no registers for
  // the persistent loop's state (44 bytes spilled, 4 % slower on the card)
  constexpr bool PERSIST = !W4;
  extern __shared__ uint8_t wg_smem_raw[];
  uint8_t* base = wg_smem_raw + ((1024 - (smem_u32(wg_smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + STAGES * SB);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nb = p.N / WG_BM;
  const int tiles = ((p.T + BT - 1) / BT) * NZ * nb;
  const int nk = (p.K + WG_BK - 1) / WG_BK;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, WG_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= WG_CONSUMERS / 32) {
    // the producer warpgroup: one lane issues the loads of every stage of
    // every tile of this block; its registers go to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == WG_CONSUMERS) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int c = t % (NZ * nb), t0 = (t / (NZ * nb)) * BT, z = c / nb;
        const int n0 = (c % nb) * WG_BM;
        const CUtensorMap* wmap = NZ == 1 || z == 0 ? &wmap0 : (z == 1 ? &wmap1 : &wmap2);
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(empty + s, ((it / STAGES) - 1) & 1);
          mbar_expect_tx(full + s, SB);
          tma_load_2d(base + s * SB, &xmap, kb * WG_BK, t0, full + s);
          tma_load_2d(base + s * SB + XB, wmap, n0, kb * wg_w_rows<W4>(), full + s);
        }
        if constexpr (!PERSIST) break;
      }
    }
    return;
  }
  // 232 registers a consumer thread: ptxas compiles the code past this
  // point for them (at the launch's 168, K5's 128-row warpgroups spilled
  // and ran 2.4 times slower on the card)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");

  const int wg = warp >> 2, wl = warp & 3, gq = lane >> 2, tq = lane & 3;
  // this thread's 2 MT weight columns in the tile
  const int col = MT == 2 ? wl * 32 + gq * 4 : wg * 64 + wl * 16 + gq * 2;
  constexpr int R = NT / 2;           // accumulators a thread, per m64 tile
  int acc[MT][R];
  float y[MT][W4 ? R : 1];
  uint32_t raw[wg_raw_words<W4, MT>()];
  uint32_t a[4][MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < R; ++i) acc[m][i] = 0;   // a tile's first k-step ignores them

  auto stage = [&](int i) { return base + (i % STAGES) * SB; };
  auto wait_full = [&](int i) { mbar_wait(full + i % STAGES, (i / STAGES) & 1); };
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + i % STAGES);
  };
  auto fence_acc = [&]() {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < R; ++i) reg_fence(acc[m][i]);
  };

  int it = 0;   // the stages of this block's earlier tiles
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, it += nk) {
    const int c = t % (NZ * nb), t0 = (t / (NZ * nb)) * BT, z = NZ == 1 ? 0 : c / nb;
    const int n0 = (c % nb) * WG_BM;
    const int tw = t0 + (MT == 2 ? wg * NT : 0);   // the warpgroup's first token row
    const int xoff = MT == 2 ? wg * NT * WG_BK : 0;
    auto w_tile = [&](int i) { return reinterpret_cast<const int8_t*>(stage(i) + XB); };

    if constexpr (!W4) {
      // k-step s of stage kb is commit group 4 kb + s; with the four groups
      // of a stage in flight, group 4 (kb - 1) + s is the oldest when step
      // s of stage kb is due, so wait_group 3 frees its fragments a[s]
      wait_full(it);
      wg_load_words<W4, MT>(w_tile(it), tq, col, raw);
      for (int kb = 0; kb < nk; ++kb) {
        const uint8_t* xb = stage(it + kb) + xoff;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          if (kb > 0) {
            wgmma_wait<3>();
            fence_fragments<MT>(a[s]);
          }
          wg_fragments_step<W4, MT>(raw, s, a);
          fence_acc();
          asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
          for (int m = 0; m < MT; ++m)
            wgmma_s8<NT>(acc[m], a[s][m], wg_desc(xb + s * 32), kb > 0 || s > 0);
          asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        }
        // stage kb - 1's last group has completed (the wait of step 3)
        if (kb > 0) release(it + kb - 1);
        if (kb + 1 < nk) {
          wait_full(it + kb + 1);
          wg_load_words<W4, MT>(w_tile(it + kb + 1), tq, col, raw);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int s = 0; s < 4; ++s) fence_fragments<MT>(a[s]);
      fence_acc();
      release(it + nk - 1);
    } else {
      // K7: each stage waits for its own wgmma group and folds it (holding
      // a second set of fragments or accumulators in flight spilled); the
      // next stage's weight words are read from shared memory while the
      // group runs
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < R; ++i) y[m][i] = 0.f;
      wait_full(it);
      wg_load_words<W4, MT>(w_tile(it), tq, col, raw);
      wg_fragments<W4, MT>(raw, a);
      for (int kb = 0; kb < nk; ++kb) {
        const uint8_t* xb = stage(it + kb) + xoff;
        fence_acc();
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int m = 0; m < MT; ++m)
            wgmma_s8<NT>(acc[m], a[s][m], wg_desc(xb + s * 32), s > 0);
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        if (kb + 1 < nk) {
          wait_full(it + kb + 1);
          wg_load_words<W4, MT>(w_tile(it + kb + 1), tq, col, raw);
        }
        wgmma_wait<0>();
        fence_acc();
        release(it + kb);
        // fold group kb into the f32 sums, in group order
        float wsc[2 * MT];
#pragma unroll
        for (int cc = 0; cc < 2 * MT; ++cc)
          wsc[cc] = p.w_scale[0][static_cast<size_t>(kb) * p.N + n0 + col + cc];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int i = 0; i < R; ++i)
            y[m][i] = __fadd_rn(y[m][i],
                                __fmul_rn(__int2float_rn(acc[m][i]), wsc[2 * m + ((i >> 1) & 1)]));
        if (kb + 1 < nk) wg_fragments<W4, MT>(raw, a);
      }
    }

    // epilogue: the thread holds, for tokens tw + 8 j + 2 tq + e (e = 0, 1),
    // the columns col + 2m + h in acc[m][4 j + 2 h + e] (K7: in y[m][...]);
    // the weight's pointers are selected by value (indexing the parameter
    // arrays by z would copy them to local memory)
    const float* __restrict__ ws = z == 0 ? p.w_scale[0] : (z == 1 ? p.w_scale[1] : p.w_scale[2]);
    const bf16* __restrict__ bias = z == 0 ? p.bias[0] : (z == 1 ? p.bias[1] : p.bias[2]);
    void* out = z == 0 ? p.out[0] : (z == 1 ? p.out[1] : p.out[2]);
    float wsc[2 * MT], bsc[2 * MT];
#pragma unroll
    for (int cc = 0; cc < 2 * MT; ++cc) {
      wsc[cc] = W4 ? 0.f : ws[n0 + col + cc];
      bsc[cc] = bias != nullptr ? __bfloat162float(bias[n0 + col + cc]) : 0.f;
    }
    // JB octets of tokens at a time: their row scales (and residual words)
    // are loaded before any of their stores, which the compiler may not
    // move loads across
    constexpr int JB = (NT / 8) % 4 == 0 ? 4 : 2;
#pragma unroll
    for (int j0 = 0; j0 < NT / 8; j0 += JB) {
      float xs[JB][2];
      uint2 res[JB][2];
#pragma unroll
      for (int jj = 0; jj < JB; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int tok = tw + 8 * (j0 + jj) + 2 * tq + e;
          xs[jj][e] = tok < p.T ? p.x_scale[tok] : 0.f;
          res[jj][e] = make_uint2(0u, 0u);
          if (EPI == EPI_S8_RESIDUAL && tok < p.T)
            res[jj][e] = *reinterpret_cast<const uint2*>(
                p.residual + static_cast<size_t>(tok) * p.N + n0 + col);
        }
#pragma unroll
      for (int jj = 0; jj < JB; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + jj, tok = tw + 8 * j + 2 * tq + e;
          if (tok >= p.T) continue;
          float v[2 * MT];
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 4 * j + 2 * h + e;
              float r = W4 ? __fmul_rn(y[m][W4 ? i : 0], xs[jj][e])
                           : __fmul_rn(__fmul_rn(__int2float_rn(acc[m][i]), xs[jj][e]),
                                       wsc[2 * m + h]);
              if (bias != nullptr) r = __fadd_rn(r, bsc[2 * m + h]);
              v[2 * m + h] = r;
            }
          wg_store<EPI, MT>(out, res[jj][e], static_cast<size_t>(tok) * p.N + n0 + col, v);
        }
    }
    if constexpr (!PERSIST) break;
  }
}

template <bool W4, int MT, int NT, int EPI, int NZ>
inline cudaError_t launch_wgmma(const CUtensorMap& xmap, const CUtensorMap* wmap,
                                const WgmmaParams& p, int sms, cudaStream_t st) {
  using Tile = WgTile<W4, MT, NT>;
  static std::atomic<uint64_t> sized{0};   // the devices whose attribute is set
  const cudaError_t err = smem_attr_once(gemm_s8_wgmma_kernel<W4, MT, NT, EPI, NZ>,
                                         static_cast<int>(Tile::SMEM), sized);
  if (err != cudaSuccess) return err;
  constexpr int BT = wg_block_rows<MT, NT>();
  const int tiles = ((p.T + BT - 1) / BT) * NZ * (p.N / WG_BM);
  const int grid = W4 || tiles < sms ? tiles : sms;   // K7: one tile a block
  gemm_s8_wgmma_kernel<W4, MT, NT, EPI, NZ><<<grid, WG_THREADS, Tile::SMEM, st>>>(
      xmap, wmap[0], wmap[NZ > 1 ? 1 : 0], wmap[NZ > 2 ? 2 : 0], p);
  return cudaGetLastError();
}

// The token rows of a tile at T tokens and col_tiles column tiles (all
// weights), among the block rows the kernel is built for (widest first):
// the least whole waves of tiles times a tile's cost, BT + WG_STAGE_ROWS
// row-equivalents a stage.
template <bool W4>
inline int wg_block_rows_for(int T, int col_tiles, int sms) {
  constexpr int W8_ROWS[4] = {256, 192, 160, 128}, W4_ROWS[2] = {192, 128};
  const int* rows = W4 ? W4_ROWS : W8_ROWS;
  int best = rows[0];
  long long best_cost = -1;
  for (int i = 0; i < (W4 ? 2 : 4); ++i) {
    const long long tiles = static_cast<long long>(col_tiles) * ((T + rows[i] - 1) / rows[i]);
    const long long cost = ((tiles + sms - 1) / sms) * (rows[i] + WG_STAGE_ROWS);
    if (best_cost < 0 || cost < best_cost) {
      best = rows[i];
      best_cost = cost;
    }
  }
  return best;
}

// xq (T, K) s8 codes; w[z] (K, N) s8 or (K / 2, N) packed int4, z < NZ.
// Rules the callers check: K % 32 == 0 (K7: K % 128 == 0), N % 128 == 0,
// T >= 1, 16-byte aligned pointers.
template <bool W4, int EPI, int NZ = 1>
inline cudaError_t launch_gemm_s8_wgmma(const int8_t* xq, const int8_t* const* w,
                                        const WgmmaParams& p, int sms, cudaStream_t st) {
  static_assert(NZ >= 1 && NZ <= 3 && (NZ == 1 || !W4), "K7 has one weight");
  if (p.T < 1 || p.K % (W4 ? WG_BK : 32) || p.N % WG_BM || sms < 1) return cudaErrorInvalidValue;
  const int bt = wg_block_rows_for<W4>(p.T, NZ * (p.N / WG_BM), sms);
  CUtensorMap xmap, wmap[3];
  cudaError_t err = encode_u8_map(&xmap, xq, p.T, p.K, bt);
  for (int z = 0; z < NZ && err == cudaSuccess; ++z)
    err = encode_u8_map(&wmap[z], w[z], W4 ? p.K / 2 : p.K, p.N, wg_w_rows<W4>());
  if (err != cudaSuccess) return err;
  if constexpr (W4) {
    return bt == 192 ? launch_wgmma<W4, 1, 192, EPI, NZ>(xmap, wmap, p, sms, st)
                     : launch_wgmma<W4, 1, 128, EPI, NZ>(xmap, wmap, p, sms, st);
  } else {
    switch (bt / 2) {
      case 128: return launch_wgmma<W4, 2, 128, EPI, NZ>(xmap, wmap, p, sms, st);
      case 96: return launch_wgmma<W4, 2, 96, EPI, NZ>(xmap, wmap, p, sms, st);
      case 80: return launch_wgmma<W4, 2, 80, EPI, NZ>(xmap, wmap, p, sms, st);
      default: return launch_wgmma<W4, 2, 64, EPI, NZ>(xmap, wmap, p, sms, st);
    }
  }
}

}  // namespace emr2a
