// Streaming W4A8 linear (K7) for Hopper (sm_90a).
//
// Replaces emr2a_tpu/ops/linear_int4.py:linear_w4a8 (the Pallas kernels
// _linear_kernel_w4_cached and _linear_kernel_w4_s8, arithmetic in _w4_dot):
//   y = bf16( (sum_g f32(acc_g) * w_scale[g]) * x_scale + bias )
//   acc_g = s32 sum over the 128 rows of group g of q8(x) * unpack4(w_p)
// with q8 the row quantize of quant.cuh and the f32 sum over groups taken in
// group order, each step one rounded multiply and one rounded add
// (__fmul_rn / __fadd_rn, no contraction), then the row scale, then the
// bias, as _w4_dot rounds them. The kernel is bit-identical to the plain
// version (ops/linear_int4.linear_w4a8_reference).
//
// Packing (emr2a_tpu/ops/linear_int4.py:quantize_weight_int4, group 128):
// byte row g*64 + r of w_p (K/2, N) holds row g*128 + r in its low nibble and
// row g*128 + 64 + r in its high nibble, both 4-bit two's complement.
//
// Bound on the H100: at decode (T = 1) the packed weights, K*N/2 bytes, are
// the whole stream (4096 -> 12288: 25 MB, 7.5 us at 3.35 TB/s); at prefill
// (T ~ 2k) the 2*T*K*N s8 operations bound it.
//
// Two designs, chosen by T:
// - T <= 16 (decode), a GEMV in one launch: one block per strip of 32
//   columns, which it takes over the whole of K, so that its group products
//   are summed in group order in the same launch. Its warps take the
//   groups in turn; each lane reads 4 columns of 4 byte rows at a time (four
//   32-bit loads, 32 bytes a row across 8 lanes), transposes the 4x4 bytes
//   so that each column's 4 consecutive rows sit in one word, sign-extends
//   the nibbles per byte and takes dp4a against the x codes. The s32 sums of
//   a group's four row quarters are added across lanes (integer addition is
//   exact in any order); the rounded product f32(acc_g) * w_scale[g] goes to
//   shared memory, (T, G, 32) f32. After the last group one thread per
//   output sums them in group order, then applies the row scale and the
//   bias. Strips of 32 columns give N / 32 blocks (32 at N = 1024). A
//   block has 8 warps, and at T = 1 32 (16 where N / 32 blocks of 32 warps
//   would not fit the card in one wave), so that enough groups are in
//   flight at once: at 8 warps, T = 1 ran slower than a two-launch design.
// - T > 16 (prefill), or a GEMV block's shared memory over 227 KB, a tiled
//   GEMM: 128x128 output tiles, 8 warps of 64x32, mma.sync m16n8k32 s8 x
//   s8 -> s32. Per group, the block stages the 128 x 128 x codes and the
//   64 packed byte rows x 128 columns in shared memory,
//   the latter expanded to s8 and stored [column][k] (the "col" operand of
//   mma), then 4 k-steps of 32; after the group each thread folds its s32
//   tile into its f32 accumulators in registers, in group order.
// No TMA, wgmma or pipelining yet: this is the simple first version.
#include "quant.cuh"

namespace emr2a {

constexpr int W4_GROUP = 128;
constexpr int W4_GEMV_MAX_T = 16;
constexpr int W4_GEMV_WARPS = 8;                    // T > 1; T = 1 takes 16 or 32
constexpr int W4_GEMV_COLS = 32;                    // columns of a GEMV block
constexpr size_t W4_GEMV_MAX_SMEM = 227 * 1024;     // a block's shared memory
constexpr int W4_BM = 128;
constexpr int W4_BN = 128;
constexpr int W4_THREADS = 256;
constexpr int W4_LD = W4_GROUP + 16;  // shared row stride in bytes

// byte j of the result = byte j of each of w0..w3, i.e. the 4x4 byte
// transpose: c[j] holds column j of four consecutive byte rows
__device__ __forceinline__ void transpose4x4(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3,
                                             uint32_t* c) {
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140);
  const uint32_t t1 = __byte_perm(w2, w3, 0x5140);
  const uint32_t t2 = __byte_perm(w0, w1, 0x7362);
  const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

// the four low (or, after >> 4, high) nibbles of a packed word as s8 bytes
__device__ __forceinline__ uint32_t sext_nibbles(uint32_t w) {
  return __vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

// the GEMV's shared memory for T rows: the group products, (T, G, 32) f32
inline size_t w4_gemv_smem(int T, int K) {
  return static_cast<size_t>(T) * (K / W4_GROUP) * W4_GEMV_COLS * sizeof(float);
}

__device__ __forceinline__ uint32_t ldg_u32(const int8_t* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// The GEMV: grid N / 32, WARPS warps; block -> strip of 32 columns, warp ->
// groups warp, warp + WARPS, ... Lane l reads columns 4 * (l & 7) .. + 3 of the
// strip in byte rows 4 * (l >> 3) .. + 3 of each 16-row step; the four row
// quarters' s32 sums are added across lanes (exact), and the rounded group
// product goes to shared memory. After the block's groups, one thread per
// (row, column) sums them in group order. TR >= T rows are unrolled; rows
// t >= T are skipped. Dynamic shared memory: T * G * 32 floats.
template <int TR, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
w4_gemv_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
               const int8_t* __restrict__ wp, const float* __restrict__ ws,
               const bf16* __restrict__ bias, bf16* __restrict__ out, int T, int K, int N) {
  extern __shared__ float part[];  // [T][G][W4_GEMV_COLS]
  const int G = K / W4_GROUP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cq = lane & 7, rq = lane >> 3;
  const int n0 = blockIdx.x * W4_GEMV_COLS;
  const int n = n0 + cq * 4;

  for (int g = warp; g < G; g += WARPS) {
    const int8_t* w = wp + (size_t)g * (W4_GROUP / 2) * N + n;
    int acc[TR][4];
#pragma unroll
    for (int t = 0; t < TR; ++t)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[t][j] = 0;

#pragma unroll
    for (int step = 0; step < W4_GROUP / 32; ++step) {
      const int br = step * 16 + rq * 4;  // first of this lane's 4 byte rows
      const int8_t* rows = w + (size_t)br * N;
      uint32_t c[4];
      transpose4x4(ldg_u32(rows), ldg_u32(rows + N), ldg_u32(rows + 2 * N), ldg_u32(rows + 3 * N), c);
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lo[j] = sext_nibbles(c[j]);
        hi[j] = sext_nibbles(c[j] >> 4);
      }
#pragma unroll
      for (int t = 0; t < TR; ++t) {
        if (t >= T) break;
        const int8_t* xr = xq + (size_t)t * K + g * W4_GROUP + br;
        const int xl = static_cast<int>(ldg_u32(xr));
        const int xh = static_cast<int>(ldg_u32(xr + W4_GROUP / 2));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[t][j] = __dp4a(static_cast<int>(lo[j]), xl, acc[t][j]);
          acc[t][j] = __dp4a(static_cast<int>(hi[j]), xh, acc[t][j]);
        }
      }
    }
    const float4 s = *reinterpret_cast<const float4*>(ws + (size_t)g * N + n);
#pragma unroll
    for (int t = 0; t < TR; ++t) {
      if (t >= T) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[t][j] += __shfl_xor_sync(0xffffffffu, acc[t][j], 8);
        acc[t][j] += __shfl_xor_sync(0xffffffffu, acc[t][j], 16);
      }
      if (rq == 0) {
        float* p = part + ((size_t)t * G + g) * W4_GEMV_COLS + cq * 4;
        p[0] = __fmul_rn(__int2float_rn(acc[t][0]), s.x);
        p[1] = __fmul_rn(__int2float_rn(acc[t][1]), s.y);
        p[2] = __fmul_rn(__int2float_rn(acc[t][2]), s.z);
        p[3] = __fmul_rn(__int2float_rn(acc[t][3]), s.w);
      }
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < T * W4_GEMV_COLS; idx += WARPS * 32) {
    const int t = idx / W4_GEMV_COLS, col = idx - t * W4_GEMV_COLS;
    const float* p = part + (size_t)t * G * W4_GEMV_COLS + col;
    float y = 0.f;
    for (int g = 0; g < G; ++g) y = __fadd_rn(y, p[g * W4_GEMV_COLS]);
    y = __fmul_rn(y, xs[t]);
    if (bias != nullptr) y = __fadd_rn(y, __bfloat162float(bias[n0 + col]));
    out[(size_t)t * N + n0 + col] = __float2bfloat16(y);
  }
}

__device__ __forceinline__ void mma_s8_16832(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The GEMM: grid (N / 128, ceil(M / 128)).
__global__ void __launch_bounds__(W4_THREADS)
w4_gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
               const int8_t* __restrict__ wp, const float* __restrict__ ws,
               const bf16* __restrict__ bias, bf16* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) int8_t As[W4_BM][W4_LD];  // x codes [row][k]
  __shared__ __align__(16) int8_t Bs[W4_BN][W4_LD];  // weights [column][k]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.y * W4_BM, n0 = blockIdx.x * W4_BN;
  const int G = K / W4_GROUP;

  float y[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[i][j][e] = 0.f;

  for (int g = 0; g < G; ++g) {
    // x codes: 128 rows x 128 bytes, 16 bytes a thread per step
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * W4_THREADS;
      const int r = idx >> 3, c = (idx & 7) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M)
        v = __ldg(reinterpret_cast<const uint4*>(xq + (size_t)(m0 + r) * K + g * W4_GROUP + c));
      *reinterpret_cast<uint4*>(&As[r][c]) = v;
    }
    // packed weights: 64 byte rows x 128 columns as 16 x 32 tasks of 4 x 4
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int task = tid + i * W4_THREADS;
      const int rq = task >> 5, cq = task & 31;
      const int8_t* src = wp + (size_t)(g * (W4_GROUP / 2) + rq * 4) * N + n0 + cq * 4;
      uint32_t c[4];
      transpose4x4(ldg_u32(src), ldg_u32(src + N), ldg_u32(src + 2 * N), ldg_u32(src + 3 * N), c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        *reinterpret_cast<uint32_t*>(&Bs[cq * 4 + j][rq * 4]) = sext_nibbles(c[j]);
        *reinterpret_cast<uint32_t*>(&Bs[cq * 4 + j][W4_GROUP / 2 + rq * 4]) = sext_nibbles(c[j] >> 4);
      }
    }
    __syncthreads();

    int acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
#pragma unroll
    for (int kk = 0; kk < W4_GROUP / 32; ++kk) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm * 64 + i * 16 + gq;
        const int k = kk * 32 + tq * 4;
        a[i][0] = *reinterpret_cast<const uint32_t*>(&As[r][k]);
        a[i][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][k]);
        a[i][2] = *reinterpret_cast<const uint32_t*>(&As[r][k + 16]);
        a[i][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][k + 16]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cidx = wn * 32 + j * 8 + gq;
        const int k = kk * 32 + tq * 4;
        b[j][0] = *reinterpret_cast<const uint32_t*>(&Bs[cidx][k]);
        b[j][1] = *reinterpret_cast<const uint32_t*>(&Bs[cidx][k + 16]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8_16832(acc[i][j], a[i], b[j]);
    }
    // fold the group into the f32 sums, in group order
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn * 32 + j * 8 + tq * 2;
      const float2 s = *reinterpret_cast<const float2*>(ws + (size_t)g * N + col);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        y[i][j][0] = __fadd_rn(y[i][j][0], __fmul_rn(__int2float_rn(acc[i][j][0]), s.x));
        y[i][j][1] = __fadd_rn(y[i][j][1], __fmul_rn(__int2float_rn(acc[i][j][1]), s.y));
        y[i][j][2] = __fadd_rn(y[i][j][2], __fmul_rn(__int2float_rn(acc[i][j][2]), s.x));
        y[i][j][3] = __fadd_rn(y[i][j][3], __fmul_rn(__int2float_rn(acc[i][j][3]), s.y));
      }
    }
    __syncthreads();
  }

  // epilogue: row scale, bias, bf16 pairs
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn * 32 + j * 8 + tq * 2;
    float b0 = 0.f, b1 = 0.f;
    if (bias != nullptr) {
      b0 = __bfloat162float(bias[col]);
      b1 = __bfloat162float(bias[col + 1]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + i * 16 + gq + half * 8;
        if (row >= M) continue;
        const float s = xs[row];
        float v0 = __fmul_rn(y[i][j][2 * half], s);
        float v1 = __fmul_rn(y[i][j][2 * half + 1], s);
        if (bias != nullptr) {
          v0 = __fadd_rn(v0, b0);
          v1 = __fadd_rn(v1, b1);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <int TR, int WARPS = W4_GEMV_WARPS>
cudaError_t launch_w4_gemv(const int8_t* xq, const float* xs, const int8_t* wp, const float* ws,
                           const bf16* bias, bf16* out, int T, int K, int N, cudaStream_t st) {
  const size_t smem = w4_gemv_smem(T, K);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(w4_gemv_kernel<TR, WARPS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  w4_gemv_kernel<TR, WARPS><<<N / W4_GEMV_COLS, WARPS * 32, smem, st>>>(xq, xs, wp, ws, bias,
                                                                         out, T, K, N);
  return cudaGetLastError();
}

}  // namespace emr2a

using namespace emr2a;

// x (T, K) bf16; w_p (K/2, N) s8 packed; w_scale (K/128, N) f32; bias (N,)
// bf16 or null; scratch xq (T, K) s8 and xs (T,) f32; out (T, N) bf16; sms
// the card's SM count.
// Rules the wrapper checks: K % 128 == 0, N % 128 == 0, T >= 1, 16-byte
// aligned pointers.
extern "C" int emr2a_linear_w4a8(const void* x, const void* w_p, const void* w_scale,
                                 const void* bias, void* xq, void* xs, void* out, int T, int K,
                                 int N, int sms, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (T < 1 || K % W4_GROUP || N % W4_BN) return static_cast<int>(cudaErrorInvalidValue);
  QuantParams qp = {};
  qp.x = x;
  qp.q = static_cast<int8_t*>(xq);
  qp.scale = static_cast<float*>(xs);
  qp.rows = T;
  qp.K = K;
  cudaError_t err = launch_quantize_rows<bf16, false>(qp, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int8_t* q = static_cast<const int8_t*>(xq);
  const float* qs = static_cast<const float*>(xs);
  const int8_t* w = static_cast<const int8_t*>(w_p);
  const float* s = static_cast<const float*>(w_scale);
  const bf16* b = static_cast<const bf16*>(bias);
  bf16* o = static_cast<bf16*>(out);
  if (T <= W4_GEMV_MAX_T && w4_gemv_smem(T, K) <= W4_GEMV_MAX_SMEM) {
    // T = 1: 32 warps a block while the N / 32 blocks fit two to an SM
    // (one wave), else 16 (at 8 the few groups per block leave the loads
    // of too few warps in flight)
    if (T == 1 && N / W4_GEMV_COLS <= 2 * sms) err = launch_w4_gemv<1, 32>(q, qs, w, s, b, o, T, K, N, st);
    else if (T == 1) err = launch_w4_gemv<1, 16>(q, qs, w, s, b, o, T, K, N, st);
    else if (T <= 2) err = launch_w4_gemv<2>(q, qs, w, s, b, o, T, K, N, st);
    else if (T <= 4) err = launch_w4_gemv<4>(q, qs, w, s, b, o, T, K, N, st);
    else if (T <= 8) err = launch_w4_gemv<8>(q, qs, w, s, b, o, T, K, N, st);
    else err = launch_w4_gemv<16>(q, qs, w, s, b, o, T, K, N, st);
    return static_cast<int>(err);
  }
  dim3 grid(N / W4_BN, (T + W4_BM - 1) / W4_BM);
  w4_gemm_kernel<<<grid, W4_THREADS, 0, st>>>(q, qs, w, s, b, o, T, K, N);
  return static_cast<int>(cudaGetLastError());
}
