// The routed experts of a mixture-of-experts layer (K11), for Hopper
// (sm_90a):
//
//   K11  emr2a_moe_experts  replaces no TPU kernel: the JAX package runs no
//        expert layer. It was added for Kimi-VL's decoder
//        (models/kimi_vl.py): 64 SwiGLU experts of width 1,408 at hidden
//        2,048, each token routed to 6.
//
//   rows[p] = weight[p] * (silu(x[t] Wg_e) * (x[t] Wu_e)) Wd_e
//
// for each token-expert pair p = t * top_k + k with e = ids[t, k]; the
// caller sums a token's top_k rows. x (T, D) bf16; the experts' kernels
// w_gate_up (E, D, 2I) (gate columns, then up) and w_down (E, I, D) bf16,
// (in, out) as the model holds them; ids (T, top_k) int64; weight (T, top_k)
// f32; rows (T * top_k, D) f32. Rounding points: f32 accumulation of bf16
// products, silu(g) * u in f32 rounded once to bf16 (the h the down product
// reads), the down product in f32 times the pair's weight.
//
// Bound on the H100. Decode: 16 slots route 96 pairs, about 1.5 a routed
// expert, so each expert's 17.3 MB of weights carries a few operations a
// byte: the bytes of the routed experts bound it (26 layers x ~40 experts x
// 17.3 MB a step). The design reads each routed expert's weights once per
// block of its pairs and never an unrouted expert's. A prefill of 16 x 2,510
// tokens gives an expert thousands of pairs: the tensor cores bound it.
//
// Design, three launches from one C call (the widely used fused-MoE layout):
//
// 1. k11_align_kernel (one block): counts each expert's pairs in shared
//    memory, pads each expert's run to the block of BM rows, writes the
//    pairs' ids in expert order (slots of one expert taken by shared atomics,
//    so their order within the run varies; a pair's result does not, since
//    a row's products never depend on the row's place in its tile) with the
//    padding marked P (the pair count), and one expert id a block (-1 past
//    the last block in use). It adds to the device-side tally: the call's
//    pairs, calls, non-empty experts, and, by an atomic max, its largest
//    load.
// 2. k11_gemm_kernel<..., GATE_UP = true>: a block takes BM sorted pairs
//    and BN columns of its expert's gate kernel and the same BN of its up
//    kernel; the tokens' rows are gathered from x by cp.async into a ring of
//    NST stages beside the two weight tiles; mma.sync m16n8k16 (bf16 in, f32
//    accumulate) into two accumulators; the epilogue writes silu(g) * u as
//    bf16 to the sorted rows of h. Rows of padding read zeros and write 0.
// 3. k11_gemm_kernel<..., GATE_UP = false>: those rows of h against BN
//    columns of the expert's down kernel, times each pair's weight, stored in
//    f32 to the pair's own row of ``rows``: no atomics, so the caller's sum
//    over a token's rows is the same every call.
//
// The grids are sized for the worst case from the pair count alone (every
// expert's run padded by up to BM - 1 rows), never from the data, and a
// block whose expert id is -1 returns at once, so a decode step replays from
// a CUDA graph with no host sync. Blocks walk the column tiles of one row
// block first (blockIdx.x), so a row block's gathered tokens and an expert's
// weight tiles stay in L2 while its row blocks pass. Two tile shapes: BM =
// 16 with 4 warps side by side and a deep ring while pairs are few (decode:
// the weights stream), BM = 128 with 8 warps in a 4 x 2 grid where the
// tensor cores bound (prefill).
#include "flash.cuh"

namespace emr2a {

constexpr int K11_MAX_EXPERTS = 256;
constexpr int K11_ALIGN_THREADS = 1024;

struct MoeArgs {
  const bf16* x;             // (T, D)
  const bf16* w;             // this GEMM's kernels: (E, D, 2I) or (E, I, D)
  const bf16* h_in;          // (nb * BM, I): the down product's rows
  bf16* h_out;               // (nb * BM, I): the gate/up product's output
  float* rows;               // (P, D)
  const float* weight;       // (P)
  const int* sorted;         // (nb * BM) pair ids in expert order, P marks padding
  const int* block_expert;   // (nb)
  long long w_expert;        // elements between two experts' kernels
  int w_ld;                  // the kernel's row length (2I or D)
  int P, top_k, D, I;
  int kdim;                  // the product's depth: D (gate/up) or I (down)
};

// ids (P) int64 -> sorted, block_expert, the tally's row
__global__ void __launch_bounds__(K11_ALIGN_THREADS)
    k11_align_kernel(const long long* ids, int P, int E, int BM, int nb, int* sorted,
                     int* block_expert, long long* tally) {
  __shared__ int count[K11_MAX_EXPERTS];
  __shared__ int start[K11_MAX_EXPERTS + 1];
  __shared__ int fill[K11_MAX_EXPERTS];
  const int tid = threadIdx.x;
  for (int e = tid; e < E; e += blockDim.x) count[e] = 0;
  __syncthreads();
  for (int i = tid; i < P; i += blockDim.x) {
    const long long e = ids[i];
    if (e >= 0 && e < E) atomicAdd(&count[e], 1);
  }
  __syncthreads();
  if (tid == 0) {
    int at = 0, used = 0, most = 0;
    for (int e = 0; e < E; ++e) {
      start[e] = at;
      fill[e] = at;
      at += (count[e] + BM - 1) / BM * BM;
      used += count[e] > 0;
      most = max(most, count[e]);
    }
    start[E] = at;
    atomicAdd(reinterpret_cast<unsigned long long*>(tally + 0), (unsigned long long)P);
    atomicAdd(reinterpret_cast<unsigned long long*>(tally + 1), 1ull);
    atomicAdd(reinterpret_cast<unsigned long long*>(tally + 2), (unsigned long long)used);
    atomicMax(tally + 3, (long long)most);
  }
  __syncthreads();
  for (int i = tid; i < nb * BM; i += blockDim.x) sorted[i] = P;
  for (int b = tid; b < nb; b += blockDim.x) {
    const int row = b * BM;
    int owner = -1;
    if (row < start[E]) {
      int lo = 0, hi = E - 1;  // the last expert whose run starts at or before row
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (start[mid] <= row) lo = mid;
        else hi = mid - 1;
      }
      owner = lo;
    }
    block_expert[b] = owner;
  }
  __syncthreads();  // the padding marks land before the pairs overwrite them
  for (int i = tid; i < P; i += blockDim.x) {
    const long long e = ids[i];
    if (e >= 0 && e < E) sorted[atomicAdd(&fill[e], 1)] = i;
  }
}

__device__ __forceinline__ void k11_copy16(void* smem, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(fa_smem_u32(smem)),
               "l"(src), "r"(ok ? 16 : 0));
}

template <int BM, int BN, int BK, int NH>
struct K11Tile {
  static constexpr int LDA = BK + 8;   // rows padded by 16 bytes: ldmatrix without conflicts
  static constexpr int LDB = BN + 8;
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int B_ELEMS = BK * LDB;
  static constexpr int STAGE = A_ELEMS + NH * B_ELEMS;  // elements
  static constexpr int STAGE_BYTES = STAGE * (int)sizeof(bf16);
};

// grid (columns / BN, nb); WM x WN warps, each WTM = BM / WM rows by WTN =
// BN / WN columns of each of the NH weight tiles (gate and up, or down)
template <int BM, int BN, int BK, int WM, int WN, int NST, bool GATE_UP>
__global__ void __launch_bounds__(WM* WN * 32)
    k11_gemm_kernel(const MoeArgs a) {
  constexpr int NH = GATE_UP ? 2 : 1;
  constexpr int THREADS = WM * WN * 32;
  constexpr int WTM = BM / WM, WTN = BN / WN;
  constexpr int MT = WTM / 16, NT = WTN / 8;
  using Tile = K11Tile<BM, BN, BK, NH>;
  extern __shared__ __align__(16) unsigned char k11_smem[];
  __shared__ long long src_row[BM];  // A's row offsets (elements); -1: zeros
  __shared__ int pair_of[BM];

  const int e = a.block_expert[blockIdx.y];
  if (e < 0) return;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WN, wn = warp % WN;
  const int gq = lane >> 2, tq = lane & 3;

  for (int r = tid; r < BM; r += THREADS) {
    const int p = a.sorted[m0 + r];
    pair_of[r] = p;
    if constexpr (GATE_UP) src_row[r] = p < a.P ? (long long)(p / a.top_k) * a.D : -1;
    else src_row[r] = (long long)(m0 + r) * a.I;
  }
  __syncthreads();

  const bf16* abase = GATE_UP ? a.x : a.h_in;
  const bf16* wbase = a.w + (long long)e * a.w_expert + n0;
  const int ktiles = a.kdim / BK;

  auto issue = [&](int stage, int kt) {
    bf16* As = reinterpret_cast<bf16*>(k11_smem + stage * Tile::STAGE_BYTES);
    const int k0 = kt * BK;
    constexpr int ACH = BK / 8;  // 16-byte chunks a row of A
    for (int c = tid; c < BM * ACH; c += THREADS) {
      const int r = c / ACH, col = (c % ACH) * 8;
      const long long off = src_row[r];
      k11_copy16(As + r * Tile::LDA + col, abase + (off < 0 ? 0 : off) + k0 + col, off >= 0);
    }
    constexpr int BCH = BN / 8;
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      bf16* Bs = As + Tile::A_ELEMS + hh * Tile::B_ELEMS;
      const bf16* src = wbase + (long long)k0 * a.w_ld + hh * a.I;
      for (int c = tid; c < BK * BCH; c += THREADS) {
        const int r = c / BCH, col = (c % BCH) * 8;
        k11_copy16(Bs + r * Tile::LDB + col, src + (long long)r * a.w_ld + col, true);
      }
    }
  };

  float acc[MT][NH * NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NH * NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < ktiles) issue(s, s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(NST - 2) : "memory");
    __syncthreads();  // tile kt has landed; every warp is done with kt - 1
    {
      const int nx = kt + NST - 1;
      if (nx < ktiles) issue(nx % NST, nx);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    const bf16* As = reinterpret_cast<const bf16*>(k11_smem + (kt % NST) * Tile::STAGE_BYTES);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        fa_ldmatrix_x4(af[mt], As + (wm * WTM + mt * 16 + (lane & 15)) * Tile::LDA + kk * 16 +
                                   (lane >> 4) * 8);
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) {
        const bf16* Bs = As + Tile::A_ELEMS + hh * Tile::B_ELEMS;
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bfr[4];
          fa_ldmatrix_x4_trans(bfr, Bs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * Tile::LDB +
                                        wn * WTN + np * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16_16816(acc[mt][hh * NT + 2 * np], af[mt], bfr[0], bfr[1]);
            mma_bf16_16816(acc[mt][hh * NT + 2 * np + 1], af[mt], bfr[2], bfr[3]);
          }
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // rows gq and gq + 8 of the m16 tile
      const int r = wm * WTM + mt * 16 + gq + half * 8;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = n0 + wn * WTN + nt * 8 + tq * 2;
        const float c0 = acc[mt][nt][half * 2], c1 = acc[mt][nt][half * 2 + 1];
        if constexpr (GATE_UP) {
          const float u0 = acc[mt][NT + nt][half * 2], u1 = acc[mt][NT + nt][half * 2 + 1];
          const float h0 = c0 / (1.f + __expf(-c0)) * u0, h1 = c1 / (1.f + __expf(-c1)) * u1;
          *reinterpret_cast<__nv_bfloat162*>(a.h_out + (long long)(m0 + r) * a.I + col) =
              __floats2bfloat162_rn(h0, h1);
        } else {
          const int p = pair_of[r];
          if (p < a.P) {
            const float wt = a.weight[p];
            *reinterpret_cast<float2*>(a.rows + (long long)p * a.D + col) =
                make_float2(c0 * wt, c1 * wt);
          }
        }
      }
    }
  }
}

template <int BM, int BN, int BK, int WM, int WN, int NST, bool GATE_UP>
cudaError_t k11_launch(const MoeArgs& a, int columns, int nb, cudaStream_t st) {
  constexpr int smem = NST * K11Tile<BM, BN, BK, GATE_UP ? 2 : 1>::STAGE_BYTES;
  auto* kernel = k11_gemm_kernel<BM, BN, BK, WM, WN, NST, GATE_UP>;
  static std::atomic<uint64_t> sized{0};
  cudaError_t e = smem_attr_once(kernel, smem, sized);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(columns / BN, nb), WM * WN * 32, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace emr2a

using namespace emr2a;

// K11. Rules the wrapper (ops/moe.py) checks: x (T, D), w_gate_up (E, D,
// 2I), w_down (E, I, D) bf16 contiguous; ids (T, top_k) int64 and weight
// (T, top_k) f32 contiguous; E <= 256; D a multiple of 128 and I of 64; bm
// 16 or 128 (block_rows) and nb = max_blocks(T * top_k, E, bm); scratch
// sorted (nb * bm) and block_expert (nb) int32, h (nb * bm, I) bf16; rows (T
// * top_k, D) f32; tally the phase's 4 int64 counters.
extern "C" int emr2a_moe_experts(const void* x, const void* w_gate_up, const void* w_down,
                                 const void* ids, const void* weight, void* sorted,
                                 void* block_expert, void* h, void* rows, void* tally, int T,
                                 int D, int I, int E, int top_k, int bm, int nb, void* stream) {
  const int P = T * top_k;
  if (T < 1 || top_k < 1 || E < 1 || E > K11_MAX_EXPERTS || D % 128 || I % 64 ||
      (bm != 16 && bm != 128) || nb * bm < P + E * (bm - 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  k11_align_kernel<<<1, K11_ALIGN_THREADS, 0, st>>>(
      static_cast<const long long*>(ids), P, E, bm, nb, static_cast<int*>(sorted),
      static_cast<int*>(block_expert), static_cast<long long*>(tally));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  MoeArgs a;
  a.x = static_cast<const bf16*>(x);
  a.h_in = static_cast<const bf16*>(h);
  a.h_out = static_cast<bf16*>(h);
  a.rows = static_cast<float*>(rows);
  a.weight = static_cast<const float*>(weight);
  a.sorted = static_cast<const int*>(sorted);
  a.block_expert = static_cast<const int*>(block_expert);
  a.P = P, a.top_k = top_k, a.D = D, a.I = I;
  MoeArgs gu = a, dn = a;
  gu.w = static_cast<const bf16*>(w_gate_up);
  gu.w_expert = (long long)D * 2 * I;
  gu.w_ld = 2 * I;
  gu.kdim = D;
  dn.w = static_cast<const bf16*>(w_down);
  dn.w_expert = (long long)I * D;
  dn.w_ld = D;
  dn.kdim = I;
  if (bm == 16) {
    e = k11_launch<16, 64, 64, 1, 4, 4, true>(gu, I, nb, st);
    if (e == cudaSuccess) e = k11_launch<16, 64, 64, 1, 4, 4, false>(dn, D, nb, st);
  } else {
    e = k11_launch<128, 64, 32, 4, 2, 4, true>(gu, I, nb, st);
    if (e == cudaSuccess) e = k11_launch<128, 128, 32, 4, 2, 4, false>(dn, D, nb, st);
  }
  return static_cast<int>(e);
}
