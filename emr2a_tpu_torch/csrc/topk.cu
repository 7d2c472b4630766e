// Fused cosine scan + top-k (K6) for Hopper (sm_90a): f32, bf16 and s8
// storage.
//
// Replaces emr2a_tpu/ops/topk.py:cosine_topk_pallas (the Pallas kernel
// _fused_topk_kernel) and the int8 scan that emr2a_tpu/retrieval/database.py
// (:49-60, :71-73) leaves to XLA:
//   scores = q . db^T accumulated in f32; for s8, exact s32 sums of the query
//            codes (max|q|/127 per row, a zero row scaled by 1, rint, clip)
//            and the row codes, then (f32(acc) * q_scale) * db_scale,
//            two rounded multiplies;
//   rows >= n_valid are not candidates; top-k descending, ties to the lowest
//   index; any 1 <= k <= n_valid.
// The queries come in the storage type (f32, bf16), or in f32 for s8.
//
// Bound on the H100: the bytes of the DB (n * dim * elem, + 4n for the s8
// scales) at 3.35 TB/s while q is small (1M x 512: 0.611 ms f32, 0.306 bf16,
// 0.154 s8); at q = 64 in f32 the 2*q*n*dim FMAs at 67 TFLOP/s (about 1.0 ms).
//
// Two scans, chosen by the wrapper (ops/topk.py) from q and k, then one merge:
//
// The streaming scan (topk_scan_kernel, emr2a_cosine_topk), for few queries
//   and k <= 64: a block of 8 warps takes one chunk of rows and up to 8 groups
//   of QT queries; each warp holds its group's queries in registers, and the
//   warps of a group split the chunk's rows. A lane reads 8 elements of a row
//   per step (f32 2 x 16 B, bf16 16 B, s8 8 B: coalesced across the warp);
//   the QT partial sums of a row are reduced across the warp by a transposing
//   butterfly, after which lane j < QT holds the score of one query. That lane
//   keeps the warp's sorted top-k for its query in shared memory and drops a
//   score at once when it does not beat the k-th best (the TPU kernel's tile
//   skip, per row). The block then merges its warps' lists into (chunk, q, k)
//   scratch. At q = 1 it runs at 72-84 % of the byte bound.
// The tile scan (topk_tc_kernel, emr2a_cosine_topk_tc), for many queries or
//   any k: a block holds a tile of up to 64 queries in shared memory (s8
//   codes quantized in the prologue) and walks a contiguous chunk of rows in
//   tiles of 128. Each tile goes through a cp.async ring of 3 to 6 stages in
//   pieces of 256 bytes of every row (128 for f32), XOR-swizzled by row so
//   that ldmatrix reads are free of bank conflicts, and is read once for all
//   queries of the block; each step's fragments are loaded ahead of its MMAs. Scores come
//   from tensor cores for bf16 (mma.sync m16n8k16, f32 accumulate: bf16
//   products are exact in f32) and s8 (m16n8k32, exact s32 sums, so the
//   result is bit-identical to the plain version); f32 keeps FP32 (TF32 would
//   not keep the reference's scores) with a register-tiled FFMA outer product
//   of 4 rows x q/8 queries a thread. Then the TPU kernel's tile prune: a
//   tile whose scores all fail their query's running k-th best is dropped
//   (__syncthreads_or); otherwise the scores go to shared memory and warp w
//   takes the flagged queries among w, w + 8, ...: a ballot finds the rows
//   above the threshold and the warp inserts them in row order (strict >,
//   so a tie keeps the lower index) into the query's sorted list: for
//   k <= 32 held one entry a lane in registers (a shuffle per insertion),
//   else warp-parallel in memory, for any k. The lists live in shared memory
//   when they fit, else in the block's own slice of the (chunk, q, k)
//   scratch (L2-resident, written rarely once the threshold has settled).
// The merge (topk_merge_kernel): one block per query merges the chunks'
//   sorted lists: k rounds of an argmax over the list heads, by (score
//   descending, index ascending).
#include <climits>
#include <cmath>
#include <type_traits>

#include "common.cuh"

using namespace emr2a;

namespace {

constexpr int TOPK_WARPS = 8;
constexpr int TOPK_THREADS = TOPK_WARPS * 32;
constexpr int TOPK_KMAX = 64;
constexpr int TOPK_DIM_MAX = 1024;
constexpr int TOPK_CHUNKS_MAX = 8192;
constexpr unsigned FULL = 0xffffffffu;
constexpr int TC_THREADS = 256;

struct TopkParams {
  const void* q;          // (nq, dim): storage type, f32 for s8
  const void* db;         // (>= n_valid, dim)
  const float* db_scale;  // (>= n_valid,), s8 only
  int nq, n_valid, dim, k;
  int groups;             // query groups per block: 1, 2, 4 or 8
  int rows_per_chunk;
  float* cand_val;        // (chunks, nq, k)
  int* cand_idx;
};

template <typename T>
struct Traits;

template <>
struct Traits<float> {
  static constexpr int R = 1;  // rows per step of a warp
  struct Raw {
    float4 a, b;
  };
  __device__ static Raw load(const float* p) {
    Raw r;
    r.a = __ldg(reinterpret_cast<const float4*>(p));
    r.b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    return r;
  }
  __device__ static Raw zero() { return Raw{make_float4(0, 0, 0, 0), make_float4(0, 0, 0, 0)}; }
  __device__ static void to_float(const Raw& r, float* v) {
    v[0] = r.a.x; v[1] = r.a.y; v[2] = r.a.z; v[3] = r.a.w;
    v[4] = r.b.x; v[5] = r.b.y; v[6] = r.b.z; v[7] = r.b.w;
  }
};

template <>
struct Traits<bf16> {
  static constexpr int R = 2;
  using Raw = uint4;
  __device__ static Raw load(const bf16* p) { return __ldg(reinterpret_cast<const uint4*>(p)); }
  __device__ static Raw zero() { return make_uint4(0, 0, 0, 0); }
  __device__ static void to_float(const Raw& r, float* v) {
    Vec8 u;
    u.u = r;
#pragma unroll
    for (int t = 0; t < 8; ++t) v[t] = __bfloat162float(u.h[t]);
  }
};

template <>
struct Traits<int8_t> {
  static constexpr int R = 4;
  using Raw = uint2;
  __device__ static Raw load(const int8_t* p) { return __ldg(reinterpret_cast<const uint2*>(p)); }
  __device__ static Raw zero() { return make_uint2(0, 0); }
};

template <int QT>
struct Log2;
template <>
struct Log2<2> {
  static constexpr int value = 1;
};
template <>
struct Log2<4> {
  static constexpr int value = 2;
};

// v[j] holds a lane's partial sum for query j. Returns the warp total of
// query slot_of_lane<QT>(lane) (a function of the lane's low log2(QT) bits).
template <int QT, typename V>
__device__ __forceinline__ V transpose_reduce(V (&v)[QT], int lane) {
  constexpr int M = Log2<QT>::value;
#pragma unroll
  for (int s = 0; s < M; ++s) {
    const int hh = QT >> (s + 1);
    const bool up = (lane >> s) & 1;
#pragma unroll
    for (int i = 0; i < hh; ++i) {
      const V send = up ? v[i] : v[i + hh];
      const V keep = up ? v[i + hh] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, 1 << s);
    }
  }
  V r = v[0];
#pragma unroll
  for (int o = 1 << M; o < 32; o <<= 1) r += __shfl_xor_sync(FULL, r, o);
  return r;
}

template <int QT>
__device__ __forceinline__ int slot_of_lane(int lane) {
  int j = 0;
#pragma unroll
  for (int s = 0; s < Log2<QT>::value; ++s) j += ((lane >> s) & 1) * (QT >> (s + 1));
  return j;
}

// (ov, oi, ol) ranks before (v, i, l): score descending, then index, then
// the tie-break key ascending.
__device__ __forceinline__ bool before(float ov, int oi, int ol, float v, int i, int l) {
  return ov > v || (ov == v && (oi < i || (oi == i && ol < l)));
}

__device__ __forceinline__ void warp_best(float& v, int& i, int& l) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, o);
    const int oi = __shfl_xor_sync(FULL, i, o);
    const int ol = __shfl_xor_sync(FULL, l, o);
    if (before(ov, oi, ol, v, i, l)) {
      v = ov;
      i = oi;
      l = ol;
    }
  }
}

// Insert (s, idx) into the sorted list (lv, li) of length k; s beats lv[k-1].
__device__ __forceinline__ void list_insert(float* lv, int* li, int k, float s, int idx) {
  int p = k - 1;
  while (p > 0 && lv[p - 1] < s) {
    lv[p] = lv[p - 1];
    li[p] = li[p - 1];
    --p;
  }
  lv[p] = s;
  li[p] = idx;
}

template <typename T, int SMAX, int QT>
__global__ void __launch_bounds__(TOPK_THREADS, 2) topk_scan_kernel(TopkParams p) {
  constexpr bool S8 = std::is_same<T, int8_t>::value;
  using TR = Traits<T>;
  using QTR = Traits<typename std::conditional<S8, float, T>::type>;
  constexpr int R = TR::R;
  using Acc = typename std::conditional<S8, int, float>::type;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = p.k;
  float* list_val = reinterpret_cast<float*>(smem_raw);
  int* list_idx = reinterpret_cast<int*>(list_val + TOPK_WARPS * QT * k);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int G = p.groups;
  const int g = warp % G;
  const int sub = warp / G;
  const int nsub = TOPK_WARPS / G;
  const int qbase = blockIdx.x * G * QT + g * QT;
  const int dim = p.dim;

  // this warp's QT queries, in registers: lane holds elements
  // [(s * 32 + lane) * 8, +8) of each
  float qf[QT][SMAX][8];
  int qc[QT][SMAX][2];
  float qs[QT];
  using QElem = typename std::conditional<S8, float, T>::type;
  const QElem* qptr = static_cast<const QElem*>(p.q);
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    const int qi = qbase + j;
    float amax = 0.f;
    qs[j] = 1.f;
#pragma unroll
    for (int s = 0; s < SMAX; ++s) {
      const int e0 = (s * 32 + lane) * 8;
      typename QTR::Raw r = QTR::zero();
      if (qi < p.nq && e0 < dim) r = QTR::load(qptr + (size_t)qi * dim + e0);
      QTR::to_float(r, qf[j][s]);
#pragma unroll
      for (int t = 0; t < 8; ++t) amax = fmaxf(amax, fabsf(qf[j][s][t]));
    }
    if constexpr (S8) {
      // emr2a_tpu/retrieval/database.py:52-55: max|q| / 127 (a division),
      // a zero row scaled by 1, codes rint(q / scale) clipped to +-127
      float scale = __fdiv_rn(warp_max(amax), 127.f);
      if (scale == 0.f) scale = 1.f;
      qs[j] = scale;
#pragma unroll
      for (int s = 0; s < SMAX; ++s) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int packed = 0;
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const float c = fminf(fmaxf(rintf(__fdiv_rn(qf[j][s][h * 4 + t], scale)), -127.f), 127.f);
            packed |= (static_cast<int>(c) & 0xff) << (8 * t);
          }
          qc[j][s][h] = packed;
        }
      }
    }
  }

  // the lane that owns a query slot keeps this warp's sorted list for it
  const int slot = slot_of_lane<QT>(lane);
  const bool owner = lane < QT && qbase + slot < p.nq;
  float* my_val = list_val + (warp * QT + slot) * k;
  int* my_idx = list_idx + (warp * QT + slot) * k;
  float my_qs = qs[0];
#pragma unroll
  for (int j = 1; j < QT; ++j)
    if (slot == j) my_qs = qs[j];
  float thr = -INFINITY;
  if (owner)
    for (int t = 0; t < k; ++t) {
      my_val[t] = -INFINITY;
      my_idx[t] = INT_MAX;
    }

  const int row_begin = blockIdx.y * p.rows_per_chunk;
  const int row_end = min(row_begin + p.rows_per_chunk, p.n_valid);
  const T* db = static_cast<const T*>(p.db);
  for (int r0 = row_begin + sub * R; r0 < row_end; r0 += nsub * R) {
    typename TR::Raw raw[R][SMAX];
#pragma unroll
    for (int rr = 0; rr < R; ++rr)
#pragma unroll
      for (int s = 0; s < SMAX; ++s) {
        const int e0 = (s * 32 + lane) * 8;
        const int row = r0 + rr;
        raw[rr][s] = (row < row_end && e0 < dim) ? TR::load(db + (size_t)row * dim + e0)
                                                 : TR::zero();
      }
    Acc score[R];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      Acc acc[QT];
#pragma unroll
      for (int j = 0; j < QT; ++j) acc[j] = 0;
#pragma unroll
      for (int s = 0; s < SMAX; ++s) {
        if constexpr (S8) {
#pragma unroll
          for (int j = 0; j < QT; ++j) {
            acc[j] = __dp4a(static_cast<int>(raw[rr][s].x), qc[j][s][0], acc[j]);
            acc[j] = __dp4a(static_cast<int>(raw[rr][s].y), qc[j][s][1], acc[j]);
          }
        } else {
          float x[8];
          TR::to_float(raw[rr][s], x);
#pragma unroll
          for (int j = 0; j < QT; ++j)
#pragma unroll
            for (int t = 0; t < 8; ++t) acc[j] = fmaf(qf[j][s][t], x[t], acc[j]);
        }
      }
      score[rr] = transpose_reduce<QT>(acc, lane);
    }
    if (owner) {
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const int row = r0 + rr;
        if (row >= row_end) break;
        float s;
        if constexpr (S8)
          s = __fmul_rn(__fmul_rn(static_cast<float>(score[rr]), my_qs), __ldg(p.db_scale + row));
        else
          s = score[rr];
        if (s > thr) {
          list_insert(my_val, my_idx, k, s, row);
          thr = my_val[k - 1];
        }
      }
    }
  }
  __syncthreads();

  // merge the block's lists: query slot ql of group gq was scanned by the
  // warps gq + G * w, w < nsub; lane w takes that warp's list
  const int nql = G * QT;
  for (int ql = warp; ql < nql; ql += TOPK_WARPS) {
    const int gq = ql / QT;
    const int j = ql % QT;
    const int qi = blockIdx.x * nql + ql;
    if (qi >= p.nq) continue;
    const bool has = lane < nsub;
    const int list = ((gq + G * lane) * QT + j) * k;
    int h = 0;
    for (int t = 0; t < k; ++t) {
      float v = -INFINITY;
      int id = INT_MAX;
      if (has && h < k) {
        v = list_val[list + h];
        id = list_idx[list + h];
      }
      int wl = lane;
      warp_best(v, id, wl);
      if (lane == wl) ++h;
      if (lane == 0) {
        const size_t o = ((size_t)blockIdx.y * p.nq + qi) * k + t;
        p.cand_val[o] = v;
        p.cand_idx[o] = id;
      }
    }
  }
}

__global__ void __launch_bounds__(TOPK_THREADS) topk_merge_kernel(
    const float* cand_val, const int* cand_idx, int chunks, int nq, int k, float* out_val,
    int* out_idx) {
  extern __shared__ int heads[];
  __shared__ float wv[TOPK_WARPS];
  __shared__ int wi[TOPK_WARPS], wc[TOPK_WARPS];
  const int qi = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int c = threadIdx.x; c < chunks; c += TOPK_THREADS) heads[c] = 0;
  __syncthreads();
  for (int t = 0; t < k; ++t) {
    float v = -INFINITY;
    int id = INT_MAX, cb = INT_MAX;
    for (int c = threadIdx.x; c < chunks; c += TOPK_THREADS) {
      const int h = heads[c];
      if (h < k) {
        const size_t o = ((size_t)c * nq + qi) * k + h;
        const float cv = cand_val[o];
        const int ci = cand_idx[o];
        if (before(cv, ci, c, v, id, cb)) {
          v = cv;
          id = ci;
          cb = c;
        }
      }
    }
    warp_best(v, id, cb);
    if (lane == 0) {
      wv[warp] = v;
      wi[warp] = id;
      wc[warp] = cb;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < TOPK_WARPS ? wv[lane] : -INFINITY;
      id = lane < TOPK_WARPS ? wi[lane] : INT_MAX;
      cb = lane < TOPK_WARPS ? wc[lane] : INT_MAX;
      warp_best(v, id, cb);
      if (lane == 0) {
        out_val[(size_t)qi * k + t] = v;
        out_idx[(size_t)qi * k + t] = id;
        if (cb < chunks) heads[cb] += 1;
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The tile scan
// ---------------------------------------------------------------------------

constexpr int TC_ROWS = 128;                 // DB rows per tile

// bytes of each row per ring stage: 256 for bf16 and s8, whose query tile
// leaves room for a ring of 32 KB stages; 128 for f32
template <typename T>
__host__ __device__ constexpr int tc_piece() {
  return std::is_same<T, float>::value ? 128 : 256;
}
constexpr int TC_NST_MIN = 3, TC_NST_MAX = 6;  // ring stages
constexpr int TC_SROW = TC_ROWS + 4;         // score tile stride (floats)
constexpr int TC_QMAX = 64;                  // queries per block
constexpr int TC_QBYTES_MAX = 128 * 1024;    // the query tile's shared memory
constexpr int SMEM_BLOCK_MAX = 232448;       // 227 KB, a block's most
constexpr int SMEM_SM = 233472;              // 228 KB of the SM (1 KB a block reserved)

struct TcPlan {
  int qb;              // queries per block tile: 8, 16, 32 or 64
  int kch;             // pieces per row (the row zero-padded)
  int nst;             // ring stages, 3 to 6
  int list_in_smem;    // the running lists in shared memory, else in cand
  int chunks, rows_per_chunk;
  size_t smem;
};

// Shared memory of the tile scan, in this order: the ring, the query tile,
// the score tile, the thresholds, the query scales, the flags, the lists.
size_t tc_fixed_smem(int qb, size_t qrow) {
  return qb * qrow + (size_t)qb * TC_SROW * 4 + (size_t)qb * 12;
}

TcPlan tc_plan(int dtype, int nq, int n_valid, int dim, int k, int sm_count) {
  TcPlan pl = {};
  const int elem = dtype == 0 ? 4 : dtype == 1 ? 2 : 1;
  const int piece = dtype == 0 ? tc_piece<float>() : tc_piece<bf16>();
  pl.kch = (dim * elem + piece - 1) / piece;
  const size_t qrow = (size_t)pl.kch * piece;
  const size_t stage = (size_t)TC_ROWS * piece;
  pl.qb = 8;
  // the query tile doubles while it fits its budget and leaves room for the
  // shortest ring
  while (pl.qb < nq && pl.qb < TC_QMAX && 2 * pl.qb * qrow <= (size_t)TC_QBYTES_MAX &&
         tc_fixed_smem(2 * pl.qb, qrow) + TC_NST_MIN * stage <= (size_t)SMEM_BLOCK_MAX)
    pl.qb *= 2;
  const size_t fixed = tc_fixed_smem(pl.qb, qrow);
  const size_t lists = (size_t)pl.qb * k * 8;
  pl.list_in_smem = fixed + lists + TC_NST_MIN * stage <= (size_t)SMEM_BLOCK_MAX;
  const size_t base = fixed + (pl.list_in_smem ? lists : 0);
  // two blocks an SM where three stages allow it, else one; then the
  // deepest ring that fits
  const size_t half = SMEM_SM / 2 - 1024;
  const int per_sm = base + TC_NST_MIN * stage <= half ? 2 : 1;
  const size_t room = (per_sm == 2 ? half : (size_t)SMEM_BLOCK_MAX) - base;
  pl.nst = (int)(room / stage) < TC_NST_MAX ? (int)(room / stage) : TC_NST_MAX;
  pl.smem = base + (size_t)pl.nst * stage;
  const int qtiles = (nq + pl.qb - 1) / pl.qb;
  const int tiles = (n_valid + TC_ROWS - 1) / TC_ROWS;
  int chunks = (sm_count * per_sm + qtiles - 1) / qtiles;
  chunks = chunks < 1 ? 1 : chunks > tiles ? tiles : chunks;
  pl.rows_per_chunk = (tiles + chunks - 1) / chunks * TC_ROWS;
  pl.chunks = (n_valid + pl.rows_per_chunk - 1) / pl.rows_per_chunk;
  return pl;
}

struct TcParams {
  const void* q;          // (nq, dim): storage type, f32 for s8
  const void* db;         // (>= n_valid, dim)
  const float* db_scale;  // (>= n_valid,), s8 only
  int nq, n_valid, dim, k;
  int kch, nst, rows_per_chunk, list_in_smem;
  float* cand_val;        // (chunks, nq, k)
  int* cand_idx;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes, int valid) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(valid));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(valid));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait until at most n groups are pending, 1 <= n <= TC_NST_MAX - 2
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    default: cp_async_wait<4>(); break;
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Byte offset of 16-byte chunk c of row r in a row of whole 128-byte pieces:
// inside each piece, chunk (c & 7) is stored at (c & 7) ^ (r & 7).
__device__ __forceinline__ int swz(int r, int c) { return ((c & ~7) | ((c ^ r) & 7)) << 4; }

// Insert (s, idx) into the sorted list (lv, li) of length k, warp-parallel;
// s beats lv[k - 1] and idx is above every index in the list, so it goes
// before the first entry below s. Works on shared or global memory.
__device__ __forceinline__ void warp_insert(float* lv, int* li, int k, float s, int idx,
                                            int lane) {
  int p = k - 1;
  for (int base = 0; base < k; base += 32) {
    const int e = base + lane;
    const unsigned b = __ballot_sync(FULL, e < k && lv[e] < s);
    if (b) {
      p = base + __ffs(b) - 1;
      break;
    }
  }
  for (int top = k - 1; top > p; top -= 32) {
    const int dst = top - lane;
    const bool mv = dst > p;
    float v = 0.f;
    int id = 0;
    if (mv) {
      v = lv[dst - 1];
      id = li[dst - 1];
    }
    __syncwarp();
    if (mv) {
      lv[dst] = v;
      li[dst] = id;
    }
    __syncwarp();
  }
  if (lane == 0) {
    lv[p] = s;
    li[p] = idx;
  }
  __syncwarp();
}

// Insert the rows of one score row (128 scores, scores[m * 32 + lane])
// that beat thr, in row order, into the sorted list (lv, li) of length k;
// returns the new threshold. For k <= 32 the list is held one entry a lane
// in registers for the tile (a shuffle per insertion), else warp_insert
// works on it in place.
__device__ __forceinline__ float scan_insert(const float* srow, float thr, float* lv, int* li,
                                             int k, int row0, int lane) {
  if (k <= 32) {
    float rv = lane < k ? lv[lane] : -INFINITY;
    int ri = lane < k ? li[lane] : INT_MAX;
#pragma unroll
    for (int m = 0; m < TC_ROWS / 32; ++m) {
      const float v = srow[m * 32 + lane];
      unsigned mask = __ballot_sync(FULL, v > thr);
      while (mask) {
        const int l = __ffs(mask) - 1;
        mask &= mask - 1;
        const float sv = __shfl_sync(FULL, v, l);
        if (sv > thr) {
          const int p = __ffs(__ballot_sync(FULL, lane < k && rv < sv)) - 1;
          const float up = __shfl_up_sync(FULL, rv, 1);
          const int upi = __shfl_up_sync(FULL, ri, 1);
          if (lane > p) {
            rv = up;
            ri = upi;
          }
          if (lane == p) {
            rv = sv;
            ri = row0 + m * 32 + l;
          }
          thr = __shfl_sync(FULL, rv, k - 1);
        }
      }
    }
    if (lane < k) {
      lv[lane] = rv;
      li[lane] = ri;
    }
    __syncwarp();
    return thr;
  }
#pragma unroll
  for (int m = 0; m < TC_ROWS / 32; ++m) {
    const float v = srow[m * 32 + lane];
    unsigned mask = __ballot_sync(FULL, v > thr);
    while (mask) {
      const int l = __ffs(mask) - 1;
      mask &= mask - 1;
      const float sv = __shfl_sync(FULL, v, l);
      if (sv > thr) {
        warp_insert(lv, li, k, sv, row0 + m * 32 + l, lane);
        thr = lv[k - 1];
      }
    }
  }
  return thr;
}

// Copy one ring stage: piece kc of rows [row0, row0 + 128), zero past
// row_end and past the row's bytes. 16-byte copies where every row starts
// 16-byte aligned, else 8-byte (s8 with dim % 16 == 8).
template <int PIECE>
__device__ __forceinline__ void tc_issue(unsigned char* stage, const unsigned char* db, int row0,
                                         int row_end, int kc, int row_bytes, int tid) {
  constexpr int CH = PIECE / 16;
  if (row_bytes % 16 == 0) {
#pragma unroll
    for (int i = 0; i < TC_ROWS * CH / TC_THREADS; ++i) {
      const int p = tid + i * TC_THREADS;
      const int r = p / CH, w = p % CH;
      const int off = kc * PIECE + w * 16;
      const bool ok = row0 + r < row_end && off < row_bytes;
      const unsigned char* src = ok ? db + (size_t)(row0 + r) * row_bytes + off : db;
      cp_async(stage + r * PIECE + swz(r, w), src, 16, ok ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int i = 0; i < TC_ROWS * CH * 2 / TC_THREADS; ++i) {
      const int p = tid + i * TC_THREADS;
      const int r = p / (2 * CH), w = p % (2 * CH);
      const int off = kc * PIECE + w * 8;
      const bool ok = row0 + r < row_end && off < row_bytes;
      const unsigned char* src = ok ? db + (size_t)(row0 + r) * row_bytes + off : db;
      cp_async(stage + r * PIECE + swz(r, w >> 1) + (w & 1) * 8, src, 8, ok ? 8 : 0);
    }
  }
}

// grid (query tiles, chunks), TC_THREADS threads; NQ8 = qb / 8. A block of
// 64 queries has an SM's shared memory to itself, so it may take more
// registers than two blocks could.
template <typename T, int NQ8>
__global__ void __launch_bounds__(TC_THREADS, NQ8 == 8 ? 1 : 2) topk_tc_kernel(TcParams p) {
  constexpr bool S8 = std::is_same<T, int8_t>::value;
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int QB = NQ8 * 8;
  constexpr int PIECE = tc_piece<T>();
  constexpr int CH = PIECE / 16;        // 16-byte chunks of a piece
  constexpr int STAGE = TC_ROWS * PIECE;
  extern __shared__ __align__(128) unsigned char smem[];
  const int kch = p.kch, k = p.k, nst = p.nst;
  const int qrow = kch * PIECE;
  unsigned char* ring = smem;
  unsigned char* qtile = ring + nst * STAGE;
  float* scores = reinterpret_cast<float*>(qtile + QB * qrow);
  float* thr_s = scores + QB * TC_SROW;
  float* qscale = thr_s + QB;
  int* qflag = reinterpret_cast<int*>(qscale + QB);
  float* slist_val = reinterpret_cast<float*>(qflag + QB);
  int* slist_idx = reinterpret_cast<int*>(slist_val + QB * k);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * QB;
  const int chunk = blockIdx.y;
  const int row_bytes = p.dim * (int)sizeof(T);

  // -- the query tile, swizzled like the ring; s8 codes quantized here
  if constexpr (S8) {
    const float* qf = static_cast<const float*>(p.q);
    for (int r = warp; r < QB; r += TC_THREADS / 32) {
      const int qi = q0 + r;
      float amax = 0.f;
      if (qi < p.nq)
        for (int e = lane * 4; e < p.dim; e += 128) {
          const float4 v = *reinterpret_cast<const float4*>(qf + (size_t)qi * p.dim + e);
          amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
        }
      // emr2a_tpu/retrieval/database.py:52-55: max|q| / 127 (a division),
      // a zero row scaled by 1, codes rint(q / scale) clipped to +-127
      float scale = __fdiv_rn(warp_max(amax), 127.f);
      if (scale == 0.f) scale = 1.f;
      if (lane == 0) qscale[r] = scale;
      for (int e = lane * 4; e < qrow; e += 128) {
        int packed = 0;
        if (qi < p.nq && e < p.dim) {
          const float4 v = *reinterpret_cast<const float4*>(qf + (size_t)qi * p.dim + e);
          const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const float c = fminf(fmaxf(rintf(__fdiv_rn(x[t], scale)), -127.f), 127.f);
            packed |= (static_cast<int>(c) & 0xff) << (8 * t);
          }
        }
        *reinterpret_cast<int*>(qtile + r * qrow + swz(r, e >> 4) + (e & 15)) = packed;
      }
    }
  } else {
    const unsigned char* qb = static_cast<const unsigned char*>(p.q);
    for (int i = tid; i < QB * (qrow / 16); i += TC_THREADS) {
      const int r = i / (qrow / 16), c = i % (qrow / 16);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < p.nq && c * 16 < row_bytes)
        v = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * row_bytes + c * 16);
      *reinterpret_cast<uint4*>(qtile + r * qrow + swz(r, c)) = v;
    }
  }
  for (int r = tid; r < QB; r += TC_THREADS) {
    thr_s[r] = -INFINITY;
    qflag[r] = 0;
  }
  for (int r = warp; r < QB; r += TC_THREADS / 32) {
    if (q0 + r >= p.nq) continue;
    float* lv = p.list_in_smem ? slist_val + r * k : p.cand_val + ((size_t)chunk * p.nq + q0 + r) * k;
    int* li = p.list_in_smem ? slist_idx + r * k : p.cand_idx + ((size_t)chunk * p.nq + q0 + r) * k;
    for (int e = lane; e < k; e += 32) {
      lv[e] = -INFINITY;
      li[e] = INT_MAX;
    }
  }

  const int row_begin = chunk * p.rows_per_chunk;
  const int row_end = min(row_begin + p.rows_per_chunk, p.n_valid);
  const int ntiles = (row_end - row_begin + TC_ROWS - 1) / TC_ROWS;
  const int total = ntiles * kch;
  const unsigned char* db = static_cast<const unsigned char*>(p.db);
  for (int s = 0; s < nst - 1; ++s) {
    if (s < total)
      tc_issue<PIECE>(ring + s * STAGE, db, row_begin + (s / kch) * TC_ROWS, row_end, s % kch,
                      row_bytes, tid);
    cp_async_commit();
  }

  using Acc = typename std::conditional<S8, int, float>::type;
  // mma: acc[nt][e] of rows warp*16 + gq (+8), queries nt*8 + 2tq (+1);
  // f32: acc[i][j] of rows lane + 32 i, queries warp + 8 j
  constexpr int A0 = F32 ? 4 : NQ8;
  constexpr int A1 = F32 ? NQ8 : 4;
  Acc acc[A0][A1];
  const int gq = lane >> 2, tq = lane & 3;

  for (int it = 0; it < total; ++it) {
    cp_async_wait_n(nst - 2);
    __syncthreads();
    {
      const int nx = it + nst - 1;
      if (nx < total)
        tc_issue<PIECE>(ring + (nx % nst) * STAGE, db, row_begin + (nx / kch) * TC_ROWS, row_end,
                        nx % kch, row_bytes, tid);
      cp_async_commit();
    }
    const int kc = it % kch;
    const int row0 = row_begin + (it / kch) * TC_ROWS;
    const unsigned char* st = ring + (it % nst) * STAGE;
    if (kc == 0) {
#pragma unroll
      for (int a = 0; a < A0; ++a)
#pragma unroll
        for (int b = 0; b < A1; ++b) acc[a][b] = 0;
    }

    if constexpr (F32) {
      // rows lane + 32 i (row & 7 == lane & 7), queries warp + 8 j
      // (query & 7 == warp): each swizzle is one XOR a step
      const unsigned char* dbase = st + lane * PIECE;
      const unsigned char* qbase = qtile + warp * qrow + kc * PIECE;
#pragma unroll
      for (int w = 0; w < CH; ++w) {
        float4 d[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          d[i] = *reinterpret_cast<const float4*>(dbase + i * 32 * PIECE + ((w ^ (lane & 7)) << 4));
#pragma unroll
        for (int j = 0; j < NQ8; ++j) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qbase + j * 8 * qrow + ((w ^ warp) << 4));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float a = acc[i][j];
            a = fmaf(d[i].x, qv.x, a);
            a = fmaf(d[i].y, qv.y, a);
            a = fmaf(d[i].z, qv.z, a);
            a = fmaf(d[i].w, qv.w, a);
            acc[i][j] = a;
          }
        }
      }
    } else {
      // the fragments of step ks + 1 are loaded before the MMAs of step ks
      // (ldmatrix and mma issue in program order)
      constexpr int NB = NQ8 >= 2 ? NQ8 / 2 : 1;
      uint32_t a[2][4], b[2][NB][4];
      auto load = [&](int ks, uint32_t(&fa)[4], uint32_t(&fb)[NB][4]) {
        const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(fa, st + r * PIECE + swz(r, ks * 2 + (lane >> 4)));
        const int cc = kc * CH + ks * 2 + ((lane >> 3) & 1);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          if constexpr (NQ8 >= 2) {
            const int qr = (2 * nb + (lane >> 4)) * 8 + (lane & 7);
            ldmatrix_x4(fb[nb], qtile + qr * qrow + swz(qr, cc));
          } else {
            const int qr = lane & 7;
            ldmatrix_x2(fb[nb], qtile + qr * qrow + swz(qr, cc));
          }
        }
      };
      load(0, a[0], b[0]);
#pragma unroll
      for (int ks = 0; ks < CH / 2; ++ks) {
        if (ks + 1 < CH / 2) load(ks + 1, a[(ks + 1) & 1], b[(ks + 1) & 1]);
        const uint32_t* fa = a[ks & 1];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          const uint32_t* fb = b[ks & 1][nb];
          if constexpr (S8) {
            mma_s8(acc[2 * nb], fa, fb);
            if constexpr (NQ8 >= 2) mma_s8(acc[2 * nb + 1], fa, fb + 2);
          } else {
            mma_bf16(acc[2 * nb], fa, fb);
            if constexpr (NQ8 >= 2) mma_bf16(acc[2 * nb + 1], fa, fb + 2);
          }
        }
      }
    }
    if (kc != kch - 1) continue;

    // -- the tile's scores: drop the tile unless some score beats its
    // query's running k-th best
    float sc[A0][A1];
    int pass = 0;
    if constexpr (F32) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NQ8; ++j) {
          const int qr = warp + 8 * j;
          const float v = row0 + lane + 32 * i < row_end ? acc[i][j] : -INFINITY;
          sc[i][j] = v;
          if (q0 + qr < p.nq && v > thr_s[qr]) {
            qflag[qr] = 1;
            pass = 1;
          }
        }
    } else {
      float ds0 = 1.f, ds1 = 1.f;
      const int ra = row0 + warp * 16 + gq, rb = ra + 8;
      if constexpr (S8) {
        if (ra < row_end) ds0 = __ldg(p.db_scale + ra);
        if (rb < row_end) ds1 = __ldg(p.db_scale + rb);
      }
#pragma unroll
      for (int nt = 0; nt < NQ8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qr = nt * 8 + tq * 2 + (e & 1);
          const bool ok = (e < 2 ? ra : rb) < row_end;
          float v;
          if constexpr (S8)
            v = __fmul_rn(__fmul_rn(static_cast<float>(acc[nt][e]), qscale[qr]),
                          e < 2 ? ds0 : ds1);
          else
            v = acc[nt][e];
          v = ok ? v : -INFINITY;
          sc[nt][e] = v;
          if (q0 + qr < p.nq && v > thr_s[qr]) {
            qflag[qr] = 1;
            pass = 1;
          }
        }
    }
    if (!__syncthreads_or(pass)) continue;
    if constexpr (F32) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NQ8; ++j) scores[(warp + 8 * j) * TC_SROW + lane + 32 * i] = sc[i][j];
    } else {
#pragma unroll
      for (int nt = 0; nt < NQ8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          scores[(nt * 8 + tq * 2 + (e & 1)) * TC_SROW + warp * 16 + gq + (e >> 1) * 8] = sc[nt][e];
    }
    __syncthreads();
    // warp w takes queries w, w + 8, ...: those flagged above
    for (int r = warp; r < QB; r += TC_THREADS / 32) {
      if (!qflag[r]) continue;
      float* lv = p.list_in_smem ? slist_val + r * k : p.cand_val + ((size_t)chunk * p.nq + q0 + r) * k;
      int* li = p.list_in_smem ? slist_idx + r * k : p.cand_idx + ((size_t)chunk * p.nq + q0 + r) * k;
      const float thr = scan_insert(scores + r * TC_SROW, thr_s[r], lv, li, k, row0, lane);
      if (lane == 0) {
        thr_s[r] = thr;
        qflag[r] = 0;
      }
    }
    __syncthreads();
  }

  if (p.list_in_smem) {
    for (int r = warp; r < QB; r += TC_THREADS / 32) {
      if (q0 + r >= p.nq) continue;
      const size_t o = ((size_t)chunk * p.nq + q0 + r) * k;
      for (int e = lane; e < k; e += 32) {
        p.cand_val[o + e] = slist_val[r * k + e];
        p.cand_idx[o + e] = slist_idx[r * k + e];
      }
    }
  }
}

template <typename T, int NQ8>
cudaError_t launch_tc_nq(const TcParams& p, const TcPlan& pl, cudaStream_t st) {
  static std::atomic<uint64_t> sized{0};   // the devices whose attribute is set
  const cudaError_t e = smem_attr_once(topk_tc_kernel<T, NQ8>, SMEM_BLOCK_MAX, sized);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.nq + pl.qb - 1) / pl.qb, pl.chunks);
  topk_tc_kernel<T, NQ8><<<grid, TC_THREADS, pl.smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tc(const TcParams& p, const TcPlan& pl, cudaStream_t st) {
  switch (pl.qb) {
    case 8: return launch_tc_nq<T, 1>(p, pl, st);
    case 16: return launch_tc_nq<T, 2>(p, pl, st);
    case 32: return launch_tc_nq<T, 4>(p, pl, st);
    default: return launch_tc_nq<T, 8>(p, pl, st);
  }
}

template <typename T, int SMAX, int QT>
cudaError_t launch_scan(TopkParams p, int chunks, cudaStream_t stream) {
  const int need = (p.nq + QT - 1) / QT;
  int G = 1;
  while (G < need && G < TOPK_WARPS) G *= 2;
  p.groups = G;
  const dim3 grid((p.nq + G * QT - 1) / (G * QT), chunks);
  const size_t smem = (size_t)TOPK_WARPS * QT * p.k * (sizeof(float) + sizeof(int));
  topk_scan_kernel<T, SMAX, QT><<<grid, TOPK_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_scan_dim(const TopkParams& p, int chunks, cudaStream_t stream) {
  if (p.dim <= 256) return launch_scan<T, 1, 4>(p, chunks, stream);
  if (p.dim <= 512) return launch_scan<T, 2, 4>(p, chunks, stream);
  return launch_scan<T, 4, 2>(p, chunks, stream);
}

}  // namespace

// dtype: 0 f32, 1 bf16 (queries in the storage type), 2 s8 (queries f32,
// db_scale (n,) f32). Scratch cand_val / cand_idx: (chunks, nq, k); the
// chunks of rows_per_chunk rows cover [0, n_valid). Outputs (nq, k).
extern "C" int emr2a_cosine_topk(const void* q, const void* db, const void* db_scale, int dtype,
                                 int nq, int n_valid, int dim, int k, int chunks,
                                 int rows_per_chunk, void* cand_val, void* cand_idx,
                                 void* out_val, void* out_idx, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (nq < 1 || k < 1 || k > TOPK_KMAX || k > n_valid || dim < 8 || dim % 8 ||
      dim > TOPK_DIM_MAX || chunks < 1 || chunks > TOPK_CHUNKS_MAX || rows_per_chunk < 1 ||
      (long long)chunks * rows_per_chunk < n_valid || dtype < 0 || dtype > 2 ||
      (dtype == 2 && db_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  TopkParams p = {};
  p.q = q;
  p.db = db;
  p.db_scale = static_cast<const float*>(db_scale);
  p.nq = nq;
  p.n_valid = n_valid;
  p.dim = dim;
  p.k = k;
  p.rows_per_chunk = rows_per_chunk;
  p.cand_val = static_cast<float*>(cand_val);
  p.cand_idx = static_cast<int*>(cand_idx);
  cudaError_t err = dtype == 0   ? launch_scan_dim<float>(p, chunks, st)
                    : dtype == 1 ? launch_scan_dim<bf16>(p, chunks, st)
                                 : launch_scan_dim<int8_t>(p, chunks, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_merge_kernel<<<nq, TOPK_THREADS, chunks * sizeof(int), st>>>(
      p.cand_val, p.cand_idx, chunks, nq, k, static_cast<float*>(out_val),
      static_cast<int*>(out_idx));
  return static_cast<int>(cudaGetLastError());
}

static bool tc_args_ok(int dtype, int nq, int n_valid, int dim, int k, int sm_count) {
  return nq >= 1 && k >= 1 && k <= n_valid && dim >= 8 && dim % 8 == 0 && dim <= TOPK_DIM_MAX &&
         sm_count >= 1 && dtype >= 0 && dtype <= 2;
}

// The tile scan's chunk count for these arguments (its (chunks, nq, k)
// scratch), or -1 if it does not take them.
extern "C" int emr2a_cosine_topk_tc_chunks(int dtype, int nq, int n_valid, int dim, int k,
                                           int sm_count) {
  if (!tc_args_ok(dtype, nq, n_valid, dim, k, sm_count)) return -1;
  return tc_plan(dtype, nq, n_valid, dim, k, sm_count).chunks;
}

// The tile scan, then the merge. Same operands as emr2a_cosine_topk; any
// 1 <= k <= n_valid; chunks must be emr2a_cosine_topk_tc_chunks(...).
extern "C" int emr2a_cosine_topk_tc(const void* q, const void* db, const void* db_scale, int dtype,
                                    int nq, int n_valid, int dim, int k, int sm_count, int chunks,
                                    void* cand_val, void* cand_idx, void* out_val, void* out_idx,
                                    void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (!tc_args_ok(dtype, nq, n_valid, dim, k, sm_count) || (dtype == 2 && db_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const TcPlan pl = tc_plan(dtype, nq, n_valid, dim, k, sm_count);
  if (pl.chunks != chunks || chunks > TOPK_CHUNKS_MAX) return static_cast<int>(cudaErrorInvalidValue);
  TcParams p = {};
  p.q = q;
  p.db = db;
  p.db_scale = static_cast<const float*>(db_scale);
  p.nq = nq;
  p.n_valid = n_valid;
  p.dim = dim;
  p.k = k;
  p.kch = pl.kch;
  p.nst = pl.nst;
  p.rows_per_chunk = pl.rows_per_chunk;
  p.list_in_smem = pl.list_in_smem;
  p.cand_val = static_cast<float*>(cand_val);
  p.cand_idx = static_cast<int*>(cand_idx);
  cudaError_t err = dtype == 0   ? launch_tc<float>(p, pl, st)
                    : dtype == 1 ? launch_tc<bf16>(p, pl, st)
                                 : launch_tc<int8_t>(p, pl, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_merge_kernel<<<nq, TOPK_THREADS, chunks * sizeof(int), st>>>(
      p.cand_val, p.cand_idx, chunks, nq, k, static_cast<float*>(out_val),
      static_cast<int*>(out_idx));
  return static_cast<int>(cudaGetLastError());
}
