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
//   index.
// The queries come in the storage type (f32, bf16), or in f32 for s8.
//
// Bound on the H100: the bytes of the DB (n * dim * elem, + 4n for the s8
// scales) at 3.35 TB/s while q is small (1M x 512: 0.611 ms f32, 0.306 bf16,
// 0.154 s8); at q = 64 in f32 the 2*q*n*dim FMAs at 67 TFLOP/s (about 1.0 ms).
//
// Design: two passes. The TPU kernel walks the DB in a sequential grid with a
// running top-k in VMEM; Hopper's blocks run in parallel, so:
// Pass 1 (topk_scan_kernel): a block of 8 warps takes one chunk of rows and up
//   to 8 groups of QT queries; each warp holds its group's queries in
//   registers, and the warps of a group split the chunk's rows (warps of
//   other groups read the same rows again, from L1). A lane reads 8 elements
//   of a row per step (f32 2 x 16 B, bf16 16 B, s8 8 B: coalesced across the
//   warp); the QT partial sums of a row are reduced across the warp by a
//   transposing butterfly (QT - 1 + 5 - log2(QT) shuffles for QT sums), after
//   which lane j < QT holds the score of one query. That lane keeps the warp's
//   sorted top-k for its query in shared memory and drops a score at once when
//   it does not beat the k-th best (the TPU kernel's tile skip, per row). A
//   warp walks its rows in increasing order, so a later equal score never
//   displaces an earlier one. The block then merges its warps' lists for each
//   query into (chunk, q, k) scratch.
// Pass 2 (topk_merge_kernel): one block per query merges the chunks' sorted
//   lists: k rounds of an argmax over the list heads, by (score descending,
//   index ascending).
// Enough chunks (2 per SM) keep all 132 SMs busy at q = 1. Later work: wgmma
// for large q, TMA, a persistent grid.
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
