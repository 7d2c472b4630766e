// Fused LN -> QKV -> attention -> out-proj -> residual block (K3) for
// Hopper (sm_90a).
//
// Replaces emr2a_tpu/ops/attention_block.py:270 fused_ln_attention (the
// Pallas kernel _attn_block_kernel at :102, pallas_call at :313):
//   h = LN(x)                      f32 statistics, rounded to bf16
//   q/k/v = h @ W + b              f32 accumulation, rounded to bf16
//   p = softmax(q k^T * hd^-0.5 + mask)   f32 logits and softmax; keys at or
//                                  past valid_len get -1e30; p rounded to bf16
//   o = p v                        f32 accumulation, rounded to bf16
//   y = x + bf16(o @ Wo + bo)
//
// Bound on the H100: at ViT-B (B x 200 x 768, 12 heads of 64) the four
// projections are ~8/9 of the operations and bound by the tensor cores
// ((32, 200, 768): 34 us at 989 TFLOP/s). Design: four launches. The LN row
// pass of gemm.cuh writes h into the attention-output scratch; the Q/K/V
// projections are one launch of the TMA-fed wgmma GEMM (gemm.cuh) with
// three weight maps (z = 0, 1, 2 picks Wq/Wk/Wv) and the bias in its
// epilogue; the attention core (attention_core.cuh) takes any sequence
// length and overwrites h with the attention output; the out-projection
// GEMM fuses bias and residual. Q/K/V and the attention output each make
// one round trip through device memory (at (32, 200, 768): 39 and 9.8 MB).
#include "attention_core.cuh"
#include "gemm.cuh"

using namespace emr2a;

// The TMA maps of the four (d, d) weights: Wq, Wk, Wv, Wo.
static cudaError_t encode_weight_maps(CUtensorMap* wmap, const void* wq, const void* wk,
                                      const void* wv, const void* wo, int d) {
  const void* w[4] = {wq, wk, wv, wo};
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 4 && err == cudaSuccess; ++i) err = encode_gemm_b(&wmap[i], w[i], d, d);
  return err;
}

// The four launches over B items; Q, K and V go to qkv + z * plane; attn
// holds h until the core overwrites it, so one map serves both products.
static int emr2a_fused_ln_attention_planes(const void* x, const void* ln_scale,
                                           const void* ln_bias, const CUtensorMap* wmap,
                                           const void* bq, const void* bk, const void* bv,
                                           const void* bo, void* qkv, size_t plane, void* attn,
                                           void* out, int B, int S, int d, int num_heads,
                                           int valid_len, float eps, cudaStream_t st) {
  const int T = B * S;
  bf16* qkv_b = static_cast<bf16*>(qkv);
  bf16* h = static_cast<bf16*>(attn);
  if (valid_len > S) valid_len = S;
  if (d != num_heads * ATT_HD || valid_len < 1) return static_cast<int>(cudaErrorInvalidValue);

  cudaError_t err = launch_layer_norm_rows(static_cast<const bf16*>(x),
                                           static_cast<const bf16*>(ln_scale),
                                           static_cast<const bf16*>(ln_bias), h, T, d, eps, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap amap;
  err = encode_gemm_a(&amap, h, T, d);
  if (err != cudaSuccess) return static_cast<int>(err);

  GemmParams p1 = {};
  p1.bias[0] = static_cast<const bf16*>(bq);
  p1.bias[1] = static_cast<const bf16*>(bk);
  p1.bias[2] = static_cast<const bf16*>(bv);
  for (int z = 0; z < 3; ++z) p1.out[z] = qkv_b + z * plane;
  p1.M = T;
  p1.N = d;
  p1.K = d;
  p1.nz = 3;
  err = launch_gemm<EPI_BIAS>(amap, wmap, p1, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  err = launch_attention_core<bf16>(qkv_b, qkv_b + plane, qkv_b + 2 * plane, h, B, S, d,
                                    num_heads, valid_len, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  GemmParams p2 = {};
  p2.bias[0] = static_cast<const bf16*>(bo);
  p2.out[0] = static_cast<bf16*>(out);
  p2.residual = static_cast<const bf16*>(x);
  p2.M = T;
  p2.N = d;
  p2.K = d;
  p2.nz = 1;
  return static_cast<int>(launch_gemm<EPI_BIAS_RESIDUAL>(amap, wmap + 3, p2, st));
}

// qkv: scratch (3, B*S, d); attn: scratch (B*S, d).
extern "C" int emr2a_fused_ln_attention(const void* x, const void* ln_scale,
                                        const void* ln_bias, const void* wq, const void* bq,
                                        const void* wk, const void* bk, const void* wv,
                                        const void* bv, const void* wo, const void* bo,
                                        void* qkv, void* attn, void* out, int B, int S, int d,
                                        int num_heads, int valid_len, float eps,
                                        void* stream) {
  CUtensorMap wmap[4];
  const cudaError_t err = encode_weight_maps(wmap, wq, wk, wv, wo, d);
  if (err != cudaSuccess) return static_cast<int>(err);
  return emr2a_fused_ln_attention_planes(x, ln_scale, ln_bias, wmap, bq, bk, bv, bo, qkv,
                                         (size_t)B * S * d, attn, out, B, S, d, num_heads,
                                         valid_len, eps, reinterpret_cast<cudaStream_t>(stream));
}

// The card's SM count and L2 size: K3m's group rule
// (ops/attention_block.merged_group) reads both here.
extern "C" int emr2a_device_caps(int* sms, int* l2_bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(l2_bytes, cudaDevAttrL2CacheSize, dev);
  return static_cast<int>(err);
}

// K3m: the same function over groups of items (emr2a_tpu/ops/
// attention_block.py:_attn_block_kernel_merged, which
// fused_ln_attention(..., merge_batch=True) selects). The TPU variant keeps
// a group of block_b items' (block_b*S, d) tile in VMEM from LN to the
// out-projection; on this card the counterpart of VMEM residency is L2. Per
// group of G items: LN and the Q/K/V projections once over the group's G*S
// rows, the attention core per item, then the out-projection with bias and
// residual over the group's rows, each group in its own scratch set, (3,
// G*S, d) + (G*S, d) bf16, which the next group but one reuses.
//
// Bound: as K3, bound by the tensor cores on the projections. The TPU's
// group of block_b items gives this card small grids (at ViT-B, block_b 4:
// 42 out-projection tiles on 132 SMs), and the four launches of a group run
// one after another, each paying its tail. Design: the wrapper picks G, a
// multiple of block_b, from the SM count and the L2 size (the out-projection
// tiles cover the SMs 1.5 times, a group's scratch fits a share of L2: 24
// items at ViT-B), and groups alternate between two streams and two scratch
// sets (stream2 may equal stream), so that group g+1's LN and Q/K/V run
// beside group g's core and out-projection and each launch's tail is filled
// by the other stream. The
// wrapper forks stream2 from stream and joins it back, with events, which a
// CUDA graph captures. Each output element's K-loop (gemm.cuh picks the tile
// by N alone) and each item's attention are K3's, so the result is K3's bit
// for bit at every G.
//
// qkv: scratch (nsets, 3, G*S, d); attn: scratch (nsets, G*S, d), nsets = 2
// where there is more than one group, else 1.
extern "C" int emr2a_fused_ln_attention_merged(
    const void* x, const void* ln_scale, const void* ln_bias, const void* wq, const void* bq,
    const void* wk, const void* bk, const void* wv, const void* bv, const void* wo,
    const void* bo, void* qkv, void* attn, void* out, int B, int S, int d, int num_heads,
    int valid_len, int group, float eps, void* stream, void* stream2) {
  if (group < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap wmap[4];   // every group's weights
  const cudaError_t enc = encode_weight_maps(wmap, wq, wk, wv, wo, d);
  if (enc != cudaSuccess) return static_cast<int>(enc);
  const int G = group < B ? group : B;
  const size_t plane = (size_t)G * S * d;   // one projection's scratch
  const size_t item = (size_t)S * d;
  cudaStream_t streams[2] = {reinterpret_cast<cudaStream_t>(stream),
                             reinterpret_cast<cudaStream_t>(stream2)};
  for (int g = 0, b0 = 0; b0 < B; ++g, b0 += G) {
    const int set = g & 1;
    const int nb = B - b0 < G ? B - b0 : G;
    const bf16* xg = static_cast<const bf16*>(x) + b0 * item;
    bf16* og = static_cast<bf16*>(out) + b0 * item;
    int err = emr2a_fused_ln_attention_planes(
        xg, ln_scale, ln_bias, wmap, bq, bk, bv, bo, static_cast<bf16*>(qkv) + set * 3 * plane,
        plane, static_cast<bf16*>(attn) + set * plane, og, nb, S, d, num_heads, valid_len, eps,
        streams[set]);
    if (err != 0) return err;
  }
  return 0;
}
