// Fused LN -> QKV -> attention -> out-proj -> residual block in W8A8 (K4)
// for Hopper (sm_90a).
//
// Replaces emr2a_tpu/ops/attention_block.py:436 fused_ln_attention_int8
// (the Pallas kernel _attn_block_kernel_i8, pallas_call at :465):
//   h = LN(x)                        f32 statistics, f32 output
//   hq = q8(h)                       per-row s8 codes + f32 scale
//   q/k/v = bf16((hq @ Wq) * s_row * s_col + b)     s32 products
//   p = softmax(q k^T * hd^-0.5 + mask)  f32; keys at or past valid_len get
//                                    -1e30; p rounded to bf16
//   o = p v                          f32 accumulation, kept in f32
//   oq = q8(o)
//   y = x + bf16((oq @ Wo) * s_row * s_col + bo)
//
// Bound on the H100: at ViT-B (B x 200 x 768, 12 heads of 64) the four
// projections are ~8/9 of the operations, bound by the tensor cores.
// Design: five launches, built from the pieces of K3 and K2: (1) quant.cuh's
// row pass fuses the LayerNorm and quantizes its f32 output; (2) one s8 GEMM
// launch (gemm_s8.cuh, wmma) with blockIdx.z picking Wq/Wk/Wv writes bf16
// Q/K/V; (3) K3's attention core (attention_core.cuh: any sequence length)
// in its f32-output variant, since the TPU kernel quantizes the unrounded
// P.V; (4) the row pass quantizes P.V; (5) the s8 GEMM computes the
// out-projection with the rescale, bias and residual add in its epilogue.
// Q/K/V and P.V make one round trip through device memory each; the s8
// GEMMs' move to wgmma is queued.
#include "attention_core.cuh"
#include "gemm_s8.cuh"
#include "quant.cuh"

using namespace emr2a;

// w*: (d, d) s8 codes; s*: (d,) f32 column scales; b*: (d,) bf16.
// Scratch: hq (T, d) s8, hs (T,) f32, qkv (3, T, d) bf16, attn (T, d) f32,
// aq (T, d) s8, as (T,) f32.
extern "C" int emr2a_fused_ln_attention_int8(
    const void* x, const void* ln_scale, const void* ln_bias, const void* wq, const void* sq,
    const void* bq, const void* wk, const void* sk, const void* bk, const void* wv,
    const void* sv, const void* bv, const void* wo, const void* so, const void* bo, void* hq,
    void* hs, void* qkv, void* attn, void* aq, void* as, void* out, int B, int S, int d,
    int num_heads, int valid_len, float eps, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int T = B * S;
  if (valid_len > S) valid_len = S;
  if (d != num_heads * ATT_HD || valid_len < 1) return static_cast<int>(cudaErrorInvalidValue);

  QuantParams qp = {};
  qp.x = x;
  qp.ln_scale = static_cast<const bf16*>(ln_scale);
  qp.ln_bias = static_cast<const bf16*>(ln_bias);
  qp.eps = eps;
  qp.q = static_cast<int8_t*>(hq);
  qp.scale = static_cast<float*>(hs);
  qp.rows = T;
  qp.K = d;
  cudaError_t err = launch_quantize_rows<bf16, true>(qp, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  bf16* qkv_b = static_cast<bf16*>(qkv);
  GemmS8Params p1 = {};
  p1.a = static_cast<const int8_t*>(hq);
  p1.a_scale = static_cast<const float*>(hs);
  p1.b[0] = static_cast<const int8_t*>(wq);
  p1.b[1] = static_cast<const int8_t*>(wk);
  p1.b[2] = static_cast<const int8_t*>(wv);
  p1.b_scale[0] = static_cast<const float*>(sq);
  p1.b_scale[1] = static_cast<const float*>(sk);
  p1.b_scale[2] = static_cast<const float*>(sv);
  p1.bias[0] = static_cast<const bf16*>(bq);
  p1.bias[1] = static_cast<const bf16*>(bk);
  p1.bias[2] = static_cast<const bf16*>(bv);
  for (int z = 0; z < 3; ++z) p1.out[z] = qkv_b + (size_t)z * T * d;
  p1.M = T;
  p1.N = d;
  p1.K = d;
  err = launch_gemm_s8<EPI_S8_BF16>(p1, 3, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  err = launch_attention_core<float>(qkv_b, qkv_b + (size_t)T * d, qkv_b + (size_t)2 * T * d,
                                     static_cast<float*>(attn), B, S, d, num_heads, valid_len,
                                     st);
  if (err != cudaSuccess) return static_cast<int>(err);

  QuantParams qp2 = {};
  qp2.x = attn;
  qp2.q = static_cast<int8_t*>(aq);
  qp2.scale = static_cast<float*>(as);
  qp2.rows = T;
  qp2.K = d;
  err = launch_quantize_rows<float, false>(qp2, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  GemmS8Params p2 = {};
  p2.a = static_cast<const int8_t*>(aq);
  p2.a_scale = static_cast<const float*>(as);
  p2.b[0] = static_cast<const int8_t*>(wo);
  p2.b_scale[0] = static_cast<const float*>(so);
  p2.bias[0] = static_cast<const bf16*>(bo);
  p2.out[0] = out;
  p2.residual = static_cast<const bf16*>(x);
  p2.M = T;
  p2.N = d;
  p2.K = d;
  return static_cast<int>(launch_gemm_s8<EPI_S8_RESIDUAL>(p2, 1, st));
}
