// Fused LN -> QKV -> attention -> out-proj -> residual block for Hopper
// (sm_90a).
//
// Replaces emr2a_tpu/ops/attention_block.py:fused_ln_attention (the Pallas
// kernel _attn_block_kernel):
//   h = LN(x)                      f32 statistics, rounded to bf16
//   q/k/v = h @ W + b              f32 accumulation, rounded to bf16
//   p = softmax(q k^T * hd^-0.5 + mask)   f32 logits and softmax; keys at or
//                                  past valid_len get -1e30; p rounded to bf16
//   o = p v                        f32 accumulation, rounded to bf16
//   y = x + bf16(o @ Wo + bo)
//
// Bound on the H100: at ViT-B (B x 200 x 768, 12 heads of 64) the four
// projections are ~8/9 of the FLOPs and compute-bound; the attention core is
// small (S = 200) and its K/V per head (200 x 64 bf16 each) fit in shared
// memory. Design: three launches. The Q/K/V projections are one launch of
// the hand-written GEMM (gemm.cuh) with the LayerNorm fused into its operand
// load and blockIdx.z picking Wq/Wk/Wv; the attention core (attention_core.cuh) holds one
// head's K and V in shared memory and gives each warp 16 query rows whose
// whole logits row stays on chip; the out-projection GEMM fuses bias and
// residual. Not yet done: Q/K/V and the attention output make one round trip
// through device memory each; keeping them on chip is the first optimisation
// queued for this kernel.
#include "attention_core.cuh"
#include "gemm.cuh"

using namespace emr2a;

// qkv: scratch (3, B*S, d); attn: scratch (B*S, d).
extern "C" int emr2a_fused_ln_attention(const void* x, const void* ln_scale,
                                        const void* ln_bias, const void* wq, const void* bq,
                                        const void* wk, const void* bk, const void* wv,
                                        const void* bv, const void* wo, const void* bo,
                                        void* qkv, void* attn, void* out, int B, int S, int d,
                                        int num_heads, int valid_len, float eps,
                                        void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int T = B * S;
  bf16* qkv_b = static_cast<bf16*>(qkv);
  if (valid_len > S) valid_len = S;
  const int sp = (S + 15) / 16 * 16;
  if (sp > ATT_MAX_SP || d != num_heads * ATT_HD || valid_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);

  GemmParams p1 = {};
  p1.a = static_cast<const bf16*>(x);
  p1.b[0] = static_cast<const bf16*>(wq);
  p1.b[1] = static_cast<const bf16*>(wk);
  p1.b[2] = static_cast<const bf16*>(wv);
  p1.bias[0] = static_cast<const bf16*>(bq);
  p1.bias[1] = static_cast<const bf16*>(bk);
  p1.bias[2] = static_cast<const bf16*>(bv);
  for (int z = 0; z < 3; ++z) p1.out[z] = qkv_b + (size_t)z * T * d;
  p1.ln_scale = static_cast<const bf16*>(ln_scale);
  p1.ln_bias = static_cast<const bf16*>(ln_bias);
  p1.eps = eps;
  p1.M = T;
  p1.N = d;
  p1.K = d;
  cudaError_t err = launch_gemm<EPI_BIAS, true>(p1, 3, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  err = launch_attention_core<bf16>(qkv_b, qkv_b + (size_t)T * d, qkv_b + (size_t)2 * T * d,
                                    static_cast<bf16*>(attn), B, S, d, num_heads, valid_len, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  GemmParams p2 = {};
  p2.a = static_cast<const bf16*>(attn);
  p2.b[0] = static_cast<const bf16*>(wo);
  p2.bias[0] = static_cast<const bf16*>(bo);
  p2.out[0] = static_cast<bf16*>(out);
  p2.residual = static_cast<const bf16*>(x);
  p2.M = T;
  p2.N = d;
  p2.K = d;
  return static_cast<int>(launch_gemm<EPI_BIAS_RESIDUAL, false>(p2, 1, st));
}
