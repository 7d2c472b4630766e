// Fused LN -> QKV -> attention -> out-proj -> residual block in W8A8 (K4)
// for Hopper (sm_90a).
//
// Replaces emr2a_tpu/ops/attention_block.py:436 fused_ln_attention_int8
// (the Pallas kernel _attn_block_kernel_i8, pallas_call at :465):
//   h = LN(x)                        f32 output; statistics from exact
//                                    f64 row sums (quant.cuh)
//   hq = q8(h)                       per-row s8 codes + f32 scale
//   q/k/v = bf16((hq @ Wq) * s_row * s_col + b)     s32 products
//   p = softmax(q k^T * hd^-0.5 + mask)  f32; keys at or past valid_len get
//                                    -1e30; p rounded to bf16
//   o = p v                          f32 accumulation, kept in f32
//   oq = q8(o)
//   y = x + bf16((oq @ Wo) * s_row * s_col + bo)
//
// Bound on the H100: at ViT-B (B x 200 x 768, 12 heads of 64) the four
// projections, 8*T*d*d s8 operations (0.0157 ms at (32, 200, 768) over
// 1,979 TOP/s), are ~8/9 of the work, bound by the tensor cores; the
// attention core's bf16 operations are the rest.
// Design: five launches, built from the pieces of K3 and K2: (1) quant.cuh's
// row pass fuses the LayerNorm and quantizes its f32 output; (2) one launch
// of the persistent s8 wgmma GEMM (gemm_s8_wgmma.cuh) over the three weights
// Wq/Wk/Wv (a tile picks its weight, scales, bias and output by index, and
// the 18 column tiles of a token block run side by side on its x codes)
// writes bf16 Q/K/V; (3) K3's attention core (attention_core.cuh: any
// sequence length) in its f32-output variant, since the TPU kernel
// quantizes the unrounded P.V; (4) the row pass quantizes P.V; (5) the same
// GEMM computes the out-projection with the rescale, bias and residual add
// in its epilogue, at a token tile chosen by T so that its last wave of
// tiles is not thin (N = 768). Q/K/V and P.V make one round trip through
// device memory each.
#include "attention_core.cuh"
#include "gemm_s8_wgmma.cuh"
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
  int sms = 0;
  cudaError_t err = current_sms(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);

  QuantParams qp = {};
  qp.x = x;
  qp.ln_scale = static_cast<const bf16*>(ln_scale);
  qp.ln_bias = static_cast<const bf16*>(ln_bias);
  qp.eps = eps;
  qp.q = static_cast<int8_t*>(hq);
  qp.scale = static_cast<float*>(hs);
  qp.rows = T;
  qp.K = d;
  err = launch_quantize_rows<bf16, true>(qp, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  bf16* qkv_b = static_cast<bf16*>(qkv);
  WgmmaParams p1 = {};
  p1.x_scale = static_cast<const float*>(hs);
  p1.w_scale[0] = static_cast<const float*>(sq);
  p1.w_scale[1] = static_cast<const float*>(sk);
  p1.w_scale[2] = static_cast<const float*>(sv);
  p1.bias[0] = static_cast<const bf16*>(bq);
  p1.bias[1] = static_cast<const bf16*>(bk);
  p1.bias[2] = static_cast<const bf16*>(bv);
  for (int z = 0; z < 3; ++z) p1.out[z] = qkv_b + static_cast<size_t>(z) * T * d;
  p1.T = T;
  p1.K = d;
  p1.N = d;
  const int8_t* w3[3] = {static_cast<const int8_t*>(wq), static_cast<const int8_t*>(wk),
                         static_cast<const int8_t*>(wv)};
  err = launch_gemm_s8_wgmma<false, EPI_S8_BF16, 3>(static_cast<const int8_t*>(hq), w3, p1, sms,
                                                     st);
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

  WgmmaParams p2 = {};
  p2.x_scale = static_cast<const float*>(as);
  p2.w_scale[0] = static_cast<const float*>(so);
  p2.bias[0] = static_cast<const bf16*>(bo);
  p2.out[0] = out;
  p2.residual = static_cast<const bf16*>(x);
  p2.T = T;
  p2.K = d;
  p2.N = d;
  const int8_t* wo_q = static_cast<const int8_t*>(wo);
  return static_cast<int>(launch_gemm_s8_wgmma<false, EPI_S8_RESIDUAL>(
      static_cast<const int8_t*>(aq), &wo_q, p2, sms, st));
}
