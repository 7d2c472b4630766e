// Fused LN -> MLP -> residual block (K1) for Hopper (sm_90a).
//
// Replaces emr2a_tpu/ops/mlp.py:75 fused_ln_mlp (the Pallas kernel
// _mlp_kernel, pallas_call at :95):
//   y = x + fc2(gelu_tanh(fc1(LN(x))))
// with f32 LN statistics, the LN output rounded to bf16, fc1 + b1 and the
// tanh gelu in f32, the activation rounded to bf16, fc2 accumulated in f32,
// + b2 rounded to bf16, then the residual add. With ACT_BF16 (JAX's
// act_dtype=bfloat16) fc1 + b1 is rounded to bf16 and the gelu is evaluated
// in bf16 (gelu_tanh_bf16 in common.cuh); the f32 path is unchanged. With
// ACT_QUICK_GELU (CLIP's activation, x * sigmoid(1.702 x)) the same
// two rounding paths evaluate quick_gelu / quick_gelu_bf16 instead.
//
// Bound on the H100: at ViT-B (T = B*200, d = 768, m = 3072) the block is
// 4*T*d*m bf16 operations against ~4*T*d + 2*d*m bytes, i.e. bound by the
// tensor cores (T = 6,400: 60.4 GFLOP, 61 us at 989 TFLOP/s).
// Design: three launches of gemm.cuh: the LN row pass writes h = bf16(LN(x))
// into the output buffer, which serves as its scratch (fc2 overwrites it);
// fc1 is the TMA-fed wgmma GEMM (128 x 256 tiles) with bias and gelu in its
// epilogue, writing the (T, m) bf16 activation h1; fc2 (128 x 128 tiles)
// adds bias and residual in its epilogue. h1 makes one round trip through
// device memory (2 x 39 MB at T = 6,400).
#include "gemm.cuh"

using namespace emr2a;

extern "C" const char* emr2a_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The activation flags of K1 and K2 (act): bit 0 evaluates the activation in
// bf16 (act_dtype=bfloat16), bit 1 selects quick_gelu over the tanh gelu.
constexpr int ACT_BF16 = 1, ACT_QUICK_GELU = 2;

// The four activations of the fc1 epilogues on n f32 values, one thread a
// value (act: the flags above), so that each epilogue can be held against
// its device function on the card.
static __global__ void activation_values_kernel(const float* __restrict__ v,
                                                float* __restrict__ out, int n, int act) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = v[i];
  out[i] = act == 0                ? gelu_tanh(x)
           : act == ACT_BF16       ? gelu_tanh_bf16(round_bf16(x))
           : act == ACT_QUICK_GELU ? quick_gelu(x)
                                   : quick_gelu_bf16(round_bf16(x));
}

extern "C" int emr2a_activation_values(const void* v, void* out, int n, int act, void* stream) {
  if (n < 1 || act < 0 || act > 3) return static_cast<int>(cudaErrorInvalidValue);
  activation_values_kernel<<<(n + 255) / 256, 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<float*>(out), n, act);
  return static_cast<int>(cudaGetLastError());
}

// h1: scratch (T, m) bf16; out (T, d) also holds h = LN(x) until fc2.
extern "C" int emr2a_fused_ln_mlp(const void* x, const void* ln_scale, const void* ln_bias,
                                  const void* w1, const void* b1, const void* w2,
                                  const void* b2, void* h1, void* out, int T, int d,
                                  int m, int act, float eps, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  bf16* h = static_cast<bf16*>(out);
  cudaError_t err = launch_layer_norm_rows(static_cast<const bf16*>(x),
                                           static_cast<const bf16*>(ln_scale),
                                           static_cast<const bf16*>(ln_bias), h, T, d, eps, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  CUtensorMap amap, bmap;
  err = encode_gemm_a(&amap, h, T, d);
  if (err == cudaSuccess) err = encode_gemm_b(&bmap, w1, d, m);
  if (err != cudaSuccess) return static_cast<int>(err);
  GemmParams p1 = {};
  p1.bias[0] = static_cast<const bf16*>(b1);
  p1.out[0] = static_cast<bf16*>(h1);
  p1.M = T;
  p1.N = m;
  p1.K = d;
  p1.nz = 1;
  switch (act) {
    case 0: err = launch_gemm<EPI_BIAS_GELU>(amap, &bmap, p1, st); break;
    case ACT_BF16: err = launch_gemm<EPI_BIAS_GELU_BF16>(amap, &bmap, p1, st); break;
    case ACT_QUICK_GELU: err = launch_gemm<EPI_BIAS_QGELU>(amap, &bmap, p1, st); break;
    case ACT_QUICK_GELU | ACT_BF16:
      err = launch_gemm<EPI_BIAS_QGELU_BF16>(amap, &bmap, p1, st);
      break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  err = encode_gemm_a(&amap, h1, T, m);
  if (err == cudaSuccess) err = encode_gemm_b(&bmap, w2, m, d);
  if (err != cudaSuccess) return static_cast<int>(err);
  GemmParams p2 = {};
  p2.bias[0] = static_cast<const bf16*>(b2);
  p2.out[0] = static_cast<bf16*>(out);
  p2.residual = static_cast<const bf16*>(x);
  p2.M = T;
  p2.N = d;
  p2.K = m;
  p2.nz = 1;
  return static_cast<int>(launch_gemm<EPI_BIAS_RESIDUAL>(amap, &bmap, p2, st));
}
