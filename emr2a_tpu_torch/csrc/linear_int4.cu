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
// Two designs, chosen by T (both shared with K5, linear_int8.cu):
// - T <= 16 (decode): linear_gemv.cuh, one launch. It quantizes the rows in
//   shared memory, streams the packed weights with 16-byte loads, splits K
//   across blocks by whole groups and writes each group's rounded product
//   f32(acc_g) * w_scale[g] to a (G, T, N) scratch; the strip's last block
//   sums them in group order.
// - T > 16 (prefill): quant.cuh's row pass, then gemm_s8_wgmma.cuh, the s8
//   wgmma GEMM with TMA and an mbarrier ring, one stage per group, the s32
//   tile folded into f32 sums in group order after each group.
//   The weights keep their (K/2, N) layout (route a): wgmma takes 8-bit
//   operands K-major only, so the GEMM swaps the operands, Y^T = W^T X^T,
//   with the weight tile as the register A operand (transposed and
//   sign-extended in registers) and the K-contiguous x codes as the shared
//   B operand. A transposed copy of each weight (route b) would hold a second
//   layout on the card or change the one the JAX package and the plain
//   version read; route (a) needs neither.
#include "linear_quantized.cuh"

using namespace emr2a;

// x (T, K) bf16; w_p (K/2, N) s8 packed; w_scale (K/128, N) f32; bias (N,)
// bf16 or null; scratch of emr2a_linear_scratch_bytes(1, ...); counters
// (N / 128,) u32, zero; out (T, N) bf16; sms the card's SM count.
// Rules the wrapper checks: K % 128 == 0, N % 128 == 0, T >= 1, 16-byte
// aligned pointers.
extern "C" int emr2a_linear_w4a8(const void* x, const void* w, const void* w_scale,
                                 const void* bias, void* scratch, void* counters, void* out,
                                 int T, int K, int N, int sms, void* stream) {
  return static_cast<int>(run_linear<true>(x, w, w_scale, bias, scratch, counters, out, T, K, N,
                                           sms, reinterpret_cast<cudaStream_t>(stream)));
}
