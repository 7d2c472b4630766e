"""Fused LayerNorm -> QKV -> attention -> out-proj -> residual (K3),
hand-written for Hopper.

Port of ``emr2a_tpu/ops/attention_block.py:fused_ln_attention`` (Pallas
``_attn_block_kernel``):

    h = LN(x);  q/k/v = h @ W + b
    y = x + out_proj(softmax(q k^T / sqrt(hd) + mask) v)

over whole sequences of one item. Rounding points, as in the TPU kernel:
LN statistics in f32, h rounded to ``x.dtype``; each projection accumulated
in f32 and rounded to ``x.dtype`` after its bias; logits and softmax in f32
with keys at or past ``valid_len`` given -1e30; probabilities rounded to
``x.dtype`` before P.V; P.V accumulated in f32 and rounded; the out-proj
accumulated in f32, + bo rounded, then the residual add.

Rows at or past ``valid_len`` are padding kept across layers by the caller
(``models/vit.py``): they are masked as keys and their outputs are junk.

The TPU kernel's ``merge_batch`` variant (``_attn_block_kernel_merged``) is
a scheduling variant of the same function; this port computes the function
and has no such switch. ``head_group`` and ``block_b`` are TPU VMEM tiling
knobs and have no counterpart here.

A CPU tensor goes to ``fused_ln_attention_reference``; a CUDA tensor goes to
the CUDA kernel in ``csrc/attention_block.cu`` (bf16, head dim 64,
sequence at most 384), or the call raises. ``LAUNCHES`` counts the calls
that went to the kernel.

The W8A8 variant, K4 (``fused_ln_attention_int8``, port of
``emr2a_tpu/ops/attention_block.py:fused_ln_attention_int8``), runs the
four projections as s8 products from int8 weights with per-column f32
scales. Rounding points, as in the TPU kernel: the f32 LN output is
quantized per row; q/k/v = (acc * row scale) * column scale + b, rounded to
``x.dtype``; the softmax as in K3; P.V accumulated in f32 and quantized per
row unrounded; the out-proj rescaled + bo, rounded, then the residual add.
A CUDA tensor goes to ``csrc/attention_block_int8.cu`` (same limits as K3),
or the call raises. ``INT8_LAUNCHES`` counts the calls that went to it.
"""

from __future__ import annotations

from typing import Optional

import torch

from emr2a_tpu_torch.ops import _build
from emr2a_tpu_torch.ops.mlp import (
    GEMM_BN,
    check_cuda_operands,
    check_cuda_tensor,
    layer_norm_f32,
)
from emr2a_tpu_torch.ops.quant import quantize_rows_s8_reference, s8_matmul

NEG_INF = -1e30
KERNEL_HEAD_DIM = 64
KERNEL_MAX_SEQ = 384   # ATT_MAX_SP in csrc/attention_core.cuh

LAUNCHES = 0
INT8_LAUNCHES = 0


def fused_ln_attention_reference(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv,
                                 wo, bo, num_heads: int, eps: float = 1e-6,
                                 valid_len: Optional[int] = None
                                 ) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with its rounding points:
    products in f32 from ``x.dtype`` operands."""
    B, S, d = x.shape
    if d % num_heads:
        raise ValueError(f"hidden {d} not divisible by num_heads {num_heads}")
    hd = d // num_heads
    valid_len = S if valid_len is None else min(valid_len, S)
    h = layer_norm_f32(x, ln_scale, ln_bias, eps).to(x.dtype).float()

    def proj(w, b):
        y = torch.matmul(h, w.float()) + b.float()
        return y.to(x.dtype).reshape(B, S, num_heads, hd).float()

    q, k, v = proj(wq, bq), proj(wk, bk), proj(wv, bv)
    attn = _sdpa(q, k, v, valid_len, x.dtype).to(x.dtype)
    y = torch.matmul(attn.reshape(B, S, d).float(), wo.float()) + bo.float()
    return x + y.to(x.dtype)


def _sdpa(q, k, v, valid_len: int, dtype) -> torch.Tensor:
    """f32 q/k/v (B, S, H, hd) holding ``dtype`` values -> the f32 P.V of
    the kernels: f32 logits and softmax, keys at or past ``valid_len`` given
    -1e30, probabilities rounded to ``dtype``, f32 products."""
    S, hd = q.shape[1], q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
    if valid_len < S:
        mask = torch.where(torch.arange(S, device=q.device) < valid_len,
                           0.0, NEG_INF).to(torch.float32)
        logits = logits + mask
    probs = torch.softmax(logits, dim=-1).to(dtype).float()
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def fused_ln_attention(x: torch.Tensor, ln_scale, ln_bias, wq, bq, wk, bk,
                       wv, bv, wo, bo, num_heads: int, eps: float = 1e-6,
                       valid_len: Optional[int] = None) -> torch.Tensor:
    """x (B, S, d) -> x + out_proj(attention(LN(x))); weights (d, d) in
    (in, out) layout. ``valid_len`` (default S) limits which rows act as
    keys."""
    if x.device.type == "cpu":
        return fused_ln_attention_reference(
            x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo,
            num_heads=num_heads, eps=eps, valid_len=valid_len)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, d), got {tuple(x.shape)}")
    B, S, d = x.shape
    _check_kernel_shape(S, d, num_heads)
    valid_len = S if valid_len is None else min(valid_len, S)
    if valid_len < 1:
        raise ValueError(f"valid_len must be >= 1, got {valid_len}")
    named = {"x": x, "ln_scale": ln_scale, "ln_bias": ln_bias, "wq": wq,
             "bq": bq, "wk": wk, "bk": bk, "wv": wv, "bv": bv, "wo": wo,
             "bo": bo}
    for name, t in named.items():
        shape = (d, d) if name.startswith("w") else (d,)
        if name != "x" and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    check_cuda_operands(named, x.device)
    if B == 0:
        return x.clone()

    fn = _build.kernel_function("emr2a_fused_ln_attention", _argtypes())
    qkv = torch.empty((3, B * S, d), dtype=x.dtype, device=x.device)
    attn = torch.empty((B * S, d), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(*(t.data_ptr() for t in named.values()),
                 qkv.data_ptr(), attn.data_ptr(), out.data_ptr(),
                 B, S, d, num_heads, valid_len, float(eps), stream)
    _build.check(err, "fused_ln_attention")
    global LAUNCHES
    LAUNCHES += 1
    return out


def _check_kernel_shape(S: int, d: int, num_heads: int) -> None:
    if d % num_heads:
        raise ValueError(f"hidden {d} not divisible by num_heads {num_heads}")
    if d // num_heads != KERNEL_HEAD_DIM:
        raise ValueError(f"the kernel supports head dim {KERNEL_HEAD_DIM}, "
                         f"got {d // num_heads}")
    if d % GEMM_BN:
        raise ValueError(f"the kernel needs d divisible by {GEMM_BN}, got {d}")
    if S > KERNEL_MAX_SEQ:
        raise ValueError(f"the kernel supports sequences up to "
                         f"{KERNEL_MAX_SEQ}, got {S}")


def _argtypes():
    import ctypes
    p, i = ctypes.c_void_p, ctypes.c_int
    return [p] * 14 + [i] * 5 + [ctypes.c_float, p]


# ---------------------------------------------------------------------------
# W8A8 (K4)
# ---------------------------------------------------------------------------

def fused_ln_attention_int8_reference(x, ln_scale, ln_bias, wq_q, wq_s, bq,
                                      wk_q, wk_s, bk, wv_q, wv_s, bv,
                                      wo_q, wo_s, bo, num_heads: int,
                                      eps: float = 1e-6,
                                      valid_len: Optional[int] = None
                                      ) -> torch.Tensor:
    """Plain PyTorch version of K4, with the TPU kernel's rounding points."""
    B, S, d = x.shape
    if d % num_heads:
        raise ValueError(f"hidden {d} not divisible by num_heads {num_heads}")
    hd = d // num_heads
    valid_len = S if valid_len is None else min(valid_len, S)
    hq, hs = quantize_rows_s8_reference(
        layer_norm_f32(x, ln_scale, ln_bias, eps).reshape(B * S, d))

    def rescale(acc, row_scale, w_s, b):
        return acc * row_scale * w_s.reshape(1, -1).float() + b.float()

    def proj(w_q, w_s, b):
        y = rescale(s8_matmul(hq, w_q), hs, w_s, b).to(x.dtype)
        return y.reshape(B, S, num_heads, hd).float()

    q, k, v = proj(wq_q, wq_s, bq), proj(wk_q, wk_s, bk), proj(wv_q, wv_s, bv)
    aq, as_ = quantize_rows_s8_reference(
        _sdpa(q, k, v, valid_len, x.dtype).reshape(B * S, d))
    y = rescale(s8_matmul(aq, wo_q), as_, wo_s, bo)
    return x + y.reshape(B, S, d).to(x.dtype)


def fused_ln_attention_int8(x: torch.Tensor, ln_scale, ln_bias, wq_q, wq_s, bq,
                            wk_q, wk_s, bk, wv_q, wv_s, bv, wo_q, wo_s, bo,
                            num_heads: int, eps: float = 1e-6,
                            valid_len: Optional[int] = None) -> torch.Tensor:
    """x (B, S, d) -> x + out_proj(attention(LN(x))) in W8A8; w*_q (d, d)
    int8 in (in, out) layout, w*_s (d,) f32 column scales (or (1, d))."""
    if x.device.type == "cpu":
        return fused_ln_attention_int8_reference(
            x, ln_scale, ln_bias, wq_q, wq_s, bq, wk_q, wk_s, bk, wv_q, wv_s,
            bv, wo_q, wo_s, bo, num_heads=num_heads, eps=eps,
            valid_len=valid_len)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, d), got {tuple(x.shape)}")
    B, S, d = x.shape
    _check_kernel_shape(S, d, num_heads)
    valid_len = S if valid_len is None else min(valid_len, S)
    if valid_len < 1:
        raise ValueError(f"valid_len must be >= 1, got {valid_len}")
    bf16, dev = torch.bfloat16, x.device
    operands = [x, ln_scale, ln_bias]
    check_cuda_tensor("x", x, dev, bf16)
    check_cuda_tensor("ln_scale", ln_scale, dev, bf16, (d,))
    check_cuda_tensor("ln_bias", ln_bias, dev, bf16, (d,))
    for name, (w_q, w_s, b) in zip(("q", "k", "v", "o"), (
            (wq_q, wq_s, bq), (wk_q, wk_s, bk), (wv_q, wv_s, bv),
            (wo_q, wo_s, bo))):
        w_s = w_s.reshape(-1)
        check_cuda_tensor(f"w{name}_q", w_q, dev, torch.int8, (d, d))
        check_cuda_tensor(f"w{name}_s", w_s, dev, torch.float32, (d,))
        check_cuda_tensor(f"b{name}", b, dev, bf16, (d,))
        operands += [w_q, w_s, b]
    if B == 0:
        return x.clone()

    import ctypes
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.kernel_function("emr2a_fused_ln_attention_int8",
                                [p] * 22 + [i] * 5 + [ctypes.c_float, p])
    T = B * S
    scratch = [torch.empty((T, d), dtype=torch.int8, device=dev),
               torch.empty((T,), dtype=torch.float32, device=dev),
               torch.empty((3, T, d), dtype=bf16, device=dev),
               torch.empty((T, d), dtype=torch.float32, device=dev),
               torch.empty((T, d), dtype=torch.int8, device=dev),
               torch.empty((T,), dtype=torch.float32, device=dev)]
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(*(t.data_ptr() for t in operands + scratch + [out]),
                 B, S, d, num_heads, valid_len, float(eps), stream)
    _build.check(err, "fused_ln_attention_int8")
    global INT8_LAUNCHES
    INT8_LAUNCHES += 1
    return out
