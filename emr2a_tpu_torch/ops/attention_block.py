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
"""

from __future__ import annotations

from typing import Optional

import torch

from emr2a_tpu_torch.ops import _build
from emr2a_tpu_torch.ops.mlp import GEMM_BN, check_cuda_operands, layer_norm_f32

NEG_INF = -1e30
KERNEL_HEAD_DIM = 64
KERNEL_MAX_SEQ = 384   # ATT_MAX_SP in csrc/attention_block.cu

LAUNCHES = 0


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
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
    if valid_len < S:
        mask = torch.where(torch.arange(S, device=x.device) < valid_len,
                           0.0, NEG_INF).to(torch.float32)
        logits = logits + mask
    probs = torch.softmax(logits, dim=-1).to(x.dtype).float()
    attn = torch.einsum("bhqk,bkhd->bqhd", probs, v).to(x.dtype)
    y = torch.matmul(attn.reshape(B, S, d).float(), wo.float()) + bo.float()
    return x + y.to(x.dtype)


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


def _argtypes():
    import ctypes
    p, i = ctypes.c_void_p, ctypes.c_int
    return [p] * 14 + [i] * 5 + [ctypes.c_float, p]
