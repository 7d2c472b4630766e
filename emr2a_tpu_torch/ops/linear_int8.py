"""Streaming W8A8 linear (K5), hand-written for Hopper.

Port of ``emr2a_tpu/ops/linear_int8.py:linear_w8a8``:

    y = ((q8(x) @ w_q) * x_scale) * w_scale + bias       in ``out_dtype``

with ``q8`` the per-row s8 quantize of ``ops/quant.py``, exact s32 sums,
and the rescale and the f32 bias add rounded once each, in that order, as
the TPU kernels' ``_s8_dot`` computes them. The JAX package quantizes
inside the kernel for small T and in a separate XLA pass for large T; the
two give identical codes, so the port has one path for every T (and
``tile_n`` / ``interpret`` have no counterpart). Leading axes are kept:
``x (..., K)`` -> ``(..., N)``.

It serves every quantized projection that the fused blocks do not take:
all six projections of each PubMedBERT layer (masked attention never takes
the fused path), and the ViT blocks without the fused flags.

A CPU tensor goes to ``linear_w8a8_reference``; a CUDA tensor goes to
``csrc/linear_int8.cu`` (bf16 in and out, K % 32 == 0, N % 128 == 0), or
the call raises. ``LAUNCHES`` counts the calls that went to the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from emr2a_tpu_torch.ops import _build
from emr2a_tpu_torch.ops.mlp import GEMM_BN, check_cuda_tensor
from emr2a_tpu_torch.ops.quant import (
    quantize_rows_s8,
    quantize_rows_s8_reference,
    s8_matmul,
)

LAUNCHES = 0
KERNEL_BK = 32   # S8_BK in csrc/gemm_s8.cuh: K must be a multiple of it


def quantize_rows(x: torch.Tensor):
    """(T, K) float -> ((T, K) int8, (T, 1) f32 scales): the same function
    the kernel fuses (``ops/quant.quantize_rows_s8``)."""
    return quantize_rows_s8(x)


def linear_w8a8_reference(x, w_q, w_scale, bias=None,
                          out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of K5, with the TPU kernel's rounding points."""
    *lead, K = x.shape
    N = w_q.shape[1]
    xq, xs = quantize_rows_s8_reference(x.reshape(-1, K))
    y = s8_matmul(xq, w_q) * xs * w_scale.reshape(1, -1).float()
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype).reshape(*lead, N)


def linear_w8a8(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """x (..., K) float, w_q (K, N) int8, w_scale (N,) f32 -> (..., N)."""
    if x.device.type == "cpu":
        return linear_w8a8_reference(x, w_q, w_scale, bias,
                                     out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if out_dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel writes bfloat16, got out_dtype "
                        f"{out_dtype}")
    *lead, K = x.shape
    N = w_q.shape[-1]
    w_scale = w_scale.reshape(-1)
    dev = x.device
    check_cuda_tensor("x", x, dev, torch.bfloat16)
    check_cuda_tensor("w_q", w_q, dev, torch.int8, (K, N))
    check_cuda_tensor("w_scale", w_scale, dev, torch.float32, (N,))
    if bias is not None:
        check_cuda_tensor("bias", bias, dev, torch.bfloat16, (N,))
    if K % KERNEL_BK or N % GEMM_BN:
        raise ValueError(f"the kernel needs K divisible by {KERNEL_BK} and N "
                         f"divisible by {GEMM_BN}, got K={K}, N={N}")
    T = x.numel() // K
    out = torch.empty((*lead, N), dtype=torch.bfloat16, device=dev)
    if T == 0:
        return out

    import ctypes
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.kernel_function("emr2a_linear_w8a8", [p] * 7 + [i] * 3 + [p])
    xq = torch.empty((T, K), dtype=torch.int8, device=dev)
    xs = torch.empty((T,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
                 None if bias is None else bias.data_ptr(), xq.data_ptr(),
                 xs.data_ptr(), out.data_ptr(), T, K, N, stream)
    _build.check(err, "linear_w8a8")
    global LAUNCHES
    LAUNCHES += 1
    return out
