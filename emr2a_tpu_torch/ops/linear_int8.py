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
the call raises. The kernel has two designs, chosen by T: up to 16 rows a
weight-streaming GEMV that quantizes the rows itself (one launch), above
that the row quantize and an s8 wgmma GEMM (two launches). ``LAUNCHES``
counts the calls that went to the kernel. ``launch_linear`` is the host
side both quantized linears share (K7 in ``ops/linear_int4.py``).
"""

from __future__ import annotations

import functools
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
KERNEL_BK = 32        # K must be a multiple of it
GEMV_STRIP = 128      # columns of a GEMV block, one counter each
_workspaces: dict = {}


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


@functools.lru_cache(maxsize=None)
def scratch_bytes(w4: bool, T: int, K: int, N: int, sms: int) -> int:
    """The scratch bytes ``launch_linear`` hands the kernel at (T, K, N)."""
    import ctypes
    fn = _build.library().emr2a_linear_scratch_bytes
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    return int(fn(int(w4), T, K, N, sms))


DEVICE_LAUNCH_KINDS = ("linear_w8a8 GEMV", "linear_w4a8 GEMV", "row quantize",
                       "linear_w8a8 wgmma GEMM", "linear_w4a8 wgmma GEMM")


def device_launches() -> dict:
    """The device launches the two quantized linears' kernel library has
    issued so far, by kind (``DEVICE_LAUNCH_KINDS``): a call of up to 16
    rows is one GEMV launch, a longer one a row quantize and a GEMM."""
    import ctypes
    fn = _build.library().emr2a_linear_launches
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return {kind: int(fn(i)) for i, kind in enumerate(DEVICE_LAUNCH_KINDS)}


def workspace(device: torch.device, stream: int, nbytes: int, strips: int):
    """The scratch (at least ``nbytes``) and the GEMV's per-strip counters
    (at least ``strips``) of the kernels launched on ``stream`` of CUDA
    ``device`` (with its index), kept from call to call: launches on one
    stream run one after another, so each finds its scratch free and the
    counters at zero (the last block of each strip sets its counter back
    to 0). Each stream has its own."""
    key = (device.index, stream)
    ws = _workspaces.get(key)
    if ws is None or ws[0].numel() < nbytes or ws[1].numel() < strips:
        old = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
        ws = (torch.empty((max(nbytes, old[0]),), dtype=torch.int8, device=device),
              torch.zeros((max(strips, old[1], 1024),), dtype=torch.int32, device=device))
        _workspaces[key] = ws
    return ws


def launch_linear(name: str, x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                  bias: Optional[torch.Tensor], out: torch.Tensor, T: int, K: int,
                  N: int) -> None:
    """Call ``emr2a_<name>`` (``linear_w8a8`` or ``linear_w4a8``) on checked
    CUDA operands: x (T, K) bf16, the weights, their scales, the bias or
    None, out (T, N) bf16, with the stream's workspace."""
    import ctypes
    p, i = ctypes.c_void_p, ctypes.c_int
    dev = x.device
    sms = _build.sm_count(dev.index or 0)
    fn = _build.kernel_function("emr2a_" + name, [p] * 7 + [i] * 4 + [p])
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch, counters = workspace(dev, stream, scratch_bytes(name == "linear_w4a8", T, K, N, sms),
                                  N // GEMV_STRIP)
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), w.data_ptr(), w_scale.data_ptr(),
                 None if bias is None else bias.data_ptr(), scratch.data_ptr(),
                 counters.data_ptr(), out.data_ptr(), T, K, N, sms, stream)
    _build.check(err, name)


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

    launch_linear("linear_w8a8", x, w_q, w_scale, bias, out, T, K, N)
    global LAUNCHES
    LAUNCHES += 1
    return out
