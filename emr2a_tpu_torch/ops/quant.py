"""The per-row symmetric s8 activation quantize of every W8A8 path.

Port of ``emr2a_tpu/ops/quant.py:quantize_rows_s8``:

    scale = max(amax(|row|), 1e-12) * (1/127)       f32
    codes = clip(round_half_even(x * (1 / scale)), -127, 127)

The codes are bit-identical to the JAX package's: the floor comes before
the multiply by 1/127, ``1/scale`` is a reciprocal followed by a multiply,
and ``torch.round`` rounds half to even. The weight recipe
(``ops/mlp.quantize_weight_int8``) is another one.

``quantize_rows_s8`` takes a CPU tensor to ``quantize_rows_s8_reference``,
the plain version; a CUDA tensor (bf16 or f32, 2-D) goes to the row pass of
``csrc/quant.cuh`` (through ``csrc/linear_int8.cu``), or the call raises.
The same row pass runs inside the K2, K4 and K5 kernels. ``LAUNCHES``
counts the calls that went to the kernel.
"""

from __future__ import annotations

import torch

from emr2a_tpu_torch.ops import _build

LAUNCHES = 0
INV127 = 1.0 / 127.0


def quantize_rows_s8_reference(x: torch.Tensor):
    """(..., K) float -> ((..., K) int8 codes, (..., 1) f32 scales)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) * INV127
    q = torch.clamp(torch.round(xf * torch.reciprocal(scale)), -127, 127)
    return q.to(torch.int8), scale


def s8_matmul(q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) f32: the exact s32 sums (f64
    products hold them exactly), rounded to f32 as the kernels convert
    their accumulators."""
    return torch.matmul(q.double(), w_q.double()).float()


def quantize_rows_s8(x: torch.Tensor):
    """(rows, K) -> ((rows, K) int8, (rows, 1) f32); any leading axes on
    the CPU."""
    if x.device.type == "cpu":
        return quantize_rows_s8_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be (rows, K), got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bfloat16 or float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    rows, K = x.shape
    if K % 8 or x.data_ptr() % 16:
        raise ValueError(f"the kernel needs K divisible by 8 and 16-byte "
                         f"aligned rows, got K={K}")
    q = torch.empty((rows, K), dtype=torch.int8, device=x.device)
    scale = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    if rows == 0:
        return q, scale
    import ctypes
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.kernel_function("emr2a_quantize_rows", [p, i, p, p, i, i, p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), int(x.dtype == torch.float32), q.data_ptr(),
                 scale.data_ptr(), rows, K, stream)
    _build.check(err, "quantize_rows_s8")
    global LAUNCHES
    LAUNCHES += 1
    return q, scale
