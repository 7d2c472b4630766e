"""Streaming W4A8 linear (K7), hand-written for Hopper.

Port of ``emr2a_tpu/ops/linear_int4.py``:

    y = ((sum_g f32(acc_g) * w_scale[g]) * x_scale + bias)      in ``out_dtype``

with ``acc_g`` the exact s32 sum over group ``g`` of the row-quantized
activations (``ops/quant.py``) times the unpacked 4-bit weights, and the f32
sum over groups taken in group order, the rounding points of the TPU
kernel's ``_w4_dot``. (K5 rounds ``acc * x_scale * w_scale`` instead.)

- ``quantize_weight_int4`` is the JAX package's numpy recipe (byte-identical
  packing and scales); ``quantize_weight_int4_torch`` is its twin on any
  torch device, which gives the same bytes: a true division by a tensor, the
  1e-12 floor, then ``round`` (half to even) of a true division.
- ``linear_w4a8_reference`` is the plain version. ``linear_w4a8`` takes a
  CPU tensor there; a CUDA tensor goes to ``csrc/linear_int4.cu`` (bf16 in
  and out, group 128, K and N divisible by 128) or the call raises. The
  kernel is bit-identical to the plain version: up to 16 rows one launch (a
  GEMV that quantizes the rows itself), above that the row quantize and an
  s8 wgmma GEMM. The JAX package's tile
  choice (``tile_n``, ``_pick_tiles_w4``) and ``interpret`` have no
  counterpart. ``LAUNCHES`` counts the calls that went to the kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from emr2a_tpu_torch.ops.linear_int8 import launch_linear
from emr2a_tpu_torch.ops.mlp import check_cuda_tensor
from emr2a_tpu_torch.ops.quant import quantize_rows_s8_reference

LAUNCHES = 0
KERNEL_GROUP = 128     # W4_GROUP in csrc/linear_int4.cu
KERNEL_BN = 128        # W4_BN: N must be a multiple of it


def int4_group(K: int, target: int = 128) -> int:
    """The largest even divisor of K up to ``target``: the group
    ``models/quantize`` quantizes a (K, N) kernel with (128 at every real
    width; tiny test widths take a smaller one, which only the plain
    version takes). ``emr2a_tpu/models/quantize.py:_int4_group``."""
    for g in range(min(target, K), 1, -1):
        if K % g == 0 and g % 2 == 0:
            return g
    raise ValueError(f"no even group divides K={K}")


def quantize_weight_int4(w, group: int = 128):
    """(K, N) float -> (packed (K//2, N) int8, (K//group, N) f32 scales), in
    numpy: ``emr2a_tpu/ops/linear_int4.py:quantize_weight_int4``.

    Group-wise symmetric RTN to [-7, 7]. Byte row ``g*group/2 + r`` holds
    (low nibble) row ``g*group + r`` and (high nibble) row
    ``g*group + group/2 + r``."""
    w = np.asarray(w, np.float32)
    K, N = w.shape
    if K % group:
        raise ValueError(f"K={K} not divisible by group={group}")
    h = group // 2
    wg = w.reshape(K // group, group, N)
    scale = np.abs(wg).max(axis=1, keepdims=True) / 7.0
    scale = np.maximum(scale, 1e-12)
    q = np.clip(np.rint(wg / scale), -7, 7).astype(np.int8)
    lo = q[:, :h, :]
    hi = q[:, h:, :]
    packed = ((hi.astype(np.uint8) << 4) | (lo.astype(np.uint8) & 0xF))
    packed = packed.astype(np.int8).reshape(K // 2, N)
    return packed, scale.reshape(K // group, N).astype(np.float32)


def quantize_weight_int4_torch(w: torch.Tensor, group: int = 128):
    """``quantize_weight_int4`` on ``w``'s device, in torch: the same bytes
    and scales. Every division is a true division by a tensor (a CUDA
    division by a Python scalar multiplies by the reciprocal and can miss
    by one bit)."""
    K, N = w.shape
    if K % group:
        raise ValueError(f"K={K} not divisible by group={group}")
    h = group // 2
    wg = w.float().reshape(K // group, group, N)
    amax = wg.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp(amax / torch.full_like(amax, 7.0), min=1e-12)
    q = torch.clamp(torch.round(wg / scale), -7, 7).to(torch.int8)
    lo = q[:, :h, :].view(torch.uint8)
    hi = q[:, h:, :].view(torch.uint8)
    packed = torch.bitwise_or(torch.bitwise_left_shift(hi, 4),
                              torch.bitwise_and(lo, 0xF))
    return (packed.view(torch.int8).reshape(K // 2, N),
            scale.reshape(K // group, N))


def unpack_int4(w_p: torch.Tensor, group: int) -> torch.Tensor:
    """(K//2, N) packed -> (K, N) int8 in [-7, 7], rows in their original
    order."""
    Kh, N = w_p.shape
    h = group // 2
    b = w_p.to(torch.int32)
    high = torch.bitwise_right_shift(b, 4)                # sign-extends
    low = torch.bitwise_xor(torch.bitwise_and(b, 0xF), 8) - 8
    n_groups = 2 * Kh // group
    return torch.cat([low.reshape(n_groups, h, N), high.reshape(n_groups, h, N)],
                     dim=1).reshape(2 * Kh, N).to(torch.int8)


def _group_of(K: int, w_p: torch.Tensor, w_scale: torch.Tensor) -> int:
    if K != 2 * w_p.shape[0]:
        raise ValueError(f"x K={K} vs packed rows {w_p.shape[0]}")
    n_groups = w_scale.shape[0]
    if K % n_groups or (K // n_groups) % 2:
        raise ValueError(f"K={K} not an even multiple of {n_groups} groups")
    return K // n_groups


def linear_w4a8_reference(x, w_p, w_scale, bias=None,
                          out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of K7, with the TPU kernel's rounding points:
    exact s32 group sums (f64 products hold them exactly), ``y + f32(acc) *
    w_scale[g]`` in group order, then ``* x_scale``, then ``+ bias``."""
    *lead, K = x.shape
    group = _group_of(K, w_p, w_scale)
    N = w_p.shape[1]
    xq, xs = quantize_rows_s8_reference(x.reshape(-1, K))
    w = unpack_int4(w_p, group).double()
    ws = w_scale.float()
    xd = xq.double()
    y = torch.zeros((xq.shape[0], N), dtype=torch.float32, device=x.device)
    for g in range(K // group):
        sl = slice(g * group, (g + 1) * group)
        acc = torch.matmul(xd[:, sl], w[sl]).float()
        y = y + acc * ws[g]
    y = y * xs
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype).reshape(*lead, N)


def linear_w4a8(x: torch.Tensor, w_p: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """x (..., K) float, w_p (K//2, N) packed int4, w_scale (K//group, N) f32
    -> (..., N). The group is ``K // w_scale.shape[0]``."""
    if x.device.type == "cpu":
        return linear_w4a8_reference(x, w_p, w_scale, bias, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if out_dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel writes bfloat16, got out_dtype "
                        f"{out_dtype}")
    *lead, K = x.shape
    N = w_p.shape[-1]
    group = _group_of(K, w_p, w_scale)
    if group != KERNEL_GROUP or N % KERNEL_BN:
        raise ValueError(f"the kernel needs group {KERNEL_GROUP} and N "
                         f"divisible by {KERNEL_BN}, got group {group}, N={N}")
    dev = x.device
    check_cuda_tensor("x", x, dev, torch.bfloat16)
    check_cuda_tensor("w_p", w_p, dev, torch.int8, (K // 2, N))
    check_cuda_tensor("w_scale", w_scale, dev, torch.float32, (K // group, N))
    if bias is not None:
        check_cuda_tensor("bias", bias, dev, torch.bfloat16, (N,))
    T = x.numel() // K
    out = torch.empty((*lead, N), dtype=torch.bfloat16, device=dev)
    if T == 0:
        return out

    launch_linear("linear_w4a8", x, w_p, w_scale, bias, out, T, K, N)
    global LAUNCHES
    LAUNCHES += 1
    return out
