"""Fused LayerNorm -> MLP -> residual (K1), hand-written for Hopper.

Port of ``emr2a_tpu/ops/mlp.py:fused_ln_mlp`` (Pallas ``_mlp_kernel``):

    y = x + fc2(gelu_tanh(fc1(LN(x))))

``gelu`` (the default) is evaluated in the tanh approximation, as the TPU
kernel does (it has no erf); the other activations of ``models/layers.py``
are accepted by the plain version, the CUDA kernel takes ``gelu`` only.

Rounding points, as in the TPU kernel: LN statistics in f32 and the LN
output rounded to ``x.dtype``; fc1 accumulated in f32, + b1 and the tanh
gelu in f32, the activation rounded to ``x.dtype``; fc2 accumulated in f32,
+ b2 rounded to ``x.dtype``, then the residual add. The unfused blocks in
``models/layers.py`` keep the exact erf gelu.

``fused_ln_mlp`` takes the JAX package's (in, out) weight layout. A CPU
tensor goes to ``fused_ln_mlp_reference``, the plain PyTorch version; a
CUDA tensor goes to the CUDA kernel in ``csrc/mlp.cu`` (bf16 only), or the
call raises. ``LAUNCHES`` counts the calls that went to the kernel.

On the H100 the block is compute-bound at ViT-B (4*T*768*3072 FLOPs); the
kernel is two hand-written tensor-core GEMMs with the LayerNorm fused into
the first one's operand load and bias, gelu and residual fused into the
epilogues. The (T, m) activation still passes through device memory.

The W8A8 variant, K2 (``fused_ln_mlp_int8``, port of
``emr2a_tpu/ops/mlp.py:fused_ln_mlp_int8``), takes int8 weights from
``quantize_weight_int8`` with per-column f32 scales. Rounding points, as in
the TPU kernel: the f32 LN output is quantized per row
(``ops/quant.quantize_rows_s8``); s8 products accumulate exactly;
(acc * row scale) * column scale + b1 and the tanh gelu in f32; the f32
activation is quantized per row, over its whole m-wide row; the second
product rescaled + b2, rounded to ``x.dtype``, then the residual add. A CPU
tensor goes to ``fused_ln_mlp_int8_reference``; a CUDA tensor goes to
``csrc/mlp_int8.cu`` (bf16 activations), or the call raises.
``INT8_LAUNCHES`` counts the calls that went to that kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from emr2a_tpu_torch.ops import _build
from emr2a_tpu_torch.ops.quant import quantize_rows_s8_reference, s8_matmul

LAUNCHES = 0
INT8_LAUNCHES = 0

# column tile of the GEMM in csrc/gemm.cuh: every N (and so every K, which
# is another GEMM's N here) must be a multiple of it
GEMM_BN = 128


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)``."""
    return x * (0.5 * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3))))


def layer_norm_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """LN with f32 statistics (two passes, as the TPU kernels compute
    them); returns f32."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def _kernel_activation(name: str):
    if name == "gelu":
        return gelu_tanh
    from emr2a_tpu_torch.models.layers import ACTIVATIONS
    return ACTIVATIONS[name]


def fused_ln_mlp_reference(x, ln_scale, ln_bias, w1, b1, w2, b2,
                           eps: float = 1e-6,
                           activation: str = "gelu") -> torch.Tensor:
    """Plain PyTorch version of the kernel, with its rounding points:
    products in f32 from ``x.dtype`` operands."""
    h = layer_norm_f32(x, ln_scale, ln_bias, eps).to(x.dtype)
    h1 = torch.matmul(h.float(), w1.float()) + b1.float()
    h1 = _kernel_activation(activation)(h1).to(x.dtype)
    y = torch.matmul(h1.float(), w2.float()) + b2.float()
    return x + y.to(x.dtype)


def check_cuda_tensor(name: str, t: torch.Tensor, device, dtype,
                      shape=None) -> None:
    """Raise unless ``t`` is what a CUDA kernel takes: on ``device``, of
    ``dtype`` (and ``shape``), contiguous and 16-byte aligned."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {str(dtype).split('.')[-1]} for the "
                        f"CUDA kernel, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def check_cuda_operands(named: dict, device) -> None:
    for name, t in named.items():
        check_cuda_tensor(name, t, device, torch.bfloat16)


def fused_ln_mlp(x: torch.Tensor, ln_scale, ln_bias, w1, b1, w2, b2,
                 eps: float = 1e-6, activation: str = "gelu") -> torch.Tensor:
    """x (T, d) -> x + fc2(act(fc1(LN(x)))); w1 (d, m), w2 (m, d)."""
    if x.device.type == "cpu":
        return fused_ln_mlp_reference(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                      eps=eps, activation=activation)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if activation != "gelu":
        raise ValueError(f"the CUDA kernel evaluates gelu only, got "
                         f"{activation!r}")
    if x.dim() != 2:
        raise ValueError(f"x must be (T, d), got {tuple(x.shape)}")
    T, d = x.shape
    m = w1.shape[-1]
    expect = {"ln_scale": (d,), "ln_bias": (d,), "w1": (d, m), "b1": (m,),
              "w2": (m, d), "b2": (d,)}
    named = {"x": x, "ln_scale": ln_scale, "ln_bias": ln_bias, "w1": w1,
             "b1": b1, "w2": w2, "b2": b2}
    for name, shape in expect.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(named[name].shape)}, "
                             f"expected {shape}")
    check_cuda_operands(named, x.device)
    if d % GEMM_BN or m % GEMM_BN:
        raise ValueError(f"the kernel needs d and m divisible by {GEMM_BN}, "
                         f"got d={d}, m={m}")
    if T == 0:
        return x.clone()

    fn = _build.kernel_function("emr2a_fused_ln_mlp", _argtypes())
    h1 = torch.empty((T, m), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
                 w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                 h1.data_ptr(), out.data_ptr(), T, d, m, float(eps), stream)
    _build.check(err, "fused_ln_mlp")
    global LAUNCHES
    LAUNCHES += 1
    return out


def _argtypes():
    import ctypes
    p, i = ctypes.c_void_p, ctypes.c_int
    return [p] * 9 + [i, i, i, ctypes.c_float, p]


# ---------------------------------------------------------------------------
# W8A8 (K2)
# ---------------------------------------------------------------------------

def quantize_weight_int8(w) -> tuple:
    """(K, N) float weights -> (int8 codes, (1, N) f32 column scales), in
    numpy: ``emr2a_tpu/ops/mlp.py:quantize_weight_int8``. Its recipe differs
    from the row recipe: divide amax by 127 first, then floor at 1e-12,
    then ``rint(w / scale)``."""
    w = np.asarray(w, np.float32)
    scale = np.abs(w).max(axis=0, keepdims=True) / 127.0
    scale = np.maximum(scale, 1e-12)
    q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def fused_ln_mlp_int8_reference(x, ln_scale, ln_bias, w1_q, w1_scale, b1,
                                w2_q, w2_scale, b2, eps: float = 1e-6,
                                activation: str = "gelu") -> torch.Tensor:
    """Plain PyTorch version of K2, with the TPU kernel's rounding points."""
    h = layer_norm_f32(x, ln_scale, ln_bias, eps)
    q1, s1 = quantize_rows_s8_reference(h)
    h1 = (s8_matmul(q1, w1_q) * s1 * w1_scale.reshape(1, -1).float()
          + b1.float())
    h1 = _kernel_activation(activation)(h1)
    q2, s2 = quantize_rows_s8_reference(h1)
    y = (s8_matmul(q2, w2_q) * s2 * w2_scale.reshape(1, -1).float()
         + b2.float())
    return x + y.to(x.dtype)


def fused_ln_mlp_int8(x: torch.Tensor, ln_scale, ln_bias, w1_q, w1_scale, b1,
                      w2_q, w2_scale, b2, eps: float = 1e-6,
                      activation: str = "gelu") -> torch.Tensor:
    """x (T, d) -> x + fc2(act(fc1(LN(x)))) in W8A8; w1_q (d, m) and w2_q
    (m, d) int8, scales (m,) and (d,) f32 (or (1, N))."""
    if x.device.type == "cpu":
        return fused_ln_mlp_int8_reference(
            x, ln_scale, ln_bias, w1_q, w1_scale, b1, w2_q, w2_scale, b2,
            eps=eps, activation=activation)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if activation != "gelu":
        raise ValueError(f"the CUDA kernel evaluates gelu only, got "
                         f"{activation!r}")
    if x.dim() != 2:
        raise ValueError(f"x must be (T, d), got {tuple(x.shape)}")
    T, d = x.shape
    m = w1_q.shape[-1]
    w1_scale, w2_scale = w1_scale.reshape(-1), w2_scale.reshape(-1)
    bf16, dev = torch.bfloat16, x.device
    for name, t, dtype, shape in (
            ("x", x, bf16, (T, d)), ("ln_scale", ln_scale, bf16, (d,)),
            ("ln_bias", ln_bias, bf16, (d,)),
            ("w1_q", w1_q, torch.int8, (d, m)),
            ("w1_scale", w1_scale, torch.float32, (m,)), ("b1", b1, bf16, (m,)),
            ("w2_q", w2_q, torch.int8, (m, d)),
            ("w2_scale", w2_scale, torch.float32, (d,)), ("b2", b2, bf16, (d,))):
        check_cuda_tensor(name, t, dev, dtype, shape)
    if d % GEMM_BN or m % GEMM_BN:
        raise ValueError(f"the kernel needs d and m divisible by {GEMM_BN}, "
                         f"got d={d}, m={m}")
    if T == 0:
        return x.clone()

    import ctypes
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.kernel_function("emr2a_fused_ln_mlp_int8",
                                [p] * 15 + [i, i, i, ctypes.c_float, p])
    hq = torch.empty((T, d), dtype=torch.int8, device=dev)
    hs = torch.empty((T,), dtype=torch.float32, device=dev)
    h1 = torch.empty((T, m), dtype=torch.float32, device=dev)
    q2 = torch.empty((T, m), dtype=torch.int8, device=dev)
    s2 = torch.empty((T,), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(*(t.data_ptr() for t in (
            x, ln_scale, ln_bias, w1_q, w1_scale, b1, w2_q, w2_scale, b2,
            hq, hs, h1, q2, s2, out)), T, d, m, float(eps), stream)
    _build.check(err, "fused_ln_mlp_int8")
    global INT8_LAUNCHES
    INT8_LAUNCHES += 1
    return out
