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
"""

from __future__ import annotations

import math

import torch

from emr2a_tpu_torch.ops import _build

LAUNCHES = 0

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


def check_cuda_operands(named: dict, device) -> None:
    for name, t in named.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x on {device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16 for the CUDA kernel, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


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
