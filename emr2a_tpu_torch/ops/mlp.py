"""Fused LayerNorm -> MLP -> residual (K1), hand-written for Hopper.

Port of ``emr2a_tpu/ops/mlp.py:fused_ln_mlp`` (Pallas ``_mlp_kernel``):

    y = x + fc2(gelu_tanh(fc1(LN(x))))

``gelu`` (the default) is evaluated in the tanh approximation, as the TPU
kernel does (it has no erf); the other activations of ``models/layers.py``
are accepted by the plain version, the CUDA kernel takes those of
``CUDA_ACTIVATIONS``: ``gelu`` and CLIP's ``quick_gelu`` (x * sigmoid(1.702
x)). Any other activation raises on a CUDA tensor.

Rounding points, as in the TPU kernel: LN statistics in f32 and the LN
output rounded to ``x.dtype``; fc1 accumulated in f32, + b1 and the tanh
gelu in f32, the activation rounded to ``x.dtype``; fc2 accumulated in f32,
+ b2 rounded to ``x.dtype``, then the residual add. The unfused blocks in
``models/layers.py`` keep the exact erf gelu.

``fused_ln_mlp`` takes the JAX package's (in, out) weight layout. A CPU
tensor goes to ``fused_ln_mlp_reference``, the plain PyTorch version; a
CUDA tensor goes to the CUDA kernel in ``csrc/mlp.cu`` (bf16 only), or the
call raises. ``LAUNCHES`` counts the calls that went to the kernel.

On the H100 the block is bound by the tensor cores at ViT-B
(4*T*768*3072 operations); the kernel is a LayerNorm row pass and two
TMA-fed wgmma GEMMs (``csrc/gemm.cuh``) with bias, gelu and residual fused
into their epilogues. The LN output and the (T, m) activation pass through
device memory (the output buffer and the ``h1`` scratch).

The W8A8 variant, K2 (``fused_ln_mlp_int8``, port of
``emr2a_tpu/ops/mlp.py:fused_ln_mlp_int8``), takes int8 weights from
``quantize_weight_int8`` with per-column f32 scales. Rounding points, as in
the TPU kernel: the f32 LN output (its statistics from exact row sums,
``layer_norm_exact_stats``) is quantized per row
(``ops/quant.quantize_rows_s8``); s8 products accumulate exactly;
(acc * row scale) * column scale + b1 and the tanh gelu in f32; the f32
activation is quantized per row, over its whole m-wide row; the second
product rescaled + b2, rounded to ``x.dtype``, then the residual add. A CPU
tensor goes to ``fused_ln_mlp_int8_reference``; a CUDA tensor goes to
``csrc/mlp_int8.cu`` (bf16 activations), or the call raises.
``INT8_LAUNCHES`` counts the calls that went to that kernel.

Both take JAX's keywords ``tile`` and ``act_dtype``. ``tile`` is the TPU
kernel's token tile in VMEM; it has no counterpart here and is ignored.
``act_dtype=torch.bfloat16`` (JAX's ``jnp.bfloat16``) moves the rounding
points of the activation: K1 rounds fc1 + b1 to bf16 and evaluates the
gelu on that bf16 value, rounded to ``x.dtype``; K2 evaluates the gelu of
bf16(fc1 value) and carries it back to f32 before the row quantize. The
bf16 gelu is evaluated as XLA evaluates ``jax.nn.gelu`` on a bf16 array
(``gelu_tanh_bf16``): the constants rounded to bf16, every op computed in
f32 and rounded to bf16, but the last product, which is exact in f32 and
is rounded to the output type (XLA elides that rounding when the result is
converted to f32 next). On the JAX package's CPU interpret mode this gives
its values bit for bit on the same bf16 input (``tests/test_torch_act_dtype.py``
holds 400,000 values exactly); through the whole block the two differ only
by the products' summation order, which may move a value across a bf16
rounding boundary (``tests/test_torch_act_dtype.py``: bit for bit in bf16 on
its inputs, atol 2e-3 in f32). The card's kernels evaluate the same sequence
(``csrc/common.cuh``; ``chip_smoke.py`` holds their gelu epilogues to
``gelu_tanh_bf16`` bit for bit on the same 400,000 values).

``quick_gelu`` in bf16 (``quick_gelu_bf16``) is XLA's evaluation of ``v *
jax.nn.sigmoid(1.702 * v)`` on a bf16 array: the constant rounded to bf16
(1.703125), the logistic expanded as 1 / (1 + exp(-x)) with each op
computed in f32 and rounded to bf16, and the last product left to the
caller's rounding (``tests/test_torch_encoders_zoo.py`` holds it to XLA bit
for bit on 400,000 values). In f32 it is ``x * torch.sigmoid(1.702 x)``,
within a few f32 ulp of XLA's. The card's epilogues evaluate the same
sequences (``quick_gelu``, ``quick_gelu_bf16`` in ``csrc/common.cuh``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from emr2a_tpu_torch.ops import _build
from emr2a_tpu_torch.ops.quant import quantize_rows_s8_reference, s8_matmul

LAUNCHES = 0
INT8_LAUNCHES = 0

# the narrower column tile of the GEMMs in csrc/gemm.cuh: every N (and so
# every K, which is another GEMM's N here) must be a multiple of it
GEMM_BN = 128


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)``."""
    return x * (0.5 * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3))))


def gelu_tanh_bf16(v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(v, approximate=True)`` of bf16 values (given in any
    float type) as XLA evaluates it in bf16: returns f32, whose only
    rounding left is the caller's cast to the output type."""
    r = lambda t: t.to(torch.bfloat16).float()
    v = r(v)
    c = r(v * v)
    c = r(c * v)
    c = r(c * _BF16_K1)
    c = r(v + c)
    c = r(c * _BF16_K0)
    c = r(torch.tanh(c))
    c = r(c + 1.0)
    c = r(c * 0.5)
    return v * c


# the constants of jax.nn.gelu(approximate=True) rounded to bf16
_BF16_K0 = 0.796875          # sqrt(2 / pi)
_BF16_K1 = 0.044677734375    # 0.044715


def quick_gelu_bf16(v: torch.Tensor) -> torch.Tensor:
    """``v * jax.nn.sigmoid(1.702 * v)`` of bf16 values (given in any float
    type) as XLA evaluates it in bf16: returns f32, whose only rounding
    left is the caller's cast to the output type."""
    r = lambda t: t.to(torch.bfloat16).float()
    v = r(v)
    c = r(v * _BF16_QUICK)
    c = r(torch.exp(-c))
    c = r(1.0 + c)
    c = r(1.0 / c)
    return v * c


_BF16_QUICK = 1.703125       # 1.702 rounded to bf16

ACT_DTYPES = (torch.float32, torch.bfloat16)
# the activations the CUDA kernels evaluate in their fc1 epilogue, and
# their flag bit (bit 0 of the kernels' flags is the bf16 act_dtype)
CUDA_ACTIVATIONS = {"gelu": 0, "quick_gelu": 2}


def _activate(h: torch.Tensor, activation: str, act_dtype) -> torch.Tensor:
    """The f32 value ``h`` through the activation evaluated in
    ``act_dtype``; f32 out."""
    if act_dtype not in ACT_DTYPES:
        raise ValueError(f"act_dtype must be one of {ACT_DTYPES}, got {act_dtype}")
    if act_dtype == torch.float32:
        return _kernel_activation(activation)(h)
    if activation == "gelu":
        return gelu_tanh_bf16(h)
    if activation == "quick_gelu":
        return quick_gelu_bf16(h)
    return _kernel_activation(activation)(h.to(torch.bfloat16)).float()


def layer_norm_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """LN with f32 statistics (two passes, as the TPU kernels compute
    them); returns f32."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def layer_norm_exact_stats(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                           eps: float) -> torch.Tensor:
    """LN in f32 as the int8 blocks' row pass computes it (``csrc/quant.cuh``),
    bit for bit; returns f32. The statistics come from the row's sum and sum
    of squares in f64, exact for bf16 rows, so they do not depend on the
    order of the sums: mu = f32(sum / K), var = f32(sumsq / K - (sum / K)^2)
    and rstd = 1 / sqrt(var + eps) in f32, each rounded once. Statistics
    that differ by an ulp move a code at a half-way point of the row
    quantize that follows. The divisor is a tensor: a division by a Python
    number may be done as a multiply by its reciprocal."""
    xf, xd = x.float(), x.double()
    k = xd.new_full((), x.shape[-1])
    m = xd.sum(dim=-1, keepdim=True) / k
    var = ((xd * xd).sum(dim=-1, keepdim=True) / k - m * m).float()
    rstd = torch.sqrt(var + eps).reciprocal()
    return (xf - m.float()) * rstd * scale.float() + bias.float()


def _kernel_activation(name: str):
    if name == "gelu":
        return gelu_tanh
    from emr2a_tpu_torch.models.layers import ACTIVATIONS
    return ACTIVATIONS[name]


def fused_ln_mlp_reference(x, ln_scale, ln_bias, w1, b1, w2, b2,
                           eps: float = 1e-6, activation: str = "gelu",
                           tile: int = 512,
                           act_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with its rounding points:
    products in f32 from ``x.dtype`` operands. ``tile`` is ignored."""
    h = layer_norm_f32(x, ln_scale, ln_bias, eps).to(x.dtype)
    h1 = torch.matmul(h.float(), w1.float()) + b1.float()
    h1 = _activate(h1, activation, act_dtype).to(x.dtype)
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
                 eps: float = 1e-6, activation: str = "gelu", tile: int = 512,
                 act_dtype=torch.float32) -> torch.Tensor:
    """x (T, d) -> x + fc2(act(fc1(LN(x)))); w1 (d, m), w2 (m, d).
    ``tile`` (a TPU VMEM knob) is ignored; ``act_dtype`` is float32 or
    bfloat16 (module docstring)."""
    if x.device.type == "cpu":
        return fused_ln_mlp_reference(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                      eps=eps, activation=activation,
                                      act_dtype=act_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if act_dtype not in ACT_DTYPES:
        raise ValueError(f"act_dtype must be one of {ACT_DTYPES}, got {act_dtype}")
    act = _cuda_act_flags(activation, act_dtype)
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
                 h1.data_ptr(), out.data_ptr(), T, d, m, act, float(eps), stream)
    _build.check(err, "fused_ln_mlp")
    global LAUNCHES
    LAUNCHES += 1
    return out


def _cuda_act_flags(activation: str, act_dtype) -> int:
    """The kernels' activation flags, or raise for an activation they do
    not evaluate."""
    if activation not in CUDA_ACTIVATIONS:
        raise ValueError(f"the CUDA kernel evaluates {sorted(CUDA_ACTIVATIONS)} "
                         f"only, got {activation!r}")
    return CUDA_ACTIVATIONS[activation] | int(act_dtype == torch.bfloat16)


def _argtypes():
    import ctypes
    p, i = ctypes.c_void_p, ctypes.c_int
    return [p] * 9 + [i, i, i, i, ctypes.c_float, p]


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
                                activation: str = "gelu", tile: int = 256,
                                act_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of K2, with the TPU kernel's rounding points.
    ``tile`` is ignored."""
    h = layer_norm_exact_stats(x, ln_scale, ln_bias, eps)
    q1, s1 = quantize_rows_s8_reference(h)
    h1 = (s8_matmul(q1, w1_q) * s1 * w1_scale.reshape(1, -1).float()
          + b1.float())
    h1 = _activate(h1, activation, act_dtype)
    q2, s2 = quantize_rows_s8_reference(h1)
    y = (s8_matmul(q2, w2_q) * s2 * w2_scale.reshape(1, -1).float()
         + b2.float())
    return x + y.to(x.dtype)


def fused_ln_mlp_int8(x: torch.Tensor, ln_scale, ln_bias, w1_q, w1_scale, b1,
                      w2_q, w2_scale, b2, eps: float = 1e-6,
                      activation: str = "gelu", tile: int = 256,
                      act_dtype=torch.float32) -> torch.Tensor:
    """x (T, d) -> x + fc2(act(fc1(LN(x)))) in W8A8; w1_q (d, m) and w2_q
    (m, d) int8, scales (m,) and (d,) f32 (or (1, N)). ``tile`` (a TPU
    VMEM knob) is ignored; ``act_dtype`` is float32 or bfloat16."""
    if x.device.type == "cpu":
        return fused_ln_mlp_int8_reference(
            x, ln_scale, ln_bias, w1_q, w1_scale, b1, w2_q, w2_scale, b2,
            eps=eps, activation=activation, act_dtype=act_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if act_dtype not in ACT_DTYPES:
        raise ValueError(f"act_dtype must be one of {ACT_DTYPES}, got {act_dtype}")
    act = _cuda_act_flags(activation, act_dtype)
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
                                [p] * 15 + [i, i, i, i, ctypes.c_float, p])
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
            hq, hs, h1, q2, s2, out)), T, d, m, act, float(eps), stream)
    _build.check(err, "fused_ln_mlp_int8")
    global INT8_LAUNCHES
    INT8_LAUNCHES += 1
    return out
