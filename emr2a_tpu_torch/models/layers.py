"""Transformer building blocks as ``nn.Module``s.

Port of ``emr2a_tpu/models/layers.py``. Dense projections keep the JAX
package's (in, out) ``kernel`` layout (``Dense``), so the fused kernels take
the module's weights as they are, with no transpose per call.

Routing of ``TransformerBlock``: with ``fused_attn`` / ``fused_mlp`` set, a
3-D input goes through the fused ops (``ops/attention_block.py``,
``ops/mlp.py``) whenever the attention has no external mask and has q/k/v
biases, the conditions of ``emr2a_tpu/models/layers.py:145-146``. The JAX
package also gates on a model of the TPU's VMEM; the port has no such gate,
so these shapes route differently:

- d=1024, mlp 4096 (ViT-L class) bf16 MLP: JAX runs the unfused einsum MLP
  (exact erf gelu, weights over its VMEM budget); the port runs the fused
  op (tanh gelu).
- ViT-L/14 at 336 px (S=577) attention: JAX runs the einsum path; the port
  sends it to the fused op, whose CUDA kernel takes sequences up to 384
  and raises there.
- On the CPU every shape with the flag set takes the fused op's plain
  version, whatever its size.

W8A8 params are routed by what they hold, as the JAX package's
``_QuantRoutingModule`` does: ``load_params`` replaces every ``Dense`` whose
state arrives as ``kernel_q`` / ``kernel_scale`` (``models/quantize.py``)
with an ``Int8Dense``, which runs the streaming W8A8 op (K5,
``ops/linear_int8.py``). A ``TransformerBlock`` whose projections are
``Int8Dense`` takes the W8A8 fused ops (K4, K2) under the flags, and K5
through ``MultiHeadAttention`` / ``Mlp`` without them, as
``emr2a_tpu/models/layers.py:164-265`` does.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from emr2a_tpu_torch.ops.attention_block import (
    fused_ln_attention,
    fused_ln_attention_int8,
)
from emr2a_tpu_torch.ops.linear_int8 import linear_w8a8
from emr2a_tpu_torch.ops.mlp import fused_ln_mlp, fused_ln_mlp_int8


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's approximate GELU: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


ACTIVATIONS: dict[str, Callable] = {
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "quick_gelu": quick_gelu,
    "relu": F.relu,
    "silu": F.silu,
}


class Dense(nn.Module):
    """``flax.linen.Dense``: y = x @ kernel + bias with kernel (in, out)."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features,
                                               dtype=dtype, device=device))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(out_features, dtype=dtype,
                                                 device=device))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.to(self.kernel.dtype), self.kernel)
        if self.bias is not None:
            y = y + self.bias
        return y


class Int8Dense(nn.Module):
    """A ``Dense`` held in W8A8: ``kernel_q`` int8 (in, out) and
    ``kernel_scale`` f32 (out,) buffers, the JAX package's layout and names,
    and a bias in the working dtype. Runs ``linear_w8a8`` (K5), whose output
    is in the working dtype."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("kernel_q", torch.zeros(
            in_features, out_features, dtype=torch.int8, device=device))
        self.register_buffer("kernel_scale", torch.ones(
            out_features, dtype=torch.float32, device=device))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(out_features, dtype=dtype,
                                                 device=device))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear_w8a8(x.contiguous(), self.kernel_q, self.kernel_scale,
                           self.bias, out_dtype=self.dtype)


def load_params(module: nn.Module, state: Mapping[str, torch.Tensor]
                ) -> nn.Module:
    """``module.load_state_dict(state)`` after replacing every ``Dense``
    whose kernel arrives quantized (``<name>.kernel_q`` in ``state``) with an
    ``Int8Dense`` of the same shape and dtype."""
    for name, sub in list(module.named_modules()):
        if isinstance(sub, Dense) and f"{name}.kernel_q" in state:
            parent, _, leaf = name.rpartition(".")
            setattr(module.get_submodule(parent), leaf, Int8Dense(
                *sub.kernel.shape, use_bias=sub.bias is not None,
                dtype=sub.kernel.dtype, device=sub.kernel.device))
    module.load_state_dict(state)
    return module


class MultiHeadAttention(nn.Module):
    """MHA with separate q/k/v/out projections and an optional additive
    mask; logits and softmax in f32, probabilities in the working dtype."""

    def __init__(self, hidden_size: int, num_heads: int,
                 qkv_bias: bool = True, out_bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden {hidden_size} not divisible by "
                             f"num_heads {num_heads}")
        self.num_heads = num_heads
        kw = dict(dtype=dtype, device=device)
        self.q_proj = Dense(hidden_size, hidden_size, qkv_bias, **kw)
        self.k_proj = Dense(hidden_size, hidden_size, qkv_bias, **kw)
        self.v_proj = Dense(hidden_size, hidden_size, qkv_bias, **kw)
        self.out_proj = Dense(hidden_size, hidden_size, out_bias, **kw)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, S, d = x.shape
        hd = d // self.num_heads
        shape = (B, S, self.num_heads, hd)
        q = self.q_proj(x).reshape(shape)
        k = self.k_proj(x).reshape(shape)
        v = self.v_proj(x).reshape(shape)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd ** -0.5
        if mask is not None:
            logits = logits + mask
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, d)
        return self.out_proj(out)


class Mlp(nn.Module):

    def __init__(self, hidden_size: int, mlp_dim: int,
                 activation: str = "gelu", dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.activation = activation
        self.fc1 = Dense(hidden_size, mlp_dim, dtype=dtype, device=device)
        self.fc2 = Dense(mlp_dim, hidden_size, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(ACTIVATIONS[self.activation](self.fc1(x)))


class TransformerBlock(nn.Module):
    """Pre-LN block: x + attn(ln1(x)); x + mlp(ln2(x)).

    ``fused_attn`` / ``fused_mlp`` route each half through its fused op
    (see the module docstring); the fused MLP evaluates gelu in the tanh
    approximation. ``valid_len`` (a forward argument) marks the rows that
    are real when the caller keeps its token axis pre-padded: later rows
    are masked as keys and are junk as outputs.
    """

    def __init__(self, hidden_size: int, num_heads: int, mlp_dim: int,
                 activation: str = "gelu", ln_eps: float = 1e-5,
                 qkv_bias: bool = True, fused_mlp: bool = False,
                 fused_attn: bool = False, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        self.ln_eps = ln_eps
        self.qkv_bias = qkv_bias
        self.fused_mlp = fused_mlp
        self.fused_attn = fused_attn
        kw = dict(dtype=dtype, device=device)
        self.ln1 = nn.LayerNorm(hidden_size, eps=ln_eps, **kw)
        self.attn = MultiHeadAttention(hidden_size, num_heads,
                                       qkv_bias=qkv_bias, **kw)
        self.ln2 = nn.LayerNorm(hidden_size, eps=ln_eps, **kw)
        self.mlp = Mlp(hidden_size, mlp_dim, activation=activation, **kw)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                valid_len: Optional[int] = None) -> torch.Tensor:
        a = self.attn
        if self.fused_attn and x.dim() == 3 and mask is None and self.qkv_bias:
            projs = (a.q_proj, a.k_proj, a.v_proj, a.out_proj)
            if isinstance(a.q_proj, Int8Dense):
                x = fused_ln_attention_int8(
                    x, self.ln1.weight, self.ln1.bias,
                    *(t for p in projs
                      for t in (p.kernel_q, p.kernel_scale, p.bias)),
                    num_heads=self.num_heads, eps=self.ln_eps,
                    valid_len=valid_len)
            else:
                x = fused_ln_attention(
                    x, self.ln1.weight, self.ln1.bias,
                    *(t for p in projs for t in (p.kernel, p.bias)),
                    num_heads=self.num_heads, eps=self.ln_eps,
                    valid_len=valid_len)
        else:
            if valid_len is not None and mask is None:
                # pre-padded tokens on the unfused path: mask the pad keys
                key_pos = torch.arange(x.shape[1], device=x.device)
                mask = torch.where(key_pos < valid_len, 0.0,
                                   torch.finfo(torch.float32).min)
            x = x + a(self.ln1(x), mask)
        if self.fused_mlp and x.dim() == 3:
            B, S, d = x.shape
            fc1, fc2 = self.mlp.fc1, self.mlp.fc2
            if isinstance(fc1, Int8Dense):
                out = fused_ln_mlp_int8(
                    x.reshape(B * S, d), self.ln2.weight, self.ln2.bias,
                    fc1.kernel_q, fc1.kernel_scale, fc1.bias, fc2.kernel_q,
                    fc2.kernel_scale, fc2.bias, eps=self.ln_eps,
                    activation=self.mlp.activation)
            else:
                out = fused_ln_mlp(
                    x.reshape(B * S, d), self.ln2.weight, self.ln2.bias,
                    fc1.kernel, fc1.bias, fc2.kernel, fc2.bias,
                    eps=self.ln_eps, activation=self.mlp.activation)
            return out.reshape(B, S, d)
        return x + self.mlp(self.ln2(x))


def make_padding_mask(attention_mask: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, S) 1/0 mask -> additive (B, 1, 1, S): 0 where kept, the f32
    minimum where padded."""
    neg = torch.finfo(torch.float32).min
    return torch.where(attention_mask[:, None, None, :] > 0, 0.0,
                       neg).to(dtype)
