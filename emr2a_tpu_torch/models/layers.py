"""Transformer building blocks as ``nn.Module``s.

Port of ``emr2a_tpu/models/layers.py``. Dense projections keep the JAX
package's (in, out) ``kernel`` layout (``Dense``), so the fused kernels take
the module's weights as they are, with no transpose per call.

Routing of ``TransformerBlock``, the reference's rule
(``emr2a_tpu/models/layers.py:145-153,207-220``): with ``fused_attn`` set, a
3-D input without an external mask, with q/k/v biases, takes the fused
attention op (``ops/attention_block.py``) only where the port's copy of
``pick_fused_attn_params`` returns a configuration (weight itemsize 1 for
``Int8Dense`` projections, else 2); with ``fused_mlp`` set, a 3-D input
takes the fused MLP op (``ops/mlp.py``) only where ``2 d mlp itemsize +
256 (mlp + d) 4 < 14 MiB`` (itemsize 1 for int8, else 2). Both rules model
a TPU core's VMEM; the port keeps them so that every shape takes the
reference's function: the fused MLP's tanh gelu or the unfused MLP's erf
gelu, and the unfused attention with the ``valid_len`` key mask where the
rule refuses (ViT-L/336 at S = 577, a 1024 x 4096 bf16 MLP). The chosen
``block_b`` / ``head_group`` are not passed on: the CUDA kernels have no
such knobs (a recorded divergence). The CUDA attention kernels take every
sequence length the rule admits (ViT-B at S = 577, for one).

W8A8 params are routed by what they hold, as the JAX package's
``_QuantRoutingModule`` does: ``load_params`` replaces every ``Dense`` whose
state arrives as ``kernel_q`` / ``kernel_scale`` (``models/quantize.py``)
with an ``Int8Dense``, which runs the streaming W8A8 op (K5,
``ops/linear_int8.py``), and every one whose state arrives as ``kernel_p4``
/ ``kernel_scale4`` with an ``Int4Dense``, which runs the W4A8 op (K7,
``ops/linear_int4.py``). A ``TransformerBlock`` whose projections are
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
    VMEM_BUDGET_BYTES,
    fused_ln_attention,
    fused_ln_attention_int8,
    pick_fused_attn_params,
)
from emr2a_tpu_torch.ops.linear_int4 import int4_group, linear_w4a8
from emr2a_tpu_torch.ops.linear_int8 import linear_w8a8
from emr2a_tpu_torch.ops.mlp import fused_ln_mlp, fused_ln_mlp_int8
from emr2a_tpu_torch.parallel.tensor import reduce_to, replicate


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

    def product(self, x: torch.Tensor) -> torch.Tensor:
        """x @ kernel, without the bias (a row-parallel shard's partial)."""
        return torch.matmul(x.to(self.kernel.dtype), self.kernel)

    def partial(self, x: torch.Tensor) -> torch.Tensor:
        """x @ kernel accumulated and returned in f32, without the bias: a
        row-parallel shard's partial sum, so that the sum over the cards
        is rounded to the working dtype once, as one card's product is (a
        bf16 kernel on a card: cuBLAS's f32 output, ``torch.mm``'s
        ``out_dtype``)."""
        x = x.to(self.kernel.dtype)
        if x.device.type == "cuda" and self.kernel.dtype in (torch.bfloat16, torch.float16):
            flat = torch.mm(x.reshape(-1, x.shape[-1]), self.kernel, out_dtype=torch.float32)
            return flat.reshape(*x.shape[:-1], flat.shape[-1])
        return torch.matmul(x.float(), self.kernel.float())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.product(x)
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

    def product(self, x: torch.Tensor) -> torch.Tensor:
        """The W8A8 product without the bias."""
        return linear_w8a8(x.contiguous(), self.kernel_q, self.kernel_scale,
                           None, out_dtype=self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear_w8a8(x.contiguous(), self.kernel_q, self.kernel_scale,
                           self.bias, out_dtype=self.dtype)


class Int4Dense(nn.Module):
    """A ``Dense`` held in W4A8: ``kernel_p4`` int8 (in/2, out) packed
    nibbles and ``kernel_scale4`` f32 (in/group, out) group scales, the JAX
    package's layout and names (``ops/linear_int4.quantize_weight_int4``,
    the group of ``int4_group(in)``), and a bias in the working dtype. Runs
    ``linear_w4a8`` (K7), whose output is in the working dtype."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("kernel_p4", torch.zeros(
            in_features // 2, out_features, dtype=torch.int8, device=device))
        self.register_buffer("kernel_scale4", torch.ones(
            in_features // int4_group(in_features), out_features,
            dtype=torch.float32, device=device))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(out_features, dtype=dtype,
                                                 device=device))
        else:
            self.register_parameter("bias", None)

    def product(self, x: torch.Tensor) -> torch.Tensor:
        """The W4A8 product without the bias."""
        return linear_w4a8(x.contiguous(), self.kernel_p4, self.kernel_scale4,
                           None, out_dtype=self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear_w4a8(x.contiguous(), self.kernel_p4, self.kernel_scale4,
                           self.bias, out_dtype=self.dtype)


def load_params(module: nn.Module, state: Mapping[str, torch.Tensor]
                ) -> nn.Module:
    """``module.load_state_dict(state)`` after replacing every ``Dense``
    whose kernel arrives quantized (``<name>.kernel_q`` or
    ``<name>.kernel_p4`` in ``state``) with an ``Int8Dense`` or an
    ``Int4Dense`` of the same shape and dtype."""
    for name, sub in list(module.named_modules()):
        for leaf_name, cls in (("kernel_q", Int8Dense), ("kernel_p4", Int4Dense)):
            if isinstance(sub, Dense) and f"{name}.{leaf_name}" in state:
                parent, _, leaf = name.rpartition(".")
                setattr(module.get_submodule(parent), leaf, cls(
                    *sub.kernel.shape, use_bias=sub.bias is not None,
                    dtype=sub.kernel.dtype, device=sub.kernel.device))
    module.load_state_dict(state)
    return module


class MultiHeadAttention(nn.Module):
    """MHA with separate q/k/v/out projections and an optional additive
    mask; logits and softmax in f32, probabilities in the working dtype.
    ``shard=(c, n)`` builds card c's shard of an n-card model axis
    (``ShardedAttention``): hidden_size / n columns of q/k/v and rows of
    out_proj (num_heads / n whole heads where n divides num_heads, else
    ``num_heads`` is 0 and ``ShardedAttention`` attends with the gathered
    heads), and out_proj's bias on card 0 only (it is added once, after the
    sum)."""

    def __init__(self, hidden_size: int, num_heads: int,
                 qkv_bias: bool = True, out_bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None, shard=(0, 1)):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden {hidden_size} not divisible by "
                             f"num_heads {num_heads}")
        rank, n = shard
        if hidden_size % n:
            raise ValueError(f"a model axis of {n} cards does not divide "
                             f"hidden_size = {hidden_size}")
        self.total_heads = num_heads
        self.num_heads = 0 if num_heads % n else num_heads // n
        self.head_dim = hidden_size // num_heads
        w = hidden_size // n
        kw = dict(dtype=dtype, device=device)
        self.q_proj = Dense(hidden_size, w, qkv_bias, **kw)
        self.k_proj = Dense(hidden_size, w, qkv_bias, **kw)
        self.v_proj = Dense(hidden_size, w, qkv_bias, **kw)
        self.out_proj = Dense(w, hidden_size, out_bias and rank == 0, **kw)

    def context(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The attention of this module's heads, before ``out_proj``."""
        return attend(self.q_proj(x), self.k_proj(x), self.v_proj(x), self.num_heads,
                      mask)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.out_proj(self.context(x, mask))


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax attention of (B, S, num_heads * hd) projections, logits and
    softmax in f32, probabilities in the working dtype: (B, S, num_heads *
    hd)."""
    B, S, w = q.shape
    hd = w // num_heads
    shape = (B, S, num_heads, hd)
    q, k, v = q.reshape(shape), k.reshape(shape), v.reshape(shape)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd ** -0.5
    if mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, w)


class Mlp(nn.Module):
    """fc2(act(fc1(x))). ``shard=(c, n)``: card c's mlp_dim / n columns of
    fc1 and rows of fc2, and fc2's bias on card 0 only
    (``ShardedMlp``)."""

    def __init__(self, hidden_size: int, mlp_dim: int,
                 activation: str = "gelu", dtype: torch.dtype = torch.float32,
                 device=None, shard=(0, 1)):
        super().__init__()
        rank, n = shard
        if mlp_dim % n:
            raise ValueError(f"a model axis of {n} cards does not divide "
                             f"mlp_dim = {mlp_dim}")
        self.activation = activation
        self.fc1 = Dense(hidden_size, mlp_dim // n, dtype=dtype, device=device)
        self.fc2 = Dense(mlp_dim // n, hidden_size, rank == 0, dtype=dtype, device=device)

    def hidden(self, x: torch.Tensor) -> torch.Tensor:
        """act(fc1(x)), before ``fc2``."""
        return ACTIVATIONS[self.activation](self.fc1(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.hidden(x))


class _RowParallel(nn.Module):
    """Shards of a module over a model axis, card c's ``shards[c]`` on its
    card: the input (on the first card) is copied to every card, each card
    runs its shard up to the row-parallel projection ``last``, the partial
    products are summed on the first card in card order (``parallel.
    reduce_to``) and shard 0's bias is added after the sum. Autograd
    carries the copies (the backward of the copy sums the cards' input
    gradients; that of the sum copies the output gradient to every card)."""

    last = ""

    def __init__(self, shards):
        super().__init__()
        self.shards = nn.ModuleList(shards)

    def _sum(self, x, parts) -> torch.Tensor:
        y = reduce_to(parts, x.device)
        bias = getattr(self.shards[0], self.last).bias
        return y if bias is None else y + bias

    def _devices(self) -> list:
        return [getattr(s, self.last).kernel.device for s in self.shards]


class ShardedAttention(_RowParallel):
    """``MultiHeadAttention`` over a model axis: ``shards`` are its
    ``shard=(c, n)`` modules (see ``_RowParallel``). Where n divides the
    heads each card attends with its own; else (a card's columns split a
    head, as JAX's SPMD allows) the cards' q/k/v columns are gathered on the
    first card, which attends with the whole heads, and each card takes its
    columns of the result for its out_proj rows."""

    last = "out_proj"
    q_proj = property(lambda self: self.shards[0].q_proj)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        devices = self._devices()
        xs, masks = replicate(x, devices), replicate(mask, devices)
        if self.shards[0].num_heads:
            ctx = [s.context(xc, mc) for s, xc, mc in zip(self.shards, xs, masks)]
        else:
            qkv = [torch.cat([getattr(s, p)(xc).to(x.device) for s, xc in zip(self.shards, xs)],
                             dim=-1) for p in ("q_proj", "k_proj", "v_proj")]
            whole = attend(*qkv, self.shards[0].total_heads, mask)
            ctx = [c.to(d) for c, d in zip(whole.chunk(len(devices), dim=-1), devices)]
        return self._sum(x, [s.out_proj.product(c) for s, c in zip(self.shards, ctx)])


class ShardedMlp(_RowParallel):
    """``Mlp`` over a model axis: ``shards`` are its ``shard=(c, n)``
    modules (see ``_RowParallel``)."""

    last = "fc2"
    fc1 = property(lambda self: self.shards[0].fc1)
    fc2 = property(lambda self: self.shards[0].fc2)
    activation = property(lambda self: self.shards[0].activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._sum(x, [s.fc2.product(s.hidden(xc)) for s, xc in
                             zip(self.shards, replicate(x, self._devices()))])


def fused_mlp_fits(d: int, mlp_dim: int, weight_itemsize: int) -> bool:
    """The reference's residency rule for the fused MLP
    (``emr2a_tpu/models/layers.py:214-220``): both weights and a 256-row f32
    tile of the hidden and output under 14 MiB."""
    return (2 * d * mlp_dim * weight_itemsize
            + 256 * (mlp_dim + d) * 4) < VMEM_BUDGET_BYTES


class TransformerBlock(nn.Module):
    """Pre-LN block: x + attn(ln1(x)); x + mlp(ln2(x)).

    ``fused_attn`` / ``fused_mlp`` route each half through its fused op
    where the reference's rule admits the shape (see the module docstring);
    the fused MLP evaluates gelu in the tanh approximation. ``valid_len`` (a
    forward argument) marks the rows that are real when the caller keeps
    its token axis pre-padded: later rows are masked as keys and are junk
    as outputs.
    """

    def __init__(self, hidden_size: int, num_heads: int, mlp_dim: int,
                 activation: str = "gelu", ln_eps: float = 1e-5,
                 qkv_bias: bool = True, fused_mlp: bool = False,
                 fused_attn: bool = False, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        self.mlp_dim = mlp_dim
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
        w8 = isinstance(a.q_proj, Int8Dense)
        if (self.fused_attn and x.dim() == 3 and mask is None and self.qkv_bias
                and pick_fused_attn_params(x.shape[-1], x.shape[1], self.num_heads,
                                           weight_itemsize=1 if w8 else 2)):
            projs = (a.q_proj, a.k_proj, a.v_proj, a.out_proj)
            if w8:
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
        fc1, fc2 = self.mlp.fc1, self.mlp.fc2
        if (self.fused_mlp and x.dim() == 3
                and fused_mlp_fits(x.shape[-1], self.mlp_dim,
                                   1 if isinstance(fc1, Int8Dense) else 2)):
            B, S, d = x.shape
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


def make_causal_mask(seq_len: int, dtype: torch.dtype = torch.float32,
                     device=None) -> torch.Tensor:
    """Additive causal mask (1, 1, S, S): -inf above the diagonal, 0 on and
    below it."""
    mask = torch.triu(torch.full((seq_len, seq_len), float("-inf"),
                                 dtype=dtype, device=device), diagonal=1)
    return mask[None, None]


def make_padding_mask(attention_mask: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, S) 1/0 mask -> additive (B, 1, 1, S): 0 where kept, the f32
    minimum where padded."""
    neg = torch.finfo(torch.float32).min
    return torch.where(attention_mask[:, None, None, :] > 0, 0.0,
                       neg).to(dtype)
