"""Pieces the plain references share. Plain PyTorch in float32 (float64
where named), TF32 off; nothing of the program is imported here."""

from __future__ import annotations

import contextlib
import math

import torch


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32 for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def layer_norm(x, w, b, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def gelu_tanh(x):
    return 0.5 * x * (1 + torch.tanh(math.sqrt(2 / math.pi) * (x + 0.044715 * x ** 3)))


def gelu_erf(x):
    return 0.5 * x * (1 + torch.erf(x / math.sqrt(2)))


def attention(q, k, v, causal: bool = False):
    """q (..., S, H, D), k/v (..., S, H, D) -> (..., S, H, D); softmax of
    q.k / sqrt(D)."""
    logits = torch.einsum("...qhd,...khd->...hqk", q, k) / math.sqrt(q.shape[-1])
    if causal:
        S, L = q.shape[-3], k.shape[-3]
        mask = torch.ones(S, L, dtype=torch.bool, device=q.device).tril(L - S)
        logits = logits.masked_fill(~mask, float("-inf"))
    return torch.einsum("...hqk,...khd->...qhd", torch.softmax(logits, dim=-1), v)


def rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)
