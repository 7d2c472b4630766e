"""Fused short-sequence attention (K9), hand-written for Hopper.

Port of ``emr2a_tpu/ops/attention.py:fused_attention`` (``_attn_kernel``):
non-causal softmax attention per batch item over ``(B, S, H, D)``, f32
logits and softmax, probabilities cast to v's dtype, f32 P.V cast to q's
dtype. The TPU kernel pads S to a multiple of 128 and masks the padded key
columns with -1e30; the plain version and the kernel take exactly the S
keys, which is the same function.

The kernel is K8's (``csrc/frame_attention.cu``, entry point
``emr2a_fused_attention``): a CUDA tensor goes there (bf16, D a multiple of
8 up to 128) or the call raises; a CPU tensor goes to
``fused_attention_reference``. No path of the system calls K9; the JAX
package's tests do. ``interpret`` has no counterpart. ``LAUNCHES`` counts the
calls that went to the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from emr2a_tpu_torch.ops.vision_flash import launch_attention

LAUNCHES = 0


def fused_attention_reference(q, k, v, scale: Optional[float] = None
                              ) -> torch.Tensor:
    """(B, S, H, D) -> (B, S, H, D), with the TPU kernel's rounding points."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q/k/v: (B, S, H, D) -> (B, S, H, D); no causal mask."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    out = launch_attention("emr2a_fused_attention", q, k, v, scale)
    global LAUNCHES
    LAUNCHES += 1
    return out
