"""Per-frame attention of the Qwen3-VL vision tower (K8), hand-written for
Hopper.

Port of ``emr2a_tpu/ops/vision_flash.py:frame_flash_attention``, which wraps
JAX's library TPU flash kernel: non-causal ``softmax(q k^T * sm_scale) v``
per frame on post-RoPE ``(F, S, H, hd)`` tensors. The library kernel has no
interpret mode, so the JAX package's own oracle for it is the tower's einsum
path (``emr2a_tpu/models/qwen3_vl.py:317-322``); the plain version here is
that path: f32 logits times the scale (plus an optional additive mask, which
the tower's flat mixed-layout path passes), f32 softmax, probabilities cast
to the working dtype, then P.V.

A CPU tensor goes to ``frame_flash_attention_reference``; a CUDA tensor goes
to ``csrc/frame_attention.cu`` (bf16, contiguous, hd a multiple of 8 up to
128) or the call raises. The kernel streams K and V through a 3-stage
cp.async ring of 64-key tiles with an online softmax (``ex2.approx``, the
scale folded into one FFMA), 32 query rows a warp (256 a block from
S = 512) on mma.sync with ldmatrix fragments, and rounds the unnormalised
probabilities to bf16, so
it agrees with the plain version to bf16's precision, not bit for bit. It
masks the keys past S by bounds, so JAX's ``pad_multiple`` has no
counterpart.
``LAUNCHES`` counts the calls that went to the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from emr2a_tpu_torch.ops import _build
from emr2a_tpu_torch.ops.mlp import check_cuda_tensor

LAUNCHES = 0
MAX_HEAD_DIM = 128


def frame_flash_attention_reference(q, k, v, sm_scale: float,
                                    attn_mask: Optional[torch.Tensor] = None
                                    ) -> torch.Tensor:
    """(..., S, H, hd) -> (..., S, H, hd); ``attn_mask`` (S, S) additive."""
    logits = torch.einsum("...qhd,...khd->...hqk", q.float(), k.float()) * sm_scale
    if attn_mask is not None:
        logits = logits + attn_mask[None, :, :]
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("...hqk,...khd->...qhd", probs.float(),
                        v.float()).to(q.dtype)


def launch_attention(entry: str, q, k, v, scale: float) -> torch.Tensor:
    """Check (B, S, H, hd) bf16 operands and run one of the kernel's two
    entry points (K8 ``emr2a_frame_attention``, K9 ``emr2a_fused_attention``)."""
    if q.dim() != 4:
        raise ValueError(f"q must be (batch, S, heads, head_dim), got {tuple(q.shape)}")
    B, S, H, hd = q.shape
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda_tensor(name, t, dev, torch.bfloat16, (B, S, H, hd))
    if hd % 8 or hd > MAX_HEAD_DIM:
        raise ValueError(f"the kernel needs a head dim divisible by 8 and at "
                         f"most {MAX_HEAD_DIM}, got {hd}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    import ctypes
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.kernel_function(entry, [p] * 4 + [i] * 4 + [ctypes.c_float, p])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, H, hd, float(scale), stream)
    _build.check(err, entry)
    return out


def frame_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          sm_scale: float) -> torch.Tensor:
    """Per-frame non-causal attention, (F, S, H, hd) -> (F, S, H, hd)."""
    if q.device.type == "cpu":
        return frame_flash_attention_reference(q, k, v, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    out = launch_attention("emr2a_frame_attention", q, k, v, sm_scale)
    global LAUNCHES
    LAUNCHES += 1
    return out
