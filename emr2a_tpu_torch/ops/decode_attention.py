"""GQA decode attention over the decoder's bf16 KV cache (K10), hand-written
for Hopper.

K10 replaces no TPU kernel: the JAX package lowers the Qwen3-VL decoder's
small-S attention (``emr2a_tpu/models/qwen3_vl.py``, the S <= 16 branch) to
XLA einsums. Its plain version here, ``decode_attention_reference``, is that
branch as the port ran it: the cache upcast to f32, f32 logits times the
scale plus the additive mask, f32 softmax, the probabilities cast to the
working dtype, then P.V in f32 (and, for the int8 cache, its per-position
scales folded in as JAX folds them). On the card that moved about 14 bytes
for each byte the attention needs.

A CPU tensor goes to the plain version; a CUDA tensor goes to
``csrc/decode_attention.cu`` or the call raises (``check_operands``): q
(B, S <= 16, H, 128) bf16, the caches (B, L, KV, 128) bf16 read through
their strides (never copied), the (B, S, L) f32 additive mask the caller
built, (H / KV) * S <= 64. What bounds it is bytes: at S = 1 it does about 4
operations a byte of K and V, far below the card's 295, so its design aims
at reading each cache byte once with every SM busy. It splits L into a
fixed number of 64-position tiles a block (``split_positions``: about two
blocks an SM from B * KV, L and the SM count, at least 3 tiles a block,
never from the data), streams
K, V and the mask through a 3-stage cp.async ring, runs logits and P.V on
mma.sync with an online softmax in f32 and the unnormalised probabilities
rounded to bf16 (K8's rounding, so it agrees with the plain version to
bf16's precision, not bit for bit), and merges the splits' partials in a
second small launch in split order: no atomics, so two calls, or a replayed
CUDA graph step and the eager step, are bit-identical. It allocates its
scratch with ``torch.empty`` and reads nothing back, so it runs inside the
generator's and the batcher's CUDA graphs. ``LAUNCHES`` counts the calls
that went to the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from emr2a_tpu_torch.ops import _build

LAUNCHES = 0
HEAD_DIM = 128
MAX_QUERIES = 16       # S
MAX_ROWS = 64          # (H / KV) * S query rows a kv head
TILE = 64              # positions a tile
MIN_SPLIT_TILES = 3    # the ring's stages


def decode_attention_reference(q, k_cache, v_cache, attn_mask, scale: float,
                               kq_scale: Optional[torch.Tensor] = None,
                               vq_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, S, H, hd), caches (B, L, KV, hd), attn_mask (B, S, L) additive
    f32 -> (B, S, H * hd) in q's dtype (the working dtype). ``kq_scale`` /
    ``vq_scale`` (B, L, KV) f32 are an int8 cache's scales, folded onto the
    logits and the probabilities."""
    B, S, H, hd = q.shape
    KV = k_cache.shape[2]
    dtype = q.dtype
    q_g = q.reshape(B, S, KV, H // KV, hd)
    logits = torch.einsum("bqkgd,blkd->bkgql", q_g.float(), k_cache.float()) * scale
    if kq_scale is not None:
        logits = logits * kq_scale.transpose(1, 2)[:, :, None, None, :]
    logits = logits + attn_mask[:, None, None, :, :]
    probs = torch.softmax(logits, dim=-1)
    if vq_scale is not None:
        probs = probs * vq_scale.transpose(1, 2)[:, :, None, None, :]
    probs = probs.to(dtype)
    attn = torch.einsum("bkgql,blkd->bqkgd", probs.float(), v_cache.float()).to(dtype)
    return attn.reshape(B, S, H * hd)


def _check_strided(name: str, t: torch.Tensor, device, dtype, shape) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {str(dtype).split('.')[-1]} for the "
                        f"CUDA kernel, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must have unit stride in its last dim")


def check_operands(q, k_cache, v_cache, attn_mask) -> None:
    """Raise unless the kernel takes these operands (see the module
    docstring): shapes, dtypes, head width, S, strides and alignment."""
    if q.dim() != 4:
        raise ValueError(f"q must be (batch, S, heads, head_dim), got {tuple(q.shape)}")
    B, S, H, hd = q.shape
    if q.dtype != torch.bfloat16:
        raise TypeError(f"q must be bfloat16 for the CUDA kernel, got {q.dtype}")
    if hd != HEAD_DIM:
        raise ValueError(f"the kernel takes a head dim of {HEAD_DIM}, got {hd}")
    if not 1 <= S <= MAX_QUERIES:
        raise ValueError(f"the kernel takes 1 to {MAX_QUERIES} query positions, got {S}")
    if k_cache.dim() != 4:
        raise ValueError(f"k_cache must be (batch, L, kv_heads, head_dim), got "
                         f"{tuple(k_cache.shape)}")
    L, KV = k_cache.shape[1], k_cache.shape[2]
    if KV < 1 or H % KV:
        raise ValueError(f"{H} query heads do not share {KV} kv heads evenly")
    if (H // KV) * S > MAX_ROWS:
        raise ValueError(f"{H // KV} query heads a kv head times {S} positions exceed "
                         f"the kernel's {MAX_ROWS} rows")
    _check_strided("q", q, q.device, torch.bfloat16, (B, S, H, hd))
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        _check_strided(name, t, q.device, torch.bfloat16, (B, L, KV, hd))
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:-1]):
            raise ValueError(f"{name}'s rows must be 16-byte aligned")
    _check_strided("attn_mask", attn_mask, q.device, torch.float32, (B, S, L))


def split_positions(batch: int, kv_heads: int, length: int, sms: int) -> int:
    """Positions a block takes: whole 64-position tiles, as few as keep about
    two blocks on each of ``sms`` SMs busy, but at least the ring's 3
    stages (a shorter split never fills the ring, and its partial costs a
    write and a read for little work). From the shape alone, so a call of
    one shape always splits the same way."""
    tiles = -(-length // TILE)
    return TILE * max(MIN_SPLIT_TILES, -(-tiles * batch * kv_heads // (2 * sms)))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     attn_mask: torch.Tensor, scale: float) -> torch.Tensor:
    """GQA attention of S <= 16 query positions over the bf16 KV cache,
    (B, S, H, 128) -> (B, S, H * 128)."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, attn_mask, scale)
    check_operands(q, k_cache, v_cache, attn_mask)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    B, S, H, hd = q.shape
    L, KV = k_cache.shape[1], k_cache.shape[2]
    dev = q.device
    chunk = split_positions(B, KV, L, _build.sm_count(dev.index or 0))
    nsplit = -(-L // chunk)
    out = torch.empty(B, S, H * hd, dtype=torch.bfloat16, device=dev)
    part_o = part_ml = None
    if nsplit > 1:
        rows = B * KV * nsplit * (H // KV) * S
        part_o = torch.empty(rows * hd, dtype=torch.float32, device=dev)
        part_ml = torch.empty(rows * 2, dtype=torch.float32, device=dev)
    import ctypes
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = _build.kernel_function(
        "emr2a_decode_attention",
        [p, ll, ll, ll] * 3 + [p, ll, ll] + [p] * 3 + [i] * 7 + [ctypes.c_float, p])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), *q.stride()[:3],
                 k_cache.data_ptr(), *k_cache.stride()[:3],
                 v_cache.data_ptr(), *v_cache.stride()[:3],
                 attn_mask.data_ptr(), *attn_mask.stride()[:2],
                 out.data_ptr(), None if part_o is None else part_o.data_ptr(),
                 None if part_ml is None else part_ml.data_ptr(),
                 B, S, H, KV, L, chunk, nsplit, float(scale), stream)
    _build.check(err, "emr2a_decode_attention")
    global LAUNCHES
    LAUNCHES += 1
    return out
