"""Fused LayerNorm -> QKV -> attention -> out-proj -> residual (K3),
hand-written for Hopper.

Port of ``emr2a_tpu/ops/attention_block.py:fused_ln_attention`` (Pallas
``_attn_block_kernel``):

    h = LN(x);  q/k/v = h @ W + b
    y = x + out_proj(softmax(q k^T / sqrt(hd) + mask) v)

over whole sequences of one item. Rounding points, as in the TPU kernel:
LN statistics in f32, h rounded to ``x.dtype``; each projection accumulated
in f32 and rounded to ``x.dtype`` after its bias; logits and softmax in f32
with keys at or past ``valid_len`` given -1e30; probabilities rounded to
``x.dtype`` before P.V; P.V accumulated in f32 and rounded; the out-proj
accumulated in f32, + bo rounded, then the residual add.

Rows at or past ``valid_len`` are padding kept across layers by the caller
(``models/vit.py``): they are masked as keys and their outputs are junk.

``fused_ln_attention`` takes the JAX signature. ``head_group`` (how many
heads share the TPU kernel's logits scratch in VMEM) has no counterpart
here and is ignored. ``merge_batch=True`` selects K3m, the TPU kernel's
merged-batch variant (``_attn_block_kernel_merged``): the same function,
scheduled by groups of ``block_b`` items, LN and the Q/K/V projections run
once over a group's ``block_b * S`` rows, the attention per item, the
out-projection over the group's rows. Its plain version,
``fused_ln_attention_merged_reference``, follows that schedule and equals
K3's plain version exactly. ``block_b`` matters only with ``merge_batch``;
a ``block_b`` above B takes one group, and a short last group takes the
place of the TPU kernel's batch padding (the outputs are the same).

Divergence: K3m's group on the card is a multiple of ``block_b`` chosen
from the L2 size and the SM count (``merged_group``), not ``block_b``
itself. The TPU variant keeps a group's tile in VMEM; here a group's Q/K/V
and attention output stay in L2, and a group of ``block_b`` items gives
grids too small for 132 SMs. So the group grows by ``block_b`` until its
out-projection's 128 x 128 tiles cover the SMs ``MERGED_WAVES`` times (24
items at ViT-B: 228 tiles), while its scratch (4 G S d bf16 values) stays
within ``MERGED_L2_SHARE`` of L2. Consecutive groups
alternate between two streams and two scratch sets
(``csrc/attention_block.cu``, ``emr2a_fused_ln_attention_merged``), so one
group's LN and Q/K/V run beside the last one's attention and
out-projection. Each output row keeps K3's K-loop and each item its
attention, so K3m equals K3 bit for bit at every group size.

A CPU tensor goes to the plain version; a CUDA tensor goes to the CUDA
kernel in ``csrc/attention_block.cu`` (bf16, head dim 64, d % 128 == 0,
any sequence length), or the call raises. ``LAUNCHES`` counts the calls
that went to K3, ``MERGED_LAUNCHES`` those that went to K3m.

The W8A8 variant, K4 (``fused_ln_attention_int8``, port of
``emr2a_tpu/ops/attention_block.py:fused_ln_attention_int8``), runs the
four projections as s8 products from int8 weights with per-column f32
scales. Rounding points, as in the TPU kernel: the f32 LN output (as K2's,
``mlp.layer_norm_exact_stats``) is quantized per row; q/k/v = (acc * row scale) * column scale + b, rounded to
``x.dtype``; the softmax as in K3; P.V accumulated in f32 and quantized per
row unrounded; the out-proj rescaled + bo, rounded, then the residual add.
A CUDA tensor goes to ``csrc/attention_block_int8.cu`` (same limits as K3),
or the call raises. ``INT8_LAUNCHES`` counts the calls that went to it.

``fused_attn_vmem_bytes`` and ``pick_fused_attn_params`` are the port's
copies of the JAX package's routing rule (the same functions of
``emr2a_tpu/ops/attention_block.py``, a model of one TPU core's VMEM):
``models/layers.TransformerBlock`` takes the fused op only where the rule
returns a configuration, so the port routes every shape as the reference
does.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from emr2a_tpu_torch.ops import _build
from emr2a_tpu_torch.ops.mlp import (
    GEMM_BN,
    check_cuda_operands,
    check_cuda_tensor,
    layer_norm_exact_stats,
    layer_norm_f32,
)
from emr2a_tpu_torch.ops.quant import quantize_rows_s8_reference, s8_matmul

NEG_INF = -1e30
KERNEL_HEAD_DIM = 64

LAUNCHES = 0
MERGED_LAUNCHES = 0
INT8_LAUNCHES = 0

# K3m's group on the card: how many times its out-projection tiles must
# cover the SMs, and the share of L2 its scratch may take (1.5 waves was the
# fastest of the groups timed on the card, PERF.md section 6); the GEMM's
# tile rows (csrc/gemm.cuh, GEMM_BM)
MERGED_WAVES = 1.5
MERGED_L2_SHARE = 0.6
GEMM_BM = 128

# The JAX package's working VMEM budget (emr2a_tpu/ops/attention_block.py)
VMEM_BUDGET_BYTES = 14 * 1024 * 1024


def _divisor_at_most(n: int, cap: int) -> int:
    return next(g for g in range(min(cap, n), 0, -1) if n % g == 0)


def fused_attn_vmem_bytes(d: int, S: int, num_heads: int, head_group: int,
                          block_b: int, itemsize: int = 2,
                          weight_itemsize: Optional[int] = None) -> int:
    """The JAX package's VMEM estimate of one TPU grid step of the fused
    block: four d x d weights, the k/v pad scratch, the double-buffered
    in/out tiles, the f32 logits scratch, and for W8A8 weights the stack
    temporaries."""
    sq = -(-S // 8) * 8
    sp = -(-sq // 128) * 128
    hg = _divisor_at_most(num_heads, head_group)
    total = (4 * d * d * (weight_itemsize or itemsize) + 2 * sp * d * itemsize
             + 4 * block_b * sq * d * itemsize + hg * sq * sp * 4)
    if weight_itemsize == 1:
        total += block_b * sq * d * 5
    return total


def pick_fused_attn_params(d: int, S: int, num_heads: int,
                           budget: int = VMEM_BUDGET_BYTES,
                           weight_itemsize: int = 2):
    """The largest (block_b, head_group) within the budget, batch blocking
    first, as the JAX package picks it; None where even (1, 1) exceeds it,
    and the caller then takes the unfused path."""
    for block_b in (4, 2, 1):
        for head_group in (6, 4, 3, 2, 1):
            hg = _divisor_at_most(num_heads, head_group)
            if fused_attn_vmem_bytes(d, S, num_heads, hg, block_b,
                                     weight_itemsize=weight_itemsize) <= budget:
                return block_b, hg
    return None


def fused_ln_attention_reference(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv,
                                 wo, bo, num_heads: int, eps: float = 1e-6,
                                 valid_len: Optional[int] = None
                                 ) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with its rounding points:
    products in f32 from ``x.dtype`` operands."""
    B, S, d = x.shape
    if d % num_heads:
        raise ValueError(f"hidden {d} not divisible by num_heads {num_heads}")
    hd = d // num_heads
    valid_len = S if valid_len is None else min(valid_len, S)
    h = layer_norm_f32(x, ln_scale, ln_bias, eps).to(x.dtype).float()

    def proj(w, b):
        y = torch.matmul(h, w.float()) + b.float()
        return y.to(x.dtype).reshape(B, S, num_heads, hd).float()

    q, k, v = proj(wq, bq), proj(wk, bk), proj(wv, bv)
    attn = _sdpa(q, k, v, valid_len, x.dtype).to(x.dtype)
    y = torch.matmul(attn.reshape(B, S, d).float(), wo.float()) + bo.float()
    return x + y.to(x.dtype)


def fused_ln_attention_merged_reference(x, ln_scale, ln_bias, wq, bq, wk, bk,
                                        wv, bv, wo, bo, num_heads: int,
                                        eps: float = 1e-6, block_b: int = 1,
                                        valid_len: Optional[int] = None
                                        ) -> torch.Tensor:
    """Plain PyTorch version of K3m, on the TPU kernel's schedule: items in
    groups of ``block_b``, LN and the projections over each group's rows at
    once, the attention per item; K3's rounding points."""
    B, S, d = x.shape
    if d % num_heads:
        raise ValueError(f"hidden {d} not divisible by num_heads {num_heads}")
    if block_b < 1:
        raise ValueError(f"block_b must be >= 1, got {block_b}")
    hd = d // num_heads
    valid_len = S if valid_len is None else min(valid_len, S)
    groups = []
    for b0 in range(0, B, block_b):
        xg = x[b0:b0 + block_b]
        rows = xg.shape[0] * S
        h = layer_norm_f32(xg.reshape(rows, d), ln_scale, ln_bias,
                           eps).to(x.dtype).float()

        def proj(w, b):
            y = torch.matmul(h, w.float()) + b.float()
            return y.to(x.dtype).reshape(-1, S, num_heads, hd).float()

        q, k, v = proj(wq, bq), proj(wk, bk), proj(wv, bv)
        attn = torch.cat([_sdpa(q[i:i + 1], k[i:i + 1], v[i:i + 1], valid_len,
                                x.dtype) for i in range(xg.shape[0])])
        y = torch.matmul(attn.to(x.dtype).reshape(rows, d).float(),
                         wo.float()) + bo.float()
        groups.append(xg + y.reshape(xg.shape).to(x.dtype))
    return torch.cat(groups) if groups else x.clone()


def _sdpa(q, k, v, valid_len: int, dtype) -> torch.Tensor:
    """f32 q/k/v (B, S, H, hd) holding ``dtype`` values -> the f32 P.V of
    the kernels: f32 logits and softmax, keys at or past ``valid_len`` given
    -1e30, probabilities rounded to ``dtype``, f32 products."""
    S, hd = q.shape[1], q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
    if valid_len < S:
        mask = torch.where(torch.arange(S, device=q.device) < valid_len,
                           0.0, NEG_INF).to(torch.float32)
        logits = logits + mask
    probs = torch.softmax(logits, dim=-1).to(dtype).float()
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def merged_group(B: int, S: int, d: int, block_b: int, sms: int,
                 l2_bytes: int, waves: float = MERGED_WAVES,
                 l2_share: float = MERGED_L2_SHARE) -> int:
    """K3m's group on the card: the least multiple of ``block_b`` whose
    out-projection (``ceil(G S / 128) * d / 128`` tiles) covers ``sms``
    SMs ``waves`` times, grown only while the next size's Q/K/V and
    attention-output scratch (``4 G S d`` bf16 values) fits ``l2_share``
    of ``l2_bytes`` and the group stays within B. B items at most
    ``block_b`` take one group of B; a group of ``block_b`` is kept
    whatever its scratch."""
    if block_b < 1 or B < 1:
        raise ValueError(f"block_b and B must be >= 1, got {block_b}, {B}")
    if B <= block_b:
        return B
    tiles = lambda g: -(-g * S // GEMM_BM) * (d // GEMM_BN)
    fits = lambda g: 4 * g * S * d * 2 <= l2_share * l2_bytes
    G = block_b
    while tiles(G) < waves * sms and G + block_b <= B and fits(G + block_b):
        G += block_b
    return G


@functools.lru_cache(maxsize=None)
def device_caps(index: int) -> tuple:
    """(SM count, L2 bytes) of CUDA device ``index``, from the runtime's
    device attributes."""
    import ctypes
    fn = _build.kernel_function("emr2a_device_caps", [ctypes.c_void_p] * 2)
    sms, l2 = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        _build.check(fn(ctypes.addressof(sms), ctypes.addressof(l2)), "device_caps")
    return sms.value, l2.value


_SIDE_STREAMS: dict = {}


def _side_stream(current: "torch.cuda.Stream") -> "torch.cuda.Stream":
    """K3m's second stream on ``current``'s device, never ``current``
    itself (streams come from PyTorch's pool, which hands them out in
    turn)."""
    side = _SIDE_STREAMS.get(current.device)
    if side is None or side.cuda_stream == current.cuda_stream:
        side = _SIDE_STREAMS[current.device] = torch.cuda.Stream(current.device)
    return side


def fused_ln_attention(x: torch.Tensor, ln_scale, ln_bias, wq, bq, wk, bk,
                       wv, bv, wo, bo, num_heads: int, eps: float = 1e-6,
                       head_group: int = 6, block_b: int = 1,
                       valid_len: Optional[int] = None,
                       merge_batch: bool = False) -> torch.Tensor:
    """x (B, S, d) -> x + out_proj(attention(LN(x))); weights (d, d) in
    (in, out) layout. ``valid_len`` (default S) limits which rows act as
    keys. ``merge_batch`` selects K3m with groups of ``block_b`` items;
    ``head_group`` is ignored (module docstring)."""
    if merge_batch and block_b < 1:
        raise ValueError(f"block_b must be >= 1, got {block_b}")
    if x.device.type == "cpu":
        if merge_batch:
            return fused_ln_attention_merged_reference(
                x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo,
                num_heads=num_heads, eps=eps, block_b=block_b,
                valid_len=valid_len)
        return fused_ln_attention_reference(
            x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo,
            num_heads=num_heads, eps=eps, valid_len=valid_len)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, d), got {tuple(x.shape)}")
    B, S, d = x.shape
    _check_kernel_shape(S, d, num_heads)
    valid_len = S if valid_len is None else min(valid_len, S)
    if valid_len < 1:
        raise ValueError(f"valid_len must be >= 1, got {valid_len}")
    named = {"x": x, "ln_scale": ln_scale, "ln_bias": ln_bias, "wq": wq,
             "bq": bq, "wk": wk, "bk": bk, "wv": wv, "bv": bv, "wo": wo,
             "bo": bo}
    for name, t in named.items():
        shape = (d, d) if name.startswith("w") else (d,)
        if name != "x" and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    check_cuda_operands(named, x.device)
    if B == 0:
        return x.clone()

    out = torch.empty_like(x)
    current = torch.cuda.current_stream(x.device)
    with torch.cuda.device(x.device):
        if merge_batch:
            err = _launch_merged(named, out, B, S, d, num_heads, valid_len,
                                 block_b, eps, current)
        else:
            # K3's scratch holds all B items
            qkv = torch.empty((3, B * S, d), dtype=x.dtype, device=x.device)
            attn = torch.empty((B * S, d), dtype=x.dtype, device=x.device)
            fn = _build.kernel_function("emr2a_fused_ln_attention", _argtypes())
            err = fn(*(t.data_ptr() for t in (*named.values(), qkv, attn, out)),
                     B, S, d, num_heads, valid_len, float(eps), current.cuda_stream)
    global LAUNCHES, MERGED_LAUNCHES
    if merge_batch:
        _build.check(err, "fused_ln_attention (merge_batch)")
        MERGED_LAUNCHES += 1
    else:
        _build.check(err, "fused_ln_attention")
        LAUNCHES += 1
    return out


def _launch_merged(named: dict, out, B, S, d, num_heads, valid_len, block_b,
                   eps, current) -> int:
    """K3m: the group from ``merged_group``, one scratch set a group in
    flight (two where there is more than one group), the groups alternating
    between ``current`` and a side stream forked from it and joined back
    (events, which a CUDA graph captures)."""
    x = named["x"]
    G = merged_group(B, S, d, block_b, *device_caps(x.device.index))
    sets = 1 if G >= B else 2
    qkv = torch.empty((sets, 3, G * S, d), dtype=x.dtype, device=x.device)
    attn = torch.empty((sets, G * S, d), dtype=x.dtype, device=x.device)
    side = _side_stream(current) if sets == 2 else current
    fn = _build.kernel_function("emr2a_fused_ln_attention_merged",
                                _argtypes(merged=True))
    if side is not current:
        side.wait_stream(current)
    err = fn(*(t.data_ptr() for t in (*named.values(), qkv, attn, out)),
             B, S, d, num_heads, valid_len, G, float(eps), current.cuda_stream,
             side.cuda_stream)
    if side is not current:
        current.wait_stream(side)
    return err


def _check_kernel_shape(S: int, d: int, num_heads: int) -> None:
    """Raise unless the CUDA kernels take (S, d, num_heads): head dim 64 and
    d % 128 == 0; any sequence length S."""
    if d % num_heads:
        raise ValueError(f"hidden {d} not divisible by num_heads {num_heads}")
    if d // num_heads != KERNEL_HEAD_DIM:
        raise ValueError(f"the kernel supports head dim {KERNEL_HEAD_DIM}, "
                         f"got {d // num_heads}")
    if d % GEMM_BN:
        raise ValueError(f"the kernel needs d divisible by {GEMM_BN}, got {d}")


def _argtypes(merged: bool = False):
    import ctypes
    p, i = ctypes.c_void_p, ctypes.c_int
    return [p] * 14 + [i] * (6 if merged else 5) + [ctypes.c_float] + [p] * (2 if merged else 1)


# ---------------------------------------------------------------------------
# W8A8 (K4)
# ---------------------------------------------------------------------------

def fused_ln_attention_int8_reference(x, ln_scale, ln_bias, wq_q, wq_s, bq,
                                      wk_q, wk_s, bk, wv_q, wv_s, bv,
                                      wo_q, wo_s, bo, num_heads: int,
                                      eps: float = 1e-6,
                                      valid_len: Optional[int] = None
                                      ) -> torch.Tensor:
    """Plain PyTorch version of K4, with the TPU kernel's rounding points."""
    B, S, d = x.shape
    if d % num_heads:
        raise ValueError(f"hidden {d} not divisible by num_heads {num_heads}")
    hd = d // num_heads
    valid_len = S if valid_len is None else min(valid_len, S)
    hq, hs = quantize_rows_s8_reference(
        layer_norm_exact_stats(x, ln_scale, ln_bias, eps).reshape(B * S, d))

    def rescale(acc, row_scale, w_s, b):
        return acc * row_scale * w_s.reshape(1, -1).float() + b.float()

    def proj(w_q, w_s, b):
        y = rescale(s8_matmul(hq, w_q), hs, w_s, b).to(x.dtype)
        return y.reshape(B, S, num_heads, hd).float()

    q, k, v = proj(wq_q, wq_s, bq), proj(wk_q, wk_s, bk), proj(wv_q, wv_s, bv)
    aq, as_ = quantize_rows_s8_reference(
        _sdpa(q, k, v, valid_len, x.dtype).reshape(B * S, d))
    y = rescale(s8_matmul(aq, wo_q), as_, wo_s, bo)
    return x + y.reshape(B, S, d).to(x.dtype)


def fused_ln_attention_int8(x: torch.Tensor, ln_scale, ln_bias, wq_q, wq_s, bq,
                            wk_q, wk_s, bk, wv_q, wv_s, bv, wo_q, wo_s, bo,
                            num_heads: int, eps: float = 1e-6,
                            head_group: int = 6, block_b: int = 1,
                            valid_len: Optional[int] = None) -> torch.Tensor:
    """x (B, S, d) -> x + out_proj(attention(LN(x))) in W8A8; w*_q (d, d)
    int8 in (in, out) layout, w*_s (d,) f32 column scales (or (1, d)).
    ``head_group`` and ``block_b`` (TPU VMEM knobs) are ignored."""
    if x.device.type == "cpu":
        return fused_ln_attention_int8_reference(
            x, ln_scale, ln_bias, wq_q, wq_s, bq, wk_q, wk_s, bk, wv_q, wv_s,
            bv, wo_q, wo_s, bo, num_heads=num_heads, eps=eps,
            valid_len=valid_len)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, d), got {tuple(x.shape)}")
    B, S, d = x.shape
    _check_kernel_shape(S, d, num_heads)
    valid_len = S if valid_len is None else min(valid_len, S)
    if valid_len < 1:
        raise ValueError(f"valid_len must be >= 1, got {valid_len}")
    bf16, dev = torch.bfloat16, x.device
    operands = [x, ln_scale, ln_bias]
    check_cuda_tensor("x", x, dev, bf16)
    check_cuda_tensor("ln_scale", ln_scale, dev, bf16, (d,))
    check_cuda_tensor("ln_bias", ln_bias, dev, bf16, (d,))
    for name, (w_q, w_s, b) in zip(("q", "k", "v", "o"), (
            (wq_q, wq_s, bq), (wk_q, wk_s, bk), (wv_q, wv_s, bv),
            (wo_q, wo_s, bo))):
        w_s = w_s.reshape(-1)
        check_cuda_tensor(f"w{name}_q", w_q, dev, torch.int8, (d, d))
        check_cuda_tensor(f"w{name}_s", w_s, dev, torch.float32, (d,))
        check_cuda_tensor(f"b{name}", b, dev, bf16, (d,))
        operands += [w_q, w_s, b]
    if B == 0:
        return x.clone()

    import ctypes
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.kernel_function("emr2a_fused_ln_attention_int8",
                                [p] * 22 + [i] * 5 + [ctypes.c_float, p])
    T = B * S
    scratch = [torch.empty((T, d), dtype=torch.int8, device=dev),
               torch.empty((T,), dtype=torch.float32, device=dev),
               torch.empty((3, T, d), dtype=bf16, device=dev),
               torch.empty((T, d), dtype=torch.float32, device=dev),
               torch.empty((T, d), dtype=torch.int8, device=dev),
               torch.empty((T,), dtype=torch.float32, device=dev)]
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(*(t.data_ptr() for t in operands + scratch + [out]),
                 B, S, d, num_heads, valid_len, float(eps), stream)
    _build.check(err, "fused_ln_attention_int8")
    global INT8_LAUNCHES
    INT8_LAUNCHES += 1
    return out
