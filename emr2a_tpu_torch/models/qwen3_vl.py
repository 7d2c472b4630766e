"""Qwen3-VL in PyTorch: vision tower, text decoder and generation.

Port of ``emr2a_tpu/models/qwen3_vl.py`` with its names, its param layout
(``Dense`` kernels (in, out), the ``kernel_q`` / ``kernel_p4`` quantized
entries of ``models/quantize.quantize_qwen_text_params``) and its rounding
points: f32 norms, f32 rope, f32 attention logits and softmax with the
probabilities cast to the working dtype. A JAX param tree loads through
``models/convert.params_from_jax`` (``block_i`` -> ``blocks.i``,
``layer_i`` -> ``layers.i``, ``deepstack_merger_j`` -> ``deepstack_mergers.j``,
a norm's ``scale`` -> ``weight``).

Kernels on the path (CUDA tensors; a CPU tensor takes each kernel's plain
version):

- the vision tower's uniform frame-batched attention -> K8
  (``ops/vision_flash.frame_flash_attention``). ``attn_impl="auto"`` takes
  K8 on a CUDA tensor and the einsum path on the CPU (JAX: "scan" on a TPU,
  "einsum" elsewhere); mixed grids keep the flat masked einsum, as in JAX;
- the decoder projections route on what the params hold: ``kernel_p4`` ->
  K7 (``ops/linear_int4``), ``kernel_q`` -> K5 (``ops/linear_int8``), and
  the fused ``qkv_proj`` / ``gate_up_proj`` layout; an int8 ``lm_head`` ->
  K5;
- the decoder's attention at S <= 16 query positions (decode steps, a
  speculative verify, a short prefill chunk) over a bf16 KV cache -> K10
  (``ops/decode_attention``), which reads the cache in place through its
  strides with the caller's additive mask.

The rest of the decoder attention is plain PyTorch (XLA einsum in the JAX
package, not a Pallas kernel): the prefill (S > 16) over the repeated KV
heads, and the S <= 16 branch over an int8 cache (K10's plain version with
the cache's scales). So are the generator's options, which JAX computes in
XLA: the int8 KV cache (``quantize_kv``: s8 values with per-(batch,
position, head) f32 scales, folded into the attention as JAX folds them, K
scales onto the logits and V scales onto the probabilities), chunked
prefill (``chunked_prefill``; ``auto_prefill_chunk`` picks the chunk when
none is given, JAX's rule), per-row cache offsets (``cache_write`` with a
(B,) offset vector) and sampling (``sample_rows``, ``filtered_log_probs``:
temperature, top-k 50, top-p). The KV cache is written in place.

Decode (JAX: a ``lax.scan`` inside one jit) is ``Qwen3VLGenerator.
decode_step`` over a ``DecodeState`` it advances in place, reading its
position from a 0-d step counter on the device (``cache_write``'s 0-d
offset), so on a CUDA tensor ``generate`` replays it from a CUDA graph
(``models/cuda_graph.py``); on a CPU tensor it runs eagerly. The generator
keeps its graphs with their states by (batch, padded prompt, steps, greedy
or sampled), up to ``_KEPT_GRAPH_BYTES`` of KV cache, and refills a kept
state in place, so a later generation of the same shape only replays (JAX
keeps its compiled programs the same way; its states are new each call).

Divergence (ROADMAP.md Queue 3): the sampler is counter-based. Row b of a
generation seeded ``seed`` has the stream key ``stream_keys(seed, b)``;
its token g is a Gumbel-max over the filtered top-k whose uniforms hash
(``draw_keys(key, g)``, candidate), so a draw reads no generator state
and can be captured, and a request's stream depends only on its seed, row,
prompt and the model (the continuous batcher's slots use row 0). JAX
splits ``jax.random`` keys: the distribution is the same, the tokens are
not. Speculative acceptance (``spec_accept``, used by
``models/speculative.py`` and the batcher's speculative chunk) draws its
uniforms and its correction from the same hash, with the keys of
``spec_keys`` (per request stream, cycle and position). ``awq_taps``
reads the AWQ calibration's per-channel statistics (``models/awq.py``)
through forward pre-hooks registered only while it is open.

Tensor parallelism (JAX: params sharded by ``training/sharding_rules`` and
the KV cache anchored by ``constrain_kv_cache``, XLA inserting the
collectives): each module takes ``shard=(c, n)`` and is then card c's shard
of an n-card model axis, built at its local widths; ``tensor_parallel``
places a model's tensors by ``parallel.shard_params`` and builds a
``ShardedQwen3VLModel``, whose forward runs every card's shard in turn, one
layer at a time (``vision_forward``, ``text_forward``): each attention and
MLP part ends in ``row_parallel`` (an all-reduce by peer copies after
``o_proj`` / ``down_proj``, in the vision tower after ``o_proj``, ``fc2``
and the mergers' ``fc2``), and the residual is added after it. With one card
the reduce is the identity, so the plain model runs the same code.
"""

from __future__ import annotations

import logging
from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass, field, replace
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from emr2a_tpu_torch.models.cuda_graph import StepGraph
from emr2a_tpu_torch.models.layers import ACTIVATIONS, Dense, Int4Dense, Int8Dense
from emr2a_tpu_torch.ops.decode_attention import (
    MAX_QUERIES,
    decode_attention,
    decode_attention_reference,
)
from emr2a_tpu_torch.ops.vision_flash import (
    frame_flash_attention,
    frame_flash_attention_reference,
)
from emr2a_tpu_torch.parallel.mesh import MODEL_AXIS
from emr2a_tpu_torch.parallel.tensor import (
    all_gather,
    all_reduce,
    check_mesh,
    model_axis_size,
    model_devices,
    replicate,
    shard_params,
    shard_tensor,
)
from emr2a_tpu_torch.utils.profiling import annotate, count

# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class QwenVisionConfig:
    depth: int = 27
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 16
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    out_hidden_size: int = 3584
    num_position_embeddings: int = 2304
    deepstack_visual_indexes: Tuple[int, ...] = (8, 16, 24)
    hidden_act: str = "gelu_pytorch_tanh"
    dtype: torch.dtype = torch.float32
    # Frame-batched attention: "einsum", "flash" (K8 on a CUDA tensor, its
    # plain version on the CPU) or "auto" (flash on a CUDA tensor, einsum on
    # the CPU); JAX's "scan" is accepted and takes the einsum path.
    attn_impl: str = "auto"
    # The blocks' and mergers' LayerNorm eps, and the 2D rotary's layout:
    # Qwen rotates half against half (``rotate_half``), Kimi-VL's MoonViT
    # adjacent pairs (``rope_pairs``: pair j of a head's dims as one
    # complex number)
    layer_norm_eps: float = 1e-6
    rope_pairs: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size ** 2


@dataclass(frozen=True)
class QwenTextConfig:
    vocab_size: int = 151936
    hidden_size: int = 4096
    num_layers: int = 36
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 12288
    rms_norm_eps: float = 1e-6
    rope_theta: float = 5e6
    mrope_section: Tuple[int, int, int] = (24, 20, 20)
    attention_bias: bool = False
    tie_word_embeddings: bool = True
    hidden_act: str = "silu"
    dtype: torch.dtype = torch.float32


@dataclass(frozen=True)
class Qwen3VLConfig:
    vision: QwenVisionConfig = field(default_factory=QwenVisionConfig)
    text: QwenTextConfig = field(default_factory=QwenTextConfig)
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652


def qwen3_vl_8b_config(dtype: torch.dtype = torch.bfloat16) -> Qwen3VLConfig:
    """The public Qwen/Qwen3-VL-8B-Instruct geometry (the JAX package's
    ``scripts/exp_qwen_generate.py`` 8B build): untied lm_head, vision
    output width 4096."""
    return Qwen3VLConfig(
        vision=QwenVisionConfig(out_hidden_size=4096, dtype=dtype),
        text=QwenTextConfig(tie_word_embeddings=False, dtype=dtype))


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


class RMSNorm(nn.Module):

    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm``: f32 statistics with the fast variance
    E[x^2] - E[x]^2 (clipped at 0), ``(x - mean) * (rsqrt(var + eps) *
    scale) + bias``, then the working dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype, device=device))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((xf - mean) * mul + self.bias.float()).to(self.weight.dtype)


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _rotate_pairs(x):
    """(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...): adjacent pairs as
    complex numbers times i."""
    pairs = x.unflatten(-1, (-1, 2))
    return torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)


def apply_rope(q, k, cos, sin, pairs: bool = False):
    """q/k: (..., S, H, D); cos/sin broadcastable to (..., S, 1, D); in
    f32. ``pairs``: the rotation acts on adjacent pairs of dims (cos/sin
    repeat each angle twice) rather than on the two halves."""
    qf, kf = q.float(), k.float()
    cos, sin = cos.float(), sin.float()
    rotate = _rotate_pairs if pairs else _rotate_half
    q_out = qf * cos + rotate(qf) * sin
    k_out = kf * cos + rotate(kf) * sin
    return q_out.to(q.dtype), k_out.to(k.dtype)


# ---------------------------------------------------------------------------
# Vision tower
# ---------------------------------------------------------------------------


def vision_rope_cos_sin(grid_thw: Sequence[Tuple[int, int, int]],
                        head_dim: int, merge_size: int,
                        theta: float = 10000.0) -> Tuple[np.ndarray, np.ndarray]:
    """(seq, head_dim) cos/sin for the 2D vision RoPE, tokens in
    merge-block order (numpy, as the JAX package computes it)."""
    dim_quarter = head_dim // 4
    inv_freq = 1.0 / theta ** (np.arange(0, dim_quarter, dtype=np.float32)
                               * 2 / (head_dim // 2))
    all_coords = []
    for t, h, w in grid_thw:
        mh, mw = h // merge_size, w // merge_size
        block_rows = np.arange(mh)
        block_cols = np.arange(mw)
        intra = np.arange(merge_size)
        row_idx = (block_rows[:, None, None, None] * merge_size
                   + intra[None, None, :, None])
        col_idx = (block_cols[None, :, None, None] * merge_size
                   + intra[None, None, None, :])
        row_idx = np.broadcast_to(row_idx, (mh, mw, merge_size, merge_size)).reshape(-1)
        col_idx = np.broadcast_to(col_idx, (mh, mw, merge_size, merge_size)).reshape(-1)
        coords = np.stack([row_idx, col_idx], axis=-1)
        if t > 1:
            coords = np.tile(coords, (t, 1))
        all_coords.append(coords)
    coords = np.concatenate(all_coords, axis=0)
    freqs = coords[:, :, None].astype(np.float32) * inv_freq[None, None, :]
    freqs = freqs.reshape(coords.shape[0], -1)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return np.cos(emb), np.sin(emb)


def interpolated_pos_embed_indices(grid_thw: Sequence[Tuple[int, int, int]],
                                   num_grid_per_side: int, merge_size: int
                                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Bilinear interpolation of the (side x side) learned pos-embed table
    onto each grid: (4, seq) indices and (4, seq) f32 weights."""
    idx_list = [[] for _ in range(4)]
    w_list = [[] for _ in range(4)]
    for t, h, w in grid_thw:
        h_idxs = np.linspace(0, num_grid_per_side - 1, h, dtype=np.float32)
        w_idxs = np.linspace(0, num_grid_per_side - 1, w, dtype=np.float32)
        h_floor = h_idxs.astype(np.int64)
        w_floor = w_idxs.astype(np.int64)
        h_ceil = np.clip(h_floor + 1, None, num_grid_per_side - 1)
        w_ceil = np.clip(w_floor + 1, None, num_grid_per_side - 1)
        dh = h_idxs - h_floor
        dw = w_idxs - w_floor
        base_h = h_floor * num_grid_per_side
        base_h_ceil = h_ceil * num_grid_per_side
        indices = [
            (base_h[:, None] + w_floor[None]).reshape(-1),
            (base_h[:, None] + w_ceil[None]).reshape(-1),
            (base_h_ceil[:, None] + w_floor[None]).reshape(-1),
            (base_h_ceil[:, None] + w_ceil[None]).reshape(-1),
        ]
        weights = [
            ((1 - dh)[:, None] * (1 - dw)[None]).reshape(-1),
            ((1 - dh)[:, None] * dw[None]).reshape(-1),
            (dh[:, None] * (1 - dw)[None]).reshape(-1),
            (dh[:, None] * dw[None]).reshape(-1),
        ]
        for i in range(4):
            idx_list[i].append(indices[i])
            w_list[i].append(weights[i])
    idx = np.stack([np.concatenate(x) for x in idx_list])
    wts = np.stack([np.concatenate(x) for x in w_list]).astype(np.float32)
    return idx, wts


def vision_segment_mask(grid_thw: Sequence[Tuple[int, int, int]]
                        ) -> Optional[np.ndarray]:
    """Additive block-diagonal (seq, seq) mask confining attention to each
    frame; None for a single segment."""
    seg_ids = []
    sid = 0
    for t, h, w in grid_thw:
        for _ in range(t):
            seg_ids.extend([sid] * (h * w))
            sid += 1
    if sid <= 1:
        return None
    seg = np.asarray(seg_ids)
    return np.where(seg[:, None] == seg[None, :], 0.0,
                    -np.inf).astype(np.float32)


def permute_to_merge_order(flat: torch.Tensor,
                           grid_thw: Sequence[Tuple[int, int, int]],
                           merge_size: int) -> torch.Tensor:
    """Reorder per-image (t*h*w, D) row-major tokens into merge-block
    order."""
    outs = []
    offset = 0
    for t, h, w in grid_thw:
        n = h * w
        x = flat[offset:offset + n].repeat(t, 1)
        d = x.shape[-1]
        x = x.reshape(t, h // merge_size, merge_size, w // merge_size,
                      merge_size, d)
        outs.append(x.permute(0, 1, 3, 2, 4, 5).reshape(-1, d))
        offset += n
    return torch.cat(outs, dim=0)


def resolve_vision_attn_impl(cfg, x: Optional[torch.Tensor] = None) -> str:
    """The frame-batched attention lowering: ``cfg.attn_impl``, with "auto"
    taking K8 ("flash") on a CUDA tensor and "einsum" elsewhere. JAX's
    "scan" (one frame at a time, to cap a TPU's memory) is the einsum path
    here."""
    impl = getattr(cfg, "attn_impl", "auto")
    if impl == "auto":
        return "flash" if x is not None and x.device.type == "cuda" else "einsum"
    return "einsum" if impl == "scan" else impl


def row_parallel(projs: Sequence[nn.Module], inputs: Sequence[torch.Tensor]) -> list:
    """A row-parallel product over the model axis: card c's projection
    ``projs[c]`` applied to its slice ``inputs[c]`` of the contracted
    dimension, the result on every card. A ``Dense`` shard's partial
    products, in f32 (``Dense.partial``), are summed by ``all_reduce`` and
    rounded to the working dtype once, and its bias (replicated) is added
    after the sum; a quantized projection stays whole on every card
    (``training/sharding_rules``), so its input is made whole by
    ``all_gather`` and each card runs it as it is. With one card: the
    projection's own forward."""
    if len(projs) == 1:
        return [projs[0](inputs[0])]
    if not isinstance(projs[0], Dense):
        return [p(x) for p, x in zip(projs, all_gather(inputs))]
    dtype = projs[0].kernel.dtype
    out = [y.to(dtype) for y in all_reduce([p.partial(x) for p, x in zip(projs, inputs)])]
    if projs[0].bias is None:
        return out
    return [y + p.bias for y, p in zip(out, projs)]


def check_shardable(config, n: int) -> None:
    """``ValueError`` unless a model axis of ``n`` cards divides every
    sharded width: the text and vision heads, the text kv heads and the
    MLP and merger widths."""
    v, t = config.vision, config.text
    widths = {"text num_heads": t.num_heads, "text num_kv_heads": t.num_kv_heads,
              "text intermediate_size": t.intermediate_size,
              "vision num_heads": v.num_heads,
              "vision intermediate_size": v.intermediate_size,
              "vision merged width": v.hidden_size * v.spatial_merge_size ** 2}
    bad = {k: w for k, w in widths.items() if w % n}
    if bad:
        raise ValueError(f"a model axis of {n} cards does not divide "
                         + ", ".join(f"{k} = {w}" for k, w in bad.items()))


class QwenVisionBlock(nn.Module):
    """One vision block. ``shard=(c, n)`` builds card c's shard of an
    n-card model axis: num_heads / n heads (its q/k/v columns and o_proj
    rows) and intermediate_size / n MLP columns; ``(0, 1)`` is the whole
    block."""

    def __init__(self, cfg: QwenVisionConfig, device=None, shard=(0, 1)):
        super().__init__()
        self.config = cfg
        self.shard = tuple(shard)
        n = self.shard[1]
        self.num_heads = cfg.num_heads // n
        d, kw = cfg.hidden_size, dict(dtype=cfg.dtype, device=device)
        w, inter = self.num_heads * cfg.head_dim, cfg.intermediate_size // n
        self.norm1 = LayerNorm(d, cfg.layer_norm_eps, **kw)
        self.norm2 = LayerNorm(d, cfg.layer_norm_eps, **kw)
        self.q_proj = Dense(d, w, **kw)
        self.k_proj = Dense(d, w, **kw)
        self.v_proj = Dense(d, w, **kw)
        self.o_proj = Dense(w, d, **kw)
        self.fc1 = Dense(d, inter, **kw)
        self.fc2 = Dense(inter, d, **kw)

    def attention_context(self, x, cos, sin, attn_mask=None):
        """The attention of this shard's heads, before ``o_proj``: ``x``
        (seq, d) flat, or (frames, seq_per_frame, d) for uniform frames,
        whose per-frame attention goes to ``attn_impl``."""
        cfg = self.config
        S, lead = x.shape[-2], tuple(x.shape[:-2])
        h = self.norm1(x)
        hd = cfg.head_dim
        shape = lead + (S, self.num_heads, hd)
        q = self.q_proj(h).reshape(shape)
        k = self.k_proj(h).reshape(shape)
        v = self.v_proj(h).reshape(shape)
        q, k = apply_rope(q, k, cos[:, None, :], sin[:, None, :], cfg.rope_pairs)
        impl = (resolve_vision_attn_impl(cfg, x)
                if attn_mask is None and len(lead) == 1 else "einsum")
        if impl == "flash":
            attn = frame_flash_attention(q, k, v, hd ** -0.5)
        else:
            attn = frame_flash_attention_reference(q, k, v, hd ** -0.5, attn_mask)
        return attn.reshape(lead + (S, self.num_heads * hd))

    def mlp_hidden(self, x):
        """This shard's MLP columns, before ``fc2``."""
        return ACTIVATIONS[self.config.hidden_act](self.fc1(self.norm2(x)))

    def forward(self, x, cos, sin, attn_mask=None):
        return vision_block_step([self], [x], [(cos, sin, attn_mask)])[0]


def vision_block_step(blocks, xs, args) -> list:
    """One vision block over the model axis: card c runs ``blocks[c]`` on
    ``xs[c]`` (the hidden state, the same on every card) with its
    ``args[c]`` = (cos, sin, mask); each residual is added after its
    row-parallel sum."""
    ctx = [b.attention_context(x, *a) for b, x, a in zip(blocks, xs, args)]
    xs = [x + o for x, o in zip(xs, row_parallel([b.o_proj for b in blocks], ctx))]
    hidden = [b.mlp_hidden(x) for b, x in zip(blocks, xs)]
    return [x + m for x, m in zip(xs, row_parallel([b.fc2 for b in blocks], hidden))]


class QwenPatchMerger(nn.Module):
    """The patch merger; ``shard=(c, n)``: fc1's columns and fc2's rows of
    card c."""

    def __init__(self, cfg: QwenVisionConfig, use_postshuffle_norm: bool = False,
                 device=None, shard=(0, 1)):
        super().__init__()
        self.config = cfg
        self.use_postshuffle_norm = use_postshuffle_norm
        merged = cfg.hidden_size * cfg.spatial_merge_size ** 2
        kw = dict(dtype=cfg.dtype, device=device)
        self.norm = LayerNorm(merged if use_postshuffle_norm else cfg.hidden_size,
                              cfg.layer_norm_eps, **kw)
        self.fc1 = Dense(merged, merged // shard[1], **kw)
        self.fc2 = Dense(merged // shard[1], cfg.out_hidden_size, **kw)

    def hidden(self, x):
        """This shard's columns of gelu(fc1(norm(x))), before ``fc2``."""
        merged = self.config.hidden_size * self.config.spatial_merge_size ** 2
        if self.use_postshuffle_norm:
            x = self.norm(x.reshape(-1, merged))
        else:
            x = self.norm(x).reshape(-1, merged)
        return F.gelu(self.fc1(x), approximate="none")

    def forward(self, x):
        return merger_step([self], [x])[0]


def merger_step(mergers, xs) -> list:
    """A patch merger over the model axis, its output on every card."""
    return row_parallel([m.fc2 for m in mergers],
                        [m.hidden(x) for m, x in zip(mergers, xs)])


class QwenVisionTower(nn.Module):
    """pixel patches (seq, patch_dim) + grid_thw -> (merged tokens
    (seq/merge^2, out_hidden), deepstack list, taps). ``shard=(c, n)``
    builds card c's shard (its blocks' and mergers' shards; the patch
    embedding and the position table whole)."""

    def __init__(self, cfg: QwenVisionConfig, device=None, shard=(0, 1)):
        super().__init__()
        self.config = cfg
        kw = dict(dtype=cfg.dtype, device=device)
        self.patch_embed = Dense(cfg.patch_dim, cfg.hidden_size, **kw)
        self.pos_embed = nn.Parameter(torch.empty(
            cfg.num_position_embeddings, cfg.hidden_size, **kw))
        self.blocks = nn.ModuleList([QwenVisionBlock(cfg, device, shard)
                                     for _ in range(cfg.depth)])
        self.deepstack_mergers = nn.ModuleList([
            QwenPatchMerger(cfg, True, device, shard)
            for _ in cfg.deepstack_visual_indexes])
        self.merger = QwenPatchMerger(cfg, False, device, shard)

    def forward(self, patches: torch.Tensor,
                grid_thw: Tuple[Tuple[int, int, int], ...],
                tap_layers: Tuple[int, ...] = ()):
        return vision_forward([self], patches, grid_thw, tap_layers)


def vision_forward(towers, patches: torch.Tensor,
                   grid_thw: Tuple[Tuple[int, int, int], ...],
                   tap_layers: Tuple[int, ...] = ()):
    """The vision tower over the model axis: ``towers[c]`` is card c's
    shard. The patch embedding runs on the first card, the blocks on every
    card; the outputs are the first card's."""
    t0 = towers[0]
    cfg = t0.config
    dev = patches.device
    x = t0.patch_embed(patches)

    side = int(cfg.num_position_embeddings ** 0.5)
    idx, wts = interpolated_pos_embed_indices(grid_thw, side,
                                              cfg.spatial_merge_size)
    idx = torch.from_numpy(idx).to(dev)
    wts = torch.from_numpy(wts).to(dev)
    table = t0.pos_embed
    pos = (table[idx[0]] * wts[0][:, None] + table[idx[1]] * wts[1][:, None]
           + table[idx[2]] * wts[2][:, None] + table[idx[3]] * wts[3][:, None])
    pos = permute_to_merge_order(pos, grid_thw, cfg.spatial_merge_size)
    x = x + pos.to(x.dtype)

    cos_np, sin_np = vision_rope_cos_sin(grid_thw, cfg.head_dim,
                                         cfg.spatial_merge_size)
    cos, sin = torch.from_numpy(cos_np).to(dev), torch.from_numpy(sin_np).to(dev)
    # Uniform (h, w) grids attend per frame on an (F, seq_f, d) layout;
    # mixed layouts keep the flat block-diagonal mask.
    S_total = x.shape[0]
    frame_hws = [(h, w) for t, h, w in grid_thw for _ in range(t)]
    uniform = len(frame_hws) > 1 and len(set(frame_hws)) == 1
    attn_mask = None
    if uniform:
        seq_f = frame_hws[0][0] * frame_hws[0][1]
        x = x.reshape(len(frame_hws), seq_f, cfg.hidden_size)
        cos, sin = cos[:seq_f], sin[:seq_f]
    else:
        mask_np = vision_segment_mask(grid_thw)
        if mask_np is not None:
            attn_mask = torch.from_numpy(mask_np).to(dev)

    devices = [t.pos_embed.device for t in towers]
    xs = replicate(x, devices)
    args = list(zip(replicate(cos, devices), replicate(sin, devices),
                    replicate(attn_mask, devices)))
    deepstack, taps = [], []
    for i in range(len(t0.blocks)):
        xs = vision_block_step([t.blocks[i] for t in towers], xs, args)
        if i in cfg.deepstack_visual_indexes:
            j = cfg.deepstack_visual_indexes.index(i)
            deepstack.append(merger_step([t.deepstack_mergers[j] for t in towers], xs)[0])
        if i in tap_layers:
            taps.append(xs[0].reshape(S_total, cfg.hidden_size))
    return merger_step([t.merger for t in towers], xs)[0], deepstack, taps


# ---------------------------------------------------------------------------
# Text model
# ---------------------------------------------------------------------------


_ROPE_TABLES: Dict = {}


def _rope_tables(inv_freq: np.ndarray, mrope_section: Tuple[int, int, int],
                 device: torch.device):
    """The inverse frequencies and the h / w section masks on ``device``,
    copied there once: a decode step captured in a CUDA graph may not copy
    from the host."""
    key = (inv_freq.tobytes(), tuple(mrope_section), str(device))
    if key not in _ROPE_TABLES:
        idx = np.arange(inv_freq.shape[0])
        masks = []
        for dim, offset in ((1, 1), (2, 2)):
            length = mrope_section[dim] * 3
            masks.append(torch.from_numpy(
                (idx >= offset) & (idx < length) & ((idx - offset) % 3 == 0)).to(device))
        _ROPE_TABLES[key] = (torch.from_numpy(inv_freq).to(device), masks)
    return _ROPE_TABLES[key]


def mrope_cos_sin(position_ids: torch.Tensor, inv_freq: np.ndarray,
                  mrope_section: Tuple[int, int, int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """position_ids (3, B, S) -> cos/sin (B, S, head_dim), interleaved
    t/h/w frequency layout."""
    inv, masks = _rope_tables(inv_freq, mrope_section, position_ids.device)
    freqs = position_ids[..., None].float() * inv[None, None, None, :]
    freqs_t = freqs[0]
    for dim, mask in zip((1, 2), masks):
        freqs_t = torch.where(mask[None, None, :], freqs[dim], freqs_t)
    emb = torch.cat([freqs_t, freqs_t], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, position, head) absmax int8 quantization of fresh K/V
    rows: (B, S, KV, HD) -> (s8 values, f32 scales (B, S, KV)); scale =
    max(absmax / 127, 1e-8), values rounded half to even and clipped to
    +-127 (the JAX package's codes and scales, byte for byte)."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def cache_write(buf: torch.Tensor, fresh: torch.Tensor, cache_pos
                ) -> torch.Tensor:
    """Write ``fresh`` (B, S, ...) into ``buf`` (B, L, ...) in place (JAX
    returns a new buffer). ``cache_pos`` is one offset for every row, as an
    int (a slice) or a 0-d device tensor (an ``index_copy_``, the start
    clamped into [0, L - S] as JAX's ``dynamic_update_slice`` clamps a
    traced start), or a (B,) vector of per-row offsets (continuous
    batching: JAX's scatter with ``mode="drop"``): positions at or past L
    are dropped, never wrapped. No branch reads a value back to the host,
    so each can be captured in a CUDA graph."""
    B, S, L = fresh.shape[0], fresh.shape[1], buf.shape[1]
    fresh = fresh.to(buf.dtype)
    if isinstance(cache_pos, (int, np.integer)):
        buf[:, cache_pos:cache_pos + S] = fresh
        return buf
    pos = torch.as_tensor(cache_pos, device=buf.device).to(torch.int64)
    steps = torch.arange(S, device=buf.device)
    if pos.dim() == 0:
        return buf.index_copy_(1, torch.clamp(pos, 0, max(L - S, 0)) + steps, fresh)
    if pos.shape != (B,):
        raise ValueError(f"per-row offsets must be ({B},), got {tuple(pos.shape)}")
    cols = pos[:, None] + steps[None, :]
    cols = torch.where(cols < 0, cols + L, cols)   # JAX normalises negative indices
    keep = (cols >= 0) & (cols < L)
    # A dropped position rewrites the row's first kept position with that
    # position's own value (column 0 with its old value where the row keeps
    # none), so duplicate indices carry equal values and the write stays
    # exact without selecting the kept positions on the host.
    first = torch.argmax(keep.to(torch.int32), dim=1, keepdim=True)
    any_kept = keep.any(dim=1, keepdim=True)
    src = torch.where(keep, steps[None, :], first)
    dst = torch.where(keep, cols, torch.where(any_kept, cols.gather(1, first), 0))
    rows = torch.arange(B, device=buf.device)[:, None].expand(B, S)
    lead = any_kept.view(B, 1, *([1] * (buf.dim() - 2)))
    buf.index_put_((rows, dst), torch.where(lead, fresh[rows, src], buf[rows, dst]))
    return buf


class QwenTextDecoderLayer(nn.Module):
    """Qwen3 decoder layer. ``kinds`` maps a projection name to "dense",
    "int8" or "int4" (what its params hold); with ``qkv_proj`` /
    ``gate_up_proj`` in ``kinds`` the fused serving layout is built.

    ``shard=(c, n)`` builds card c's shard of an n-card model axis, by
    ``training/sharding_rules``: a dense projection holds its num_heads / n
    (q, o), num_kv_heads / n (k, v) or intermediate_size / n (gate, up,
    down) heads or columns; a quantized projection and the fused layout
    stay whole on every card, so the shard runs them whole and keeps its
    own heads' columns (a quantized column-parallel projection's bias is
    the shard's slice, added after). The forward splits into an attention
    part (``attention_context``, up to ``o_proj``) and an MLP part
    (``mlp_hidden``, up to ``down_proj``), each ended by ``row_parallel``
    over the cards (``decoder_layer_step``)."""

    def __init__(self, cfg: QwenTextConfig, kinds: Optional[Mapping[str, str]] = None,
                 device=None, shard=(0, 1)):
        super().__init__()
        self.config = cfg
        self.shard = tuple(shard)
        n = self.shard[1]
        kinds = dict(kinds or {})
        d, hd, I = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
        nq, nkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
        self.num_heads, self.num_kv_heads = cfg.num_heads // n, cfg.num_kv_heads // n
        kw = dict(dtype=cfg.dtype, device=device)
        self.input_ln = RMSNorm(d, cfg.rms_norm_eps, **kw)
        self.post_ln = RMSNorm(d, cfg.rms_norm_eps, **kw)
        self.q_norm_scale = nn.Parameter(torch.ones(hd, **kw))
        self.k_norm_scale = nn.Parameter(torch.ones(hd, **kw))
        # the projections each card runs whole
        self._whole = set()

        def make(name, n_in, n_out, bias, role=None):
            kind = kinds.get(name, "dense")
            cls = {"dense": Dense, "int8": Int8Dense, "int4": Int4Dense}[kind]
            if n == 1 or role is None:
                return cls(n_in, n_out, use_bias=bias, **kw)
            if kind == "dense":
                return cls(n_in // n if role == "row" else n_in,
                           n_out // n if role == "column" else n_out, use_bias=bias, **kw)
            self._whole.add(name)
            if role == "row" or not bias:
                return cls(n_in, n_out, use_bias=bias, **kw)
            proj = cls(n_in, n_out, use_bias=False, **kw)
            proj.bias = nn.Parameter(torch.zeros(n_out // n, **kw))
            return proj

        bias = cfg.attention_bias
        self.fused_qkv = "qkv_proj" in kinds
        self.fused_gate_up = "gate_up_proj" in kinds
        if self.fused_qkv:
            self.qkv_proj = make("qkv_proj", d, nq + 2 * nkv, bias)
        else:
            self.q_proj = make("q_proj", d, nq, bias, "column")
            self.k_proj = make("k_proj", d, nkv, bias, "column")
            self.v_proj = make("v_proj", d, nkv, bias, "column")
        self.o_proj = make("o_proj", nq, d, bias, "row")
        if self.fused_gate_up:
            self.gate_up_proj = make("gate_up_proj", d, 2 * I, False)
        else:
            self.gate_proj = make("gate_proj", d, I, False, "column")
            self.up_proj = make("up_proj", d, I, False, "column")
        self.down_proj = make("down_proj", I, d, False, "row")

    def _own(self, y):
        """This shard's columns of a whole projection's output."""
        rank, n = self.shard
        if n == 1:
            return y
        w = y.shape[-1] // n
        return y[..., rank * w:(rank + 1) * w]

    def _column(self, name, h):
        """This shard's columns of a column-parallel projection of ``h``."""
        proj = getattr(self, name)
        if name not in self._whole:
            return proj(h)
        y = self._own(proj.product(h))
        return y if proj.bias is None else y + proj.bias

    def attention_context(self, x, cos, sin, cache_kv, cache_pos, attn_mask):
        """x (B, S, D); cache_kv None or (k, v) of shape (B, L, KV, HD), this
        shard's kv heads; attn_mask (B, S, L_total) additive f32. Returns
        (this shard's heads' attention (B, S, heads * HD), before ``o_proj``,
        new_cache)."""
        cfg = self.config
        B, S, d = x.shape
        hd = cfg.head_dim
        H, KV = self.num_heads, self.num_kv_heads
        h = self.input_ln(x)
        if self.fused_qkv:
            nq, nkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
            qkv = self.qkv_proj(h)
            q, k, v = (self._own(t) for t in (qkv[..., :nq], qkv[..., nq:nq + nkv],
                                             qkv[..., nq + nkv:]))
        else:
            q, k, v = (self._column(name, h) for name in ("q_proj", "k_proj", "v_proj"))
        q = q.reshape(B, S, H, hd)
        k = k.reshape(B, S, KV, hd)
        v = v.reshape(B, S, KV, hd)
        q = rms_norm(q, self.q_norm_scale, cfg.rms_norm_eps)
        k = rms_norm(k, self.k_norm_scale, cfg.rms_norm_eps)
        q, k = apply_rope(q, k, cos[:, :, None, :], sin[:, :, None, :])

        kq_scale = vq_scale = None   # (B, L, KV) f32 scales of an s8 cache
        if cache_kv is not None and len(cache_kv) == 4:
            # int8 KV cache: the fresh rows quantized at write time; the
            # scales are folded into the attention below
            ck, cks, cv, cvs = cache_kv
            k_q, k_s = quantize_kv(k)
            v_q, v_s = quantize_kv(v)
            ck, cks = cache_write(ck, k_q, cache_pos), cache_write(cks, k_s, cache_pos)
            cv, cvs = cache_write(cv, v_q, cache_pos), cache_write(cvs, v_s, cache_pos)
            k_all, v_all, kq_scale, vq_scale = ck, cv, cks, cvs
            new_cache = (ck, cks, cv, cvs)
        elif cache_kv is not None:
            ck = cache_write(cache_kv[0], k, cache_pos)
            cv = cache_write(cache_kv[1], v, cache_pos)
            k_all, v_all = ck, cv
            new_cache = (ck, cv)
        else:
            k_all, v_all = k, v
            new_cache = None

        # GQA: decode (small S) against the un-repeated cache; prefill with
        # the repeated heads, as the JAX package lowers the two.
        groups = H // KV
        scale = hd ** -0.5
        if S <= MAX_QUERIES and kq_scale is None and k_all.dtype == torch.bfloat16:
            # K10 on a CUDA tensor, its plain version on the CPU
            attn = decode_attention(q, k_all, v_all, attn_mask, scale)
        elif S <= MAX_QUERIES:
            attn = decode_attention_reference(q, k_all, v_all, attn_mask, scale,
                                              kq_scale, vq_scale)
        else:
            k_rep = torch.repeat_interleave(k_all, groups, dim=2)
            v_rep = torch.repeat_interleave(v_all, groups, dim=2)
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_rep.float()) * scale
            if kq_scale is not None:
                ks_rep = torch.repeat_interleave(kq_scale, groups, dim=2)
                logits = logits * ks_rep.transpose(1, 2)[:, :, None, :]
            logits = logits + attn_mask[:, None, :, :]
            probs = torch.softmax(logits, dim=-1)
            del logits
            if vq_scale is not None:
                vs_rep = torch.repeat_interleave(vq_scale, groups, dim=2)
                probs = probs * vs_rep.transpose(1, 2)[:, :, None, :]
            probs = probs.to(cfg.dtype)
            attn = torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                                v_rep.float()).to(cfg.dtype)
        return attn.reshape(B, S, H * hd), new_cache

    def mlp_hidden(self, x):
        """silu(gate) * up over this shard's intermediate columns, before
        ``down_proj``."""
        h = self.post_ln(x)
        I = self.config.intermediate_size
        if self.fused_gate_up:
            gu = self.gate_up_proj(h)
            gate, up = self._own(gu[..., :I]), self._own(gu[..., I:])
        else:
            gate, up = self._column("gate_proj", h), self._column("up_proj", h)
        return ACTIVATIONS[self.config.hidden_act](gate) * up

    def forward(self, x, cos, sin, cache_kv, cache_pos, attn_mask):
        """x (B, S, D); cache_kv None or (k, v) of shape (B, L, KV, HD);
        attn_mask (B, S, L_total) additive f32. Returns (x, new_cache)."""
        (x,), (cache,) = decoder_layer_step([self], [x], [(cos, sin, cache_kv, cache_pos,
                                                            attn_mask)])
        return x, cache


def decoder_layer_step(layers, xs, args):
    """One decoder layer over the model axis: card c runs ``layers[c]`` on
    ``xs[c]`` (the hidden state, the same on every card) with ``args[c]`` =
    (cos, sin, its cache, cache_pos, mask). Each residual is added after its
    row-parallel sum. Returns (xs, the cards' new caches)."""
    ctx, caches = zip(*(l.attention_context(x, *a) for l, x, a in zip(layers, xs, args)))
    xs = [x + o for x, o in zip(xs, row_parallel([l.o_proj for l in layers], ctx))]
    hidden = [l.mlp_hidden(x) for l, x in zip(layers, xs)]
    xs = [x + m for x, m in zip(xs, row_parallel([l.down_proj for l in layers], hidden))]
    return xs, list(caches)


class Embed(nn.Module):
    """``flax.linen.Embed``: an ``embedding`` table (vocab, d)."""

    def __init__(self, num: int, dim: int, dtype=torch.float32, device=None):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num, dim, dtype=dtype, device=device))

    def forward(self, ids):
        return self.embedding[ids]


class QwenTextModel(nn.Module):

    def __init__(self, cfg: QwenTextConfig, kinds: Optional[Mapping[str, str]] = None,
                 device=None, shard=(0, 1)):
        """``kinds``: ``"layers.i.<proj>"`` / ``"lm_head"`` -> "dense",
        "int8" or "int4"; ``shard=(c, n)``: card c's shard of the layers
        (the embedding, the final norm and ``lm_head`` whole)."""
        super().__init__()
        self.config = cfg
        kinds = dict(kinds or {})
        kw = dict(dtype=cfg.dtype, device=device)
        self.embed_tokens = Embed(cfg.vocab_size, cfg.hidden_size, **kw)
        self.layers = nn.ModuleList([
            QwenTextDecoderLayer(cfg, {k.split(".", 2)[2]: v for k, v in kinds.items()
                                       if k.startswith(f"layers.{i}.")}, device, shard)
            for i in range(cfg.num_layers)])
        self.final_ln = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        if not cfg.tie_word_embeddings:
            cls = Int8Dense if kinds.get("lm_head") == "int8" else Dense
            self.lm_head = cls(cfg.hidden_size, cfg.vocab_size, use_bias=False, **kw)

    @property
    def inv_freq(self) -> np.ndarray:
        cfg = self.config
        return 1.0 / cfg.rope_theta ** (
            np.arange(0, cfg.head_dim, 2, dtype=np.float32) / cfg.head_dim)

    def forward(self, inputs_embeds, position_ids, cache=None, cache_pos=0,
                attn_mask=None, visual_mask=None, deepstack=None,
                visual_gather_idx=None, return_hidden: bool = False):
        """inputs_embeds (B, S, D); position_ids (3, B, S); cache: list of
        per-layer (k, v) or None; attn_mask (B, S, L) additive. Returns
        (logits or hidden, new_cache)."""
        x, new_cache = text_forward([self], inputs_embeds, position_ids, cache, cache_pos,
                                    attn_mask, visual_mask, deepstack, visual_gather_idx)
        if return_hidden:
            return x, new_cache
        return self.project(x), new_cache

    def project(self, hidden):
        """Vocabulary projection (callers project only the positions they
        need)."""
        if self.config.tie_word_embeddings:
            return hidden @ self.embed_tokens.embedding.T.to(hidden.dtype)
        return self.lm_head(hidden)          # an Int8Dense runs K5


class ShardedCache(list):
    """A KV cache split over the model axis: entry c is card c's per-layer
    cache, its kv heads (``kv_cache_sharding_specs``)."""


def cache_tensors(cache) -> list:
    """Every buffer of a KV cache, plain or sharded."""
    shards = cache if isinstance(cache, ShardedCache) else [cache]
    return [t for part in shards for layer in part for t in layer]


def map_cache(fn, *caches):
    """``fn`` over the buffers of KV caches of one layout (plain or
    sharded), buffer by buffer: a cache of the results."""
    if isinstance(caches[0], ShardedCache):
        return ShardedCache(map_cache(fn, *parts) for parts in zip(*caches))
    return [tuple(fn(*bufs) for bufs in zip(*layers)) for layers in zip(*caches)]


def text_forward(models, inputs_embeds, position_ids, cache=None, cache_pos=0,
                 attn_mask=None, visual_mask=None, deepstack=None,
                 visual_gather_idx=None):
    """The decoder over the model axis: ``models[c]`` is card c's shard.
    The inputs lie on the first card and are copied to every card; the
    hidden state is kept on every card; ``cache`` is a plain cache for one
    card and a ``ShardedCache`` for several. Returns (the final-norm hidden
    state on the first card, the new cache)."""
    cfg = models[0].config
    n = len(models)
    x = inputs_embeds
    if attn_mask is None:
        B, S, _ = x.shape
        q_idx = torch.arange(S, device=x.device)[:, None]
        k_idx = torch.arange(S, device=x.device)[None, :]
        attn_mask = torch.where(k_idx <= q_idx, 0.0, float("-inf"))[None]
        attn_mask = attn_mask.float().expand(B, S, S)
    devices = [m.final_ln.weight.device for m in models]
    xs = replicate(x, devices)
    rope = [mrope_cos_sin(p, models[0].inv_freq, cfg.mrope_section)
            for p in replicate(position_ids, devices)]
    masks = replicate(attn_mask, devices)
    offsets = replicate(cache_pos, devices)
    caches = [None] * n if cache is None else (cache if n > 1 else [cache])
    n_deep = len(deepstack) if deepstack else 0
    if n_deep and visual_mask is not None:
        if visual_gather_idx is None:
            visual_gather_idx = visual_gather_indices(visual_mask, deepstack[0].shape[0])
        vis = list(zip(replicate(visual_mask[..., None], devices),
                       replicate(visual_gather_idx, devices)))
        deep = [replicate(ds, devices) for ds in deepstack]
    new_caches = [[] for _ in models]
    for i in range(len(models[0].layers)):
        args = [(cos, sin, None if c is None else c[i], cp, m)
                for (cos, sin), c, cp, m in zip(rope, caches, offsets, masks)]
        xs, layer_caches = decoder_layer_step([m.layers[i] for m in models], xs, args)
        for new, layer_cache in zip(new_caches, layer_caches):
            new.append(layer_cache)
        if i < n_deep and visual_mask is not None:
            xs = [x + torch.where(vm, ds[gi].to(x.dtype),
                                  torch.zeros((), dtype=x.dtype, device=x.device))
                  for x, (vm, gi), ds in zip(xs, vis, deep[i])]
    x = models[0].final_ln(xs[0])
    return x, (ShardedCache(new_caches) if n > 1 else new_caches[0])


# ---------------------------------------------------------------------------
# Full model + generation
# ---------------------------------------------------------------------------


# Per-layer f32 vision attention-logits budget of the one-shot vision
# forward (heads x frames x seq_f^2 x 4 bytes), the JAX package's value.
_VISION_TEMP_BUDGET = 1 * 2**30


def plan_vision_groups(vision_cfg, grid_thw,
                       budget: int = None) -> Optional[list]:
    """Split a many-image forward into image groups whose attention temps
    fit ``budget`` bytes, or None for the one-shot call:
    [(img_lo, img_hi, patch_lo, patch_hi), ...]. Only uniform layouts
    group; vision attention never crosses a frame, so grouping is exact."""
    if budget is None:
        budget = _VISION_TEMP_BUDGET
    if len(grid_thw) <= 1:
        return None
    if len({(t, h, w) for t, h, w in grid_thw}) != 1:
        return None
    t0, h0, w0 = grid_thw[0]
    seq_f = h0 * w0
    per_frame = vision_cfg.num_heads * seq_f * seq_f * 4
    total_frames = sum(t for t, _, _ in grid_thw)
    if total_frames * per_frame <= budget:
        return None
    frames_per_img = grid_thw[0][0]
    imgs_per_group = max(1, budget // (per_frame * max(1, frames_per_img)))
    groups = []
    patches_per_img = t0 * seq_f
    for lo in range(0, len(grid_thw), imgs_per_group):
        hi = min(lo + imgs_per_group, len(grid_thw))
        groups.append((lo, hi, lo * patches_per_img, hi * patches_per_img))
    return groups


def visual_gather_indices(mask: torch.Tensor, table_len: int) -> torch.Tensor:
    """(B, S) image-token mask -> indices into the flat batch image-token
    table (row b's k-th image token reads table[offset_b + k])."""
    counts = mask.sum(dim=-1)
    offsets = torch.cumsum(counts, dim=0) - counts
    idx = torch.cumsum(mask.to(torch.int64), dim=-1) - 1 + offsets[:, None]
    return torch.clamp(idx, 0, table_len - 1)


def linear_kinds(state: Mapping[str, torch.Tensor]) -> Dict[str, str]:
    """What each projection's params hold, from a state dict's names:
    ``{"language_model.layers.0.q_proj": "int4", ...}`` for every entry
    with ``kernel_p4`` ("int4"), ``kernel_q`` ("int8") or ``kernel``
    ("dense")."""
    kinds = {}
    for key in state:
        for leaf, kind in ((".kernel_p4", "int4"), (".kernel_q", "int8"),
                           (".kernel", "dense")):
            if key.endswith(leaf):
                kinds[key[:-len(leaf)]] = kind
    return kinds


class Qwen3VLModel(nn.Module):
    """Multimodal forward: ids + optional image patches -> logits.

    What the generator and the batcher ask of a model (``models/kimi_vl``'s
    has the same): ``position_ids`` (the rope positions of a prompt, on the
    host: M-RoPE's three axes here), ``position_axes`` (their leading
    size, which a decode step's positions take), ``empty_cache`` and
    ``cache_bytes_per_row``."""

    position_axes = 3

    def __init__(self, config: Qwen3VLConfig,
                 kinds: Optional[Mapping[str, str]] = None, device=None, shard=(0, 1)):
        super().__init__()
        self.config = config
        lm = "language_model."
        self.visual = QwenVisionTower(config.vision, device, shard)
        self.language_model = QwenTextModel(
            config.text, {k[len(lm):]: v for k, v in (kinds or {}).items()
                          if k.startswith(lm)}, device, shard)

    @classmethod
    def from_params(cls, config: Qwen3VLConfig,
                    state: Mapping[str, torch.Tensor], shard=(0, 1)) -> "Qwen3VLModel":
        """The model over ``state`` (this package's names, e.g. from
        ``params_from_jax``), taking its tensors as they are: no copy, so
        models built from states that share tensors share memory. Each
        projection's kind (dense, int8, int4, fused) follows its params.
        ``shard=(c, n)``: ``state`` is card c's part of ``parallel.
        shard_params``' split over n cards. Inference only: no parameter
        requires a gradient."""
        model = cls(config, linear_kinds(state), device="meta", shard=shard)
        model.load_state_dict(dict(state), strict=True, assign=True)
        return model.requires_grad_(False)

    def empty_cache(self, batch: int, max_len: int, kv_dtype: str):
        """A zeroed KV cache for this model, on its device."""
        return empty_kv_cache(self.config.text, batch, max_len, kv_dtype,
                              self.language_model.final_ln.weight.device)

    def cache_bytes_per_row(self, max_len: int, kv_dtype: str) -> int:
        """The KV cache's bytes for one row of ``max_len`` positions."""
        cfg = self.config.text
        kv = max_len * cfg.num_kv_heads * cfg.head_dim
        if kv_dtype == "int8":
            per_layer = 2 * (kv + max_len * cfg.num_kv_heads * 4)
        else:
            per_layer = 2 * kv * 2
        return per_layer * cfg.num_layers

    def position_ids(self, input_ids: np.ndarray, grid_thw) -> np.ndarray:
        """(3, B, S) M-RoPE positions of ``input_ids`` (B, S)
        (``compute_mrope_position_ids``)."""
        return compute_mrope_position_ids(input_ids, grid_thw, self.config.image_token_id,
                                          self.config.vision.spatial_merge_size)

    @classmethod
    def random_init(cls, config: Qwen3VLConfig, seed: int = 0, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> "Qwen3VLModel":
        """Random weights drawn on ``device`` from
        ``torch.Generator(device).manual_seed(seed)`` (not ``jax.random``'s):
        kernels, embeddings and the position table N(0, 0.02), biases zero,
        norm scales one. ``dtype`` defaults to the configs'."""
        return cls.from_params(config, random_state(config, seed, device, dtype))

    def embed_multimodal(self, input_ids, pixel_patches, grid_thw):
        """Token embeddings with the image embeddings spliced at the
        image-token positions: (embeds, visual_mask, deepstack). Many-image
        prompts run the tower in image groups (``plan_vision_groups``)."""
        lm = self.language_model
        embeds = lm.embed_tokens(input_ids).to(lm.config.dtype)
        if pixel_patches is None:
            return embeds, None, None
        groups = plan_vision_groups(self.config.vision, grid_thw)
        if groups is None:
            image_embeds, deepstack, _ = self.visual(pixel_patches, grid_thw)
        else:
            emb_parts, deep_parts = [], None
            for img_lo, img_hi, p_lo, p_hi in groups:
                e, d, _ = self.visual(pixel_patches[p_lo:p_hi],
                                      grid_thw[img_lo:img_hi])
                emb_parts.append(e)
                if deep_parts is None:
                    deep_parts = [[x] for x in d]
                else:
                    for lvl, x in zip(deep_parts, d):
                        lvl.append(x)
            image_embeds = torch.cat(emb_parts, dim=0)
            deepstack = [torch.cat(lvl, dim=0) for lvl in (deep_parts or [])]
        mask = input_ids == self.config.image_token_id
        gather_idx = visual_gather_indices(mask, image_embeds.shape[0])
        spliced = image_embeds[gather_idx].to(embeds.dtype)
        embeds = torch.where(mask[..., None], spliced, embeds)
        return embeds, mask, deepstack

    def forward(self, input_ids, position_ids, pixel_patches=None,
                grid_thw=(), cache=None, cache_pos=0, attn_mask=None,
                return_hidden: bool = False):
        embeds, visual_mask, deepstack = self.embed_multimodal(
            input_ids, pixel_patches, grid_thw)
        return self.language_model(
            embeds, position_ids, cache=cache, cache_pos=cache_pos,
            attn_mask=attn_mask, visual_mask=visual_mask,
            deepstack=deepstack, return_hidden=return_hidden)


def random_state(config: Qwen3VLConfig, seed: int = 0, device="cuda",
                 dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """A random state dict for ``Qwen3VLModel`` (see ``random_init``),
    drawn on ``device`` in name order."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = Qwen3VLModel(config, device="meta").state_dict()
    state = {}
    for name, ref in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        dt = dtype or ref.dtype
        if leaf in ("kernel", "embedding", "pos_embed"):
            t = torch.randn(ref.shape, generator=gen, device=device) * 0.02
            state[name] = t.to(dt)
        elif leaf == "bias":
            state[name] = torch.zeros(ref.shape, dtype=dt, device=device)
        else:                                   # norm scales
            state[name] = torch.ones(ref.shape, dtype=dt, device=device)
    return state


class _ShardedVisionTower(nn.Module):
    """The vision shards of a ``ShardedQwen3VLModel``, one per card, run
    together by ``vision_forward``."""

    def __init__(self, shards):
        super().__init__()
        self.shards = nn.ModuleList(shards)
        self.config = shards[0].config

    def forward(self, patches, grid_thw, tap_layers=()):
        return vision_forward(list(self.shards), patches, grid_thw, tap_layers)


class _ShardedTextModel(nn.Module):
    """The decoder shards of a ``ShardedQwen3VLModel``, one per card, run
    together by ``text_forward``; the embedding, the final norm and the
    vocabulary projection are the first card's."""

    def __init__(self, shards):
        super().__init__()
        self.shards = nn.ModuleList(shards)
        self.config = shards[0].config

    embed_tokens = property(lambda self: self.shards[0].embed_tokens)
    final_ln = property(lambda self: self.shards[0].final_ln)

    def forward(self, inputs_embeds, position_ids, cache=None, cache_pos=0,
                attn_mask=None, visual_mask=None, deepstack=None,
                visual_gather_idx=None, return_hidden: bool = False):
        x, new_cache = text_forward(list(self.shards), inputs_embeds, position_ids, cache,
                                    cache_pos, attn_mask, visual_mask, deepstack,
                                    visual_gather_idx)
        return (x if return_hidden else self.project(x)), new_cache

    def project(self, hidden):
        return self.shards[0].project(hidden)


class ShardedQwen3VLModel(Qwen3VLModel):
    """Qwen3-VL served tensor-parallel over the ``model`` axis of ``mesh``
    (Megatron, by ``training/sharding_rules``): card c holds shard c of the
    model (``Qwen3VLModel(shard=(c, n))`` over ``parallel.shard_params``'
    part c), and one thread runs the cards in turn, layer by layer. The
    hidden state is kept on every card; each attention and MLP part ends in
    ``row_parallel``'s all-reduce; the KV cache is a ``ShardedCache`` of
    each card's kv heads. Inputs and outputs lie on the first card, where
    the embedding and the vocabulary projection run. Same interface as
    ``Qwen3VLModel``; build it with ``tensor_parallel``."""

    def __init__(self, config: Qwen3VLConfig, shards: Sequence[Qwen3VLModel], mesh):
        nn.Module.__init__(self)
        self.config = config
        self.mesh = mesh
        self.visual = _ShardedVisionTower([m.visual for m in shards])
        self.language_model = _ShardedTextModel([m.language_model for m in shards])

    @property
    def devices(self) -> list:
        return [m.final_ln.weight.device for m in self.language_model.shards]

    def empty_cache(self, batch: int, max_len: int, kv_dtype: str):
        return empty_kv_cache(self.config.text, batch, max_len, kv_dtype, mesh=self.mesh)


def tensor_parallel(model: Qwen3VLModel, mesh) -> Qwen3VLModel:
    """``model`` served over the ``model`` axis of ``mesh`` (a
    ``parallel.Mesh``; anything else raises ``TypeError``): with one card,
    a ``Qwen3VLModel`` over the same tensors moved to it (the same code as
    ``mesh=None``); with n cards, a ``ShardedQwen3VLModel`` over
    ``shard_params`` of the model's tensors (a model already sharded over
    ``mesh`` is returned as it is). Raises ``ValueError`` where n does not
    divide the text or vision heads (``check_shardable``)."""
    check_mesh(mesh)
    if isinstance(model, ShardedQwen3VLModel):
        if model.mesh is not mesh:
            raise ValueError("the model is sharded over another mesh")
        return model
    n = model_axis_size(mesh)
    check_shardable(model.config, n)
    parts = shard_params(model.state_dict(), mesh)
    if n == 1:
        return Qwen3VLModel.from_params(model.config, parts[0])
    return ShardedQwen3VLModel(
        model.config, [Qwen3VLModel.from_params(model.config, part, shard=(c, n))
                       for c, part in enumerate(parts)], mesh)


def compute_mrope_position_ids(input_ids: np.ndarray,
                               grid_thw: Sequence[Tuple[int, int, int]],
                               image_token_id: int,
                               merge_size: int = 2) -> np.ndarray:
    """Host-side M-RoPE position ids (3, B, S): text tokens advance all
    three axes together; each image block gets t/h/w grid positions.
    ``grid_thw`` is consumed flat in batch-row-major order."""
    B, S = input_ids.shape
    out = np.zeros((3, B, S), dtype=np.int64)
    img_i = 0
    for b in range(B):
        ids = input_ids[b]
        pos_chunks = []
        st = 0
        image_positions = np.where(ids == image_token_id)[0]
        runs = []
        if len(image_positions):
            run_start = image_positions[0]
            prev = image_positions[0]
            for p in image_positions[1:]:
                if p != prev + 1:
                    runs.append((run_start, prev))
                    run_start = p
                prev = p
            runs.append((run_start, prev))
        for run_start, run_end in runs:
            text_len = run_start - st
            st_idx = pos_chunks[-1].max() + 1 if pos_chunks else 0
            if text_len > 0:
                pos_chunks.append(
                    np.broadcast_to(np.arange(text_len), (3, text_len)) + st_idx)
                st_idx = pos_chunks[-1].max() + 1
            t, h, w = grid_thw[img_i]
            img_i += 1
            gh, gw = h // merge_size, w // merge_size
            t_index = np.repeat(np.arange(t), gh * gw)
            h_index = np.tile(np.repeat(np.arange(gh), gw), t)
            w_index = np.tile(np.arange(gw), t * gh)
            pos_chunks.append(np.stack([t_index, h_index, w_index]) + st_idx)
            st = run_end + 1
        if st < S:
            st_idx = pos_chunks[-1].max() + 1 if pos_chunks else 0
            text_len = S - st
            pos_chunks.append(
                np.broadcast_to(np.arange(text_len), (3, text_len)) + st_idx)
        out[:, b, :] = np.concatenate(pos_chunks, axis=1)
    return out


# Sampling restricts to the top-k logits before the nucleus (top-p) filter;
# k = 50 is the JAX package's value (Hugging Face's GenerationConfig default)
SAMPLE_TOP_K = 50


def _top_k_nucleus(logits: torch.Tensor, temp: torch.Tensor, top_p: torch.Tensor):
    """The temperature-scaled top-k(SAMPLE_TOP_K) logits (B, k), descending,
    with -inf past the nucleus (the smallest prefix of mass >= top_p,
    always at least one), and their vocabulary indices."""
    scaled = logits.float() / torch.clamp(temp.float(), min=1e-6)[:, None]
    vals, idx = torch.topk(scaled, min(SAMPLE_TOP_K, scaled.shape[-1]), dim=-1)
    probs = torch.softmax(vals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = torch.sum(cum - probs < top_p.float()[:, None], dim=-1)
    cutoff = torch.gather(vals, -1, (keep - 1)[:, None])
    return torch.where(vals < cutoff, float("-inf"), vals), idx


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32), in two 16-bit halves
    of ``c`` so that no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (a bijection of [0, 2^32)) on int64 tensors."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def stream_keys(seeds, rows) -> torch.Tensor:
    """Per-row sampler stream keys from seeds and row numbers (int64
    tensors or ints, broadcast): a request's stream depends on its seed and
    its row of the seed's batch, nothing else."""
    seeds = torch.as_tensor(seeds, dtype=torch.int64)
    rows = torch.as_tensor(rows, dtype=torch.int64, device=seeds.device)
    k = _mix32((seeds & _M32) ^ 0x9E3779B9)
    k = _mix32(k ^ ((seeds >> 32) & _M32))
    return _mix32(k ^ (rows & _M32))


def draw_keys(streams: torch.Tensor, index) -> torch.Tensor:
    """The keys of draw ``index`` (the position of the token in its row's
    generated stream: an int or an int64 tensor, broadcast) of each
    stream."""
    index = torch.as_tensor(index, dtype=torch.int64, device=streams.device)
    return _mix32(streams ^ _mix32((index & _M32) ^ 0x632BE5AB))


def sample_rows(logits: torch.Tensor, keys, temp: torch.Tensor,
                top_p: torch.Tensor) -> torch.Tensor:
    """Per-row temperature / top-k(50) / top-p sampling over (B, vocab)
    logits; rows with temp <= 0 take the raw argmax, exactly the greedy
    path. ``keys`` (B,) int64 are the rows' draw keys (``draw_keys``).
    Each kept candidate gets a uniform from a hash of (key, candidate) and
    the draw is the Gumbel-max over the filtered candidates, so a draw
    reads no state but its key and can be captured in a CUDA graph (JAX:
    per-row PRNG keys and ``jax.random.categorical``, also a Gumbel-max)."""
    greedy = torch.argmax(logits, dim=-1)
    filtered, idx = _top_k_nucleus(logits, temp, top_p)
    salt = _mix32(torch.arange(filtered.shape[-1], device=logits.device) + 0x2545F491)
    bits = _mix32(keys[:, None] ^ salt[None, :])
    u = ((bits >> 8).float() + 0.5) * 2.0 ** -24
    choice = torch.argmax(filtered - torch.log(-torch.log(u)), dim=-1, keepdim=True)
    sampled = torch.gather(idx, -1, choice)[:, 0]
    return torch.where(temp <= 0, greedy, sampled)


def filtered_log_probs(logits: torch.Tensor, temp: torch.Tensor,
                       top_p: torch.Tensor) -> torch.Tensor:
    """Full-vocabulary (B, V) log-probabilities of the ``sample_rows``
    distribution, -inf outside its support; rows with temp <= 0 are a point
    mass on the argmax."""
    B, V = logits.shape
    filtered, idx = _top_k_nucleus(logits, temp, top_p)
    full = torch.full((B, V), float("-inf"), device=logits.device)
    full.scatter_(1, idx, torch.log_softmax(filtered, dim=-1))
    vocab = torch.arange(V, device=logits.device)
    greedy = torch.where(vocab[None, :] == torch.argmax(logits, dim=-1, keepdim=True),
                         0.0, float("-inf"))
    return torch.where((temp <= 0)[:, None], greedy, full)


def spec_keys(streams: torch.Tensor, index, width: int) -> torch.Tensor:
    """(B, width) keys of the speculative cycle that starts at generated
    position ``index`` (an int or an int64 tensor, broadcast with
    ``streams``): column j < k keys the draft's draw j, column k + 1 the
    acceptance (``spec_accept``). A cycle's keys are the draw key of its
    first position (``draw_keys(streams, index)``) hashed with the column,
    so a speculative stream depends on its seed, the cycle's position and
    the column, nothing else."""
    base = draw_keys(streams, index)
    salt = _mix32(torch.arange(width, device=streams.device) + 0x5BD1E995)
    return _mix32(base[..., None] ^ salt)


def spec_accept(drafts: torch.Tensor, q_lp: torch.Tensor, p_lp: torch.Tensor,
                keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Speculative rejection-sampling acceptance (the lossless scheme, JAX's
    ``spec_accept``): accept draft x_j with probability min(1, p_j(x_j) /
    q_j(x_j)); at the first rejection draw the correction from
    normalize(max(p_j - q_j, 0)); when all k drafts are accepted draw the
    bonus token from p_k. The emitted prefix is distributed exactly as
    sampling from the target alone; with point-mass (greedy) rows it is the
    longest argmax-matching prefix.

    drafts (B, k) proposals drawn from q; q_lp (B, k, V) the draft's
    log-probabilities at each proposal; p_lp (B, k + 1, V) the target's
    (``filtered_log_probs``: at most ``SAMPLE_TOP_K`` tokens in each
    support); keys (B,) int64 (column k + 1 of ``spec_keys``). Returns
    (emitted (B, k + 1) int64, n_acc (B,)): emitted[:, :n_acc] are the
    accepted drafts, emitted[:, n_acc] the correction or bonus.

    Divergence (ROADMAP.md Queue 3): the uniforms and the correction's draw
    are counter-based, not ``jax.random`` splits: uniform j hashes (key, j),
    and the correction is a Gumbel-max over the top ``SAMPLE_TOP_K``
    candidates of its distribution (the residual's support lies inside p's
    filtered support) with uniforms hashing (key, candidate). The law is
    JAX's; the tokens are not. Nothing is read back to the host, so a cycle
    that calls it can be captured in a CUDA graph."""
    B, k = drafts.shape
    dev = drafts.device
    u_bits = _mix32(keys[:, None] ^ _mix32(torch.arange(k, device=dev) + 0x27D4EB2F)[None, :])
    u = ((u_bits >> 8).float() + 0.5) * 2.0 ** -24
    p_at = p_lp[:, :k].gather(2, drafts[:, :, None])[..., 0]
    q_at = q_lp.gather(2, drafts[:, :, None])[..., 0]
    # q_at is finite (the drafts were drawn from q's support), so the ratio
    # never meets -inf - -inf; p_at = -inf accepts with probability 0
    accept = u < torch.exp(torch.clamp(p_at - q_at, max=0.0))
    n_acc = torch.cumprod(accept.to(torch.int64), dim=1).sum(dim=1)
    p_n = p_lp.gather(1, n_acc[:, None, None].expand(B, 1, p_lp.shape[-1]))[:, 0]
    q_n = q_lp.gather(1, torch.clamp(n_acc, max=k - 1)[:, None, None].expand(
        B, 1, q_lp.shape[-1]))[:, 0]
    resid = torch.clamp(torch.exp(p_n) - torch.exp(q_n), min=0.0)
    # an all-zero residual comes only from underflow: fall back to p
    has_resid = resid.sum(dim=-1, keepdim=True) > 0
    corr_lp = torch.where((n_acc == k)[:, None], p_n,
                          torch.where(has_resid, torch.log(resid), p_n))
    cand_lp, cand = torch.topk(corr_lp, min(SAMPLE_TOP_K, corr_lp.shape[-1]), dim=-1)
    salt = _mix32(torch.arange(cand.shape[-1], device=dev) + 0x165667B1)
    bits = _mix32(keys[:, None] ^ salt[None, :])
    g = ((bits >> 8).float() + 0.5) * 2.0 ** -24
    pick = torch.argmax(cand_lp - torch.log(-torch.log(g)), dim=-1, keepdim=True)
    correction = cand.gather(1, pick)
    emitted = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    slot = torch.arange(k + 1, device=dev)[None, :] == n_acc[:, None]
    return torch.where(slot, correction, emitted), n_acc


# The decoder-layer modules whose inputs the AWQ calibration reads, by site
# (JAX: ``QwenTextDecoderLayer._sow_awq``): the qkv input after the input
# norm, the attention context (o_proj's input), the gate/up input after the
# post-attention norm, silu(gate) * up (down_proj's input); the fused
# serving layout's modules take the place of the split ones
AWQ_SITES = {"qkv": ("q_proj", "qkv_proj"), "o": ("o_proj",),
             "gu": ("gate_proj", "gate_up_proj"), "down": ("down_proj",)}


@contextmanager
def awq_taps(text_model: "QwenTextModel"):
    """Per-channel activation statistics of every decoder layer's AWQ sites
    (``AWQ_SITES``) while the context is open: yields {``layer_i``: {site:
    [(2, K) f32 tensors of (amax, mean square) over all leading dimensions,
    one a forward]}}, computed where the activations lie. Forward pre-hooks,
    registered only inside the context, so the serving path and its CUDA
    graphs pay nothing."""
    stats, hooks = {}, []

    def tap(layer_stats, site):
        def hook(module, args):
            a = args[0].float().abs().reshape(-1, args[0].shape[-1])
            layer_stats[site].append(torch.stack([a.amax(dim=0), (a * a).mean(dim=0)]))
        return hook

    try:
        for i, layer in enumerate(text_model.layers):
            layer_stats = stats[f"layer_{i}"] = {site: [] for site in AWQ_SITES}
            for site, names in AWQ_SITES.items():
                module = next(getattr(layer, n) for n in names if hasattr(layer, n))
                hooks.append(module.register_forward_pre_hook(tap(layer_stats, site)))
        yield stats
    finally:
        for hook in hooks:
            hook.remove()


def empty_kv_cache(text_cfg, batch: int, max_len: int, kv_dtype: str,
                   device=None, mesh=None):
    """Per-layer zeros (B, max_len, KV, HD): (k, v) in the text dtype, or
    for ``kv_dtype="int8"`` (k s8, k scales f32 (B, max_len, KV), v s8, v
    scales), the layout ``quantize_kv`` and ``cache_write`` fill. With a
    ``mesh`` whose model axis has n > 1 cards: a ``ShardedCache``, each
    card's zeros of its KV / n heads allocated there
    (``constrain_kv_cache``'s placement of the whole cache)."""
    n = model_axis_size(mesh)
    if n > 1:
        val, _ = kv_cache_sharding_specs(text_cfg, mesh)
        if not val:
            raise ValueError(f"a model axis of {n} cards does not divide "
                             f"num_kv_heads = {text_cfg.num_kv_heads}")
        local = replace(text_cfg, num_kv_heads=text_cfg.num_kv_heads // n)
        return ShardedCache(empty_kv_cache(local, batch, max_len, kv_dtype, d)
                            for d in model_devices(mesh))
    shape = (batch, max_len, text_cfg.num_kv_heads, text_cfg.head_dim)
    zeros = lambda shp, dt: torch.zeros(shp, dtype=dt, device=device)
    if kv_dtype == "int8":
        return [(zeros(shape, torch.int8), zeros(shape[:3], torch.float32),
                 zeros(shape, torch.int8), zeros(shape[:3], torch.float32))
                for _ in range(text_cfg.num_layers)]
    return [(zeros(shape, text_cfg.dtype), zeros(shape, text_cfg.dtype))
            for _ in range(text_cfg.num_layers)]


def kv_cache_sharding_specs(text_cfg, mesh, axis: str = MODEL_AXIS):
    """(values_spec, scales_spec) of the KV cache under tensor parallelism:
    the K/V value buffers (B, L, KV, HD) shard their kv-head axis over the
    mesh ``axis``, the axis the q/k/v projection columns shard on, so the
    cache lies beside the heads that read it and decode attention needs no
    collective; the int8 cache's scale buffers (B, L, KV) shard likewise.
    Where ``axis`` does not divide num_kv_heads, or without a mesh, both
    are replicated: ``((), ())`` (JAX's specs)."""
    n = 1 if mesh is None else int(mesh.shape.get(axis, 1))
    if n <= 1 or text_cfg.num_kv_heads % n:
        return (), ()
    return (None, None, axis, None), (None, None, axis)


def constrain_kv_cache(cache, mesh, text_cfg, axis: str = MODEL_AXIS):
    """A whole KV cache placed on the mesh by ``kv_cache_sharding_specs``:
    a ``ShardedCache`` of each card's kv heads (a replicated spec: the whole
    cache on each card); the cache itself without a mesh or with one card
    (JAX's ``with_sharding_constraint`` over every buffer)."""
    if mesh is None or model_axis_size(mesh) == 1:
        return cache
    val, scale = kv_cache_sharding_specs(text_cfg, mesh, axis)
    devices = model_devices(mesh)
    parts = [[] for _ in devices]
    for layer in cache:
        placed = [shard_tensor(b, val if b.dim() == 4 else scale, devices) for b in layer]
        for c, part in enumerate(parts):
            part.append(tuple(p[c] for p in placed))
    return ShardedCache(parts)


def chunked_prefill(model: "Qwen3VLModel", input_ids, position_ids, true_len,
                    pixel_patches, grid_thw, padded_len: int, max_len: int,
                    cache, C: int, start: int = 0):
    """Sequence-chunked prefill: embed the whole prompt once (the visual
    splice and the deepstack gather index the whole prompt), then run the
    decoder over padded_len / C chunks, each writing its KV rows at
    ``start + chunk * C``. ``start > 0`` prefills a suffix behind a filled
    cache region [0, start); ``true_len`` stays the whole sequence's length.
    Each chunk's queries attend the same masked keys as the one-shot
    prefill's (later cache rows are masked zeros either way), so the output
    equals it; the per-layer f32 attention temps shrink from (B, heads, S,
    L) to (B, heads, C, L), and each chunk reads the decoder weights again.
    Returns (hidden (B, padded_len, D), cache)."""
    if padded_len % C:
        raise ValueError(f"prefill_chunk {C} must divide the prompt bucket "
                         f"{padded_len}")
    dev = input_ids.device
    embeds, visual_mask, deepstack = model.embed_multimodal(
        input_ids, pixel_patches, grid_thw)
    gather = None
    if visual_mask is not None and deepstack:
        gather = visual_gather_indices(visual_mask, deepstack[0].shape[0])
    k_idx = torch.arange(max_len, device=dev)[None, None, :]
    hidden = []
    for c0 in range(0, padded_len, C):
        q_abs = start + c0 + torch.arange(C, device=dev)
        mask = torch.where((k_idx <= q_abs[None, :, None])
                           & (k_idx < true_len[:, None, None]),
                           0.0, float("-inf")).float()
        part = slice(c0, c0 + C)
        h, cache = model.language_model(
            embeds[:, part], position_ids[:, :, part], cache=cache,
            cache_pos=start + c0, attn_mask=mask,
            visual_mask=None if visual_mask is None else visual_mask[:, part],
            deepstack=deepstack,
            visual_gather_idx=None if gather is None else gather[:, part],
            return_hidden=True)
        hidden.append(h)
    return torch.cat(hidden, dim=1), cache


# Per-layer f32 attention-temp budget of the one-shot prefill, in bytes:
# the JAX package's rule, which errs small because a chunk too small costs
# only weight re-reads and one too large runs out of memory
_PREFILL_TEMP_BUDGET = 2 * 2**30


def auto_prefill_chunk(batch: int, num_heads: int, padded_len: int,
                       max_len: int, budget: Optional[int] = None
                       ) -> Optional[int]:
    """A prefill chunk that keeps the per-layer (B, heads, C, max_len) f32
    attention temps within ``budget`` bytes, or None where the one-shot
    prefill fits: the largest divisor of ``padded_len`` that fits (the
    chunks are equal slices), 1 with a warning where none does."""
    if budget is None:
        budget = _PREFILL_TEMP_BUDGET
    per_row = batch * num_heads * max_len * 4
    if padded_len * per_row <= budget:
        return None
    best = 1
    for d in range(1, int(padded_len ** 0.5) + 1):
        if padded_len % d:
            continue
        for c in (d, padded_len // d):
            if best < c < padded_len and c * per_row <= budget:
                best = c
    if best * per_row > budget:
        logging.getLogger(__name__).warning(
            "auto_prefill_chunk: even chunk=1 exceeds the %d-byte temp budget "
            "(B=%d heads=%d max_len=%d); proceeding with 1", budget, batch,
            num_heads, max_len)
    return best


# The KV-cache bytes of the decode states a generator keeps with their
# graphs for reuse; past it the least recently used go first
_KEPT_GRAPH_BYTES = 4 * 2**30


def cache_bytes(cache) -> int:
    """The bytes of a KV cache's buffers (every card's)."""
    return sum(t.numel() * t.element_size() for t in cache_tensors(cache))


@dataclass
class DecodeState:
    """One generation's device state, which ``Qwen3VLGenerator.decode_step``
    advances in place, so that a CUDA graph captured over it replays the
    step (JAX: the decode scan's carry). ``token`` (B,) is what each row
    feeds next, ``step`` (a 0-d tensor) the steps taken, from which a step
    reads its cache position, mask and rope positions; ``done`` (B,) the
    rows that fed eos; ``out`` (B, steps) the fed tokens by step; ``logits``
    the last step's (B, V). ``temp`` / ``top_p`` / ``streams`` (per-row
    ``stream_keys``) are None for greedy decoding."""
    cache: list
    token: torch.Tensor
    step: torch.Tensor
    done: torch.Tensor
    true_len: torch.Tensor
    pos_base: torch.Tensor
    out: torch.Tensor
    logits: torch.Tensor
    padded_len: int
    max_len: int
    temp: Optional[torch.Tensor] = None
    top_p: Optional[torch.Tensor] = None
    streams: Optional[torch.Tensor] = None


class Qwen3VLGenerator:
    """Prefill + token-by-token greedy or sampled decode over a static KV
    cache. The model holds its params (JAX: ``Qwen3VLGenerator(model,
    params)``). ``kv_dtype="int8"`` keeps the cache in s8 with scales;
    ``prefill_chunk`` runs the prompt through the decoder that many tokens
    at a time (None: ``auto_prefill_chunk`` decides).

    Decoding on a CUDA tensor replays ``decode_step`` from a CUDA graph
    (``models/cuda_graph.StepGraph``), the counterpart of JAX's decode scan
    inside one jit: the first step runs eagerly on the capture stream as
    the warm-up, the rest replay, and a failed capture raises. On a CPU
    tensor every step runs eagerly. A graph is kept with its state for the
    next generation of the same shape (``_KEPT_GRAPH_BYTES``; ``release``
    drops them).

    ``mesh`` (a ``parallel.Mesh``) serves tensor-parallel over its ``model``
    axis: ``model`` is sharded by ``tensor_parallel`` (a model already
    sharded over ``mesh`` is taken as it is, and a ``ShardedQwen3VLModel``
    brings its own mesh), and the KV cache is a ``ShardedCache`` of each
    card's kv heads (``kv_cache_sharding_specs``). Token streams are those
    of ``mesh=None``. Above one card of the model axis decode runs eagerly,
    by design: a CUDA graph captures one card's stream, and the choice is
    made from the mesh, never from a failed capture. A model axis of one
    card is the plain path, graphs included."""

    def __init__(self, model: Qwen3VLModel, max_new_tokens: int = 1024,
                 eos_token_id: int = 151645, kv_dtype: str = "bf16",
                 prefill_chunk: Optional[int] = None, mesh=None):
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype must be bf16 or int8: {kv_dtype}")
        if mesh is not None:
            model = tensor_parallel(model, mesh)
        self.mesh = getattr(model, "mesh", None) if mesh is None else mesh
        self.model = model
        self.config = model.config
        self.max_new_tokens = max_new_tokens
        self.eos_token_id = eos_token_id
        self.kv_dtype = kv_dtype
        self.prefill_chunk = prefill_chunk
        self._graphs: "OrderedDict[tuple, StepGraph]" = OrderedDict()

    @property
    def device(self) -> torch.device:
        return self.model.language_model.final_ln.weight.device

    @property
    def replays(self) -> bool:
        """Whether decode replays a CUDA graph: on a card, with a model axis
        of one card."""
        return self.device.type == "cuda" and model_axis_size(self.mesh) == 1

    def release(self) -> None:
        """Drop the kept decode graphs and their states."""
        self._graphs.clear()

    def device_inputs(self, input_ids, pixel_patches=None, grid_thw=(),
                      prompt_bucket: int = 128, true_lens=None,
                      position_ids=None):
        """The prompt right-padded to the next ``prompt_bucket`` multiple,
        on the model's device: (ids, position ids, true lengths, patches,
        padded length)."""
        dev = self.device
        ids = np.asarray(input_ids)
        seq_len = ids.shape[1]
        if true_lens is None:
            true_lens = np.full((ids.shape[0],), seq_len, dtype=np.int64)
        if position_ids is None:
            position_ids = self.model.position_ids(ids, grid_thw)
        padded_len = -(-seq_len // prompt_bucket) * prompt_bucket
        if padded_len > seq_len:
            pad = padded_len - seq_len
            ids = np.pad(ids, [(0, 0), (0, pad)])
            position_ids = np.pad(position_ids, [(0, 0), (0, 0), (0, pad)])
        patches = None
        if pixel_patches is not None:
            patches = torch.as_tensor(np.asarray(pixel_patches)).to(
                dev, self.config.vision.dtype)
        return (torch.as_tensor(ids, dtype=torch.int64, device=dev),
                torch.as_tensor(position_ids, dtype=torch.int64, device=dev),
                torch.as_tensor(np.asarray(true_lens), dtype=torch.int64, device=dev),
                patches, padded_len)

    def _prefill(self, input_ids, position_ids, true_len, pixel_patches,
                 grid_thw, padded_len: int, max_len: int, cache=None):
        """Causal AND key < true_len (right padding receives no attention),
        in one pass or in chunks (the explicit ``prefill_chunk``, else
        ``auto_prefill_chunk``'s), into ``cache`` (zeroed first) or a new
        one. Returns (cache, last-position logits (B, V), next rope
        position)."""
        B = input_ids.shape[0]
        dev = input_ids.device
        if cache is None:
            cache = self.model.empty_cache(B, max_len, self.kv_dtype)
        else:
            for buf in cache_tensors(cache):
                buf.zero_()
        C = self.prefill_chunk
        if C is None:
            C = auto_prefill_chunk(B, self.config.text.num_heads, padded_len, max_len)
        if C and padded_len > C:
            hidden, cache = chunked_prefill(self.model, input_ids, position_ids,
                                            true_len, pixel_patches, grid_thw,
                                            padded_len, max_len, cache, C)
        else:
            q_idx = torch.arange(padded_len, device=dev)[None, :, None]
            k_idx = torch.arange(max_len, device=dev)[None, None, :]
            mask = torch.where((k_idx <= q_idx) & (k_idx < true_len[:, None, None]),
                               0.0, float("-inf")).float()
            hidden, cache = self.model(input_ids, position_ids,
                                       pixel_patches=pixel_patches, grid_thw=grid_thw,
                                       cache=cache, cache_pos=0, attn_mask=mask,
                                       return_hidden=True)
        last_hidden = hidden[torch.arange(B, device=dev), true_len - 1]
        last_logits = self.model.language_model.project(last_hidden)
        next_pos_base = position_ids.amax(dim=(0, 2)) + 1
        return cache, last_logits, next_pos_base

    @staticmethod
    def _sample(state: DecodeState, logits: torch.Tensor, index) -> torch.Tensor:
        """Each row's token ``index`` of its stream from ``logits``: the
        argmax when greedy, else ``sample_rows`` with the rows' draw keys."""
        if state.temp is None:
            return torch.argmax(logits, dim=-1)
        return sample_rows(logits, draw_keys(state.streams, index), state.temp,
                           state.top_p)

    def start(self, input_ids: np.ndarray, pixel_patches=None,
              grid_thw: Tuple[Tuple[int, int, int], ...] = (), steps: int = 1,
              temperature: float = 0.0, top_p: float = 1.0, seed: int = 0,
              prompt_bucket: int = 128, true_lens=None,
              position_ids=None, into: Optional[DecodeState] = None) -> DecodeState:
        """Prefill and the first token: the state that ``decode_step``
        advances, with room for ``steps`` steps; written into ``into`` (a
        state of the same shape, which a captured graph reads) when given."""
        ids_t, pos_t, tl, patches, padded_len = self.device_inputs(
            input_ids, pixel_patches, grid_thw, prompt_bucket, true_lens,
            position_ids)
        max_len = padded_len + steps
        cache, logits, next_pos_base = self._prefill(
            ids_t, pos_t, tl, patches, tuple(grid_thw), padded_len, max_len,
            cache=None if into is None else into.cache)
        B, dev = ids_t.shape[0], ids_t.device
        state = DecodeState(
            cache=cache, token=torch.zeros((B,), dtype=torch.int64, device=dev),
            step=torch.zeros((), dtype=torch.int64, device=dev),
            done=torch.zeros((B,), dtype=torch.bool, device=dev), true_len=tl,
            pos_base=next_pos_base,
            out=torch.full((B, steps), self.eos_token_id, dtype=torch.int64, device=dev),
            logits=logits, padded_len=padded_len, max_len=max_len)
        if temperature > 0:
            state.temp = torch.full((B,), float(temperature), device=dev)
            state.top_p = torch.full((B,), float(top_p), device=dev)
            state.streams = stream_keys(torch.full((B,), int(seed)), torch.arange(B)).to(dev)
        state.token.copy_(self._sample(state, logits, 0))
        if into is None:
            return state
        for name, value in vars(state).items():
            if isinstance(value, torch.Tensor):
                getattr(into, name).copy_(value)
        return into

    def decode_step(self, s: DecodeState) -> None:
        """One decode step over ``s``, in place: feed each row's token (its
        K/V written at ``padded_len + step``), keep the logits, draw the next
        token (eos once the row has fed eos) and count the step. It reads
        nothing back to the host, so a CUDA graph can capture it."""
        B, dev, P = s.token.shape[0], s.token.device, s.padded_len
        pos = (s.pos_base + s.step)[None, :, None].expand(self.model.position_axes, B, 1)
        k_idx = torch.arange(s.max_len, device=dev)[None, None, :]
        mask = torch.where((k_idx < s.true_len[:, None, None])
                           | ((k_idx >= P) & (k_idx <= P + s.step)),
                           0.0, float("-inf")).float()
        logits, _ = self.model(s.token[:, None], pos, cache=s.cache,
                               cache_pos=P + s.step, attn_mask=mask)
        s.logits.copy_(logits[:, -1])
        nxt = self._sample(s, s.logits, s.step + 1)
        s.out.index_copy_(1, s.step.view(1), s.token[:, None])
        s.done |= s.token == self.eos_token_id
        s.token.copy_(torch.where(s.done, self.eos_token_id, nxt))
        s.step += 1

    @torch.inference_mode()
    def generate(self, input_ids: np.ndarray,
                 pixel_patches=None,
                 grid_thw: Tuple[Tuple[int, int, int], ...] = (),
                 max_new_tokens: Optional[int] = None,
                 temperature: float = 0.0, top_p: float = 1.0,
                 seed: int = 0, prompt_bucket: int = 128,
                 true_lens: Optional[np.ndarray] = None,
                 position_ids: Optional[np.ndarray] = None,
                 chunk: Optional[int] = None) -> np.ndarray:
        """input_ids (B, S) -> (B, new) token ids, eos-padded after the
        stop. Prompts are right-padded to the next ``prompt_bucket``
        multiple; ``true_lens`` / ``position_ids`` serve rows of mixed
        length. ``chunk=K`` checks every K steps whether every row has
        stopped and skips the rest: the same tokens as the one-shot loop.
        ``temperature <= 0`` is greedy; otherwise each token is drawn by
        ``sample_rows`` (top-k 50, then ``top_p``) with the keys of row b's
        stream ``stream_keys(seed, b)``. The host reads the rows' state once
        per chunk and the tokens once.

        Traced (``utils/profiling``): the spans ``generator.prefill``
        (``start``), ``generator.decode`` (each run of decode steps),
        ``generator.wait`` (each stop check) and ``generator.read``; the
        counters ``decode.steps``, ``decode.row_steps`` (B times the steps
        taken) and ``decode.tokens_kept`` (each row's tokens up to its eos,
        at most ``max_new``)."""
        max_new = max_new_tokens or self.max_new_tokens
        steps = -(-max_new // chunk) * chunk if chunk else max_new
        key = runner = None
        if self.replays:
            B, S = np.shape(input_ids)
            key = (B, -(-S // prompt_bucket) * prompt_bucket, steps, temperature > 0)
            runner = self._graphs.pop(key, None)
        with annotate("generator.prefill", device=self.device):
            s = self.start(input_ids, pixel_patches, grid_thw, steps, temperature,
                           top_p, seed, prompt_bucket, true_lens, position_ids,
                           into=None if runner is None else runner.state)
        if runner is None:
            runner = StepGraph(self.decode_step, s, s.token.device,
                               forwards=(self.model.language_model,),
                               eager=not self.replays)
        eos = self.eos_token_id
        taken = 0
        while taken < steps:
            if chunk and taken:
                with annotate("generator.wait"):
                    stopped = bool((s.done | (s.token == eos)).all())
                if stopped:
                    break
            n = min(chunk or steps, steps - taken)
            with annotate("generator.decode", device=self.device):
                runner.run(n)
            taken += n
        with annotate("generator.read"):
            tokens = s.out[:, :taken].cpu().numpy()
        count("decode.steps", taken)
        count("decode.row_steps", tokens.size)
        count("decode.tokens_kept", kept_tokens(tokens, eos, max_new))
        if key is not None:
            self._graphs[key] = runner
            while self._graphs and sum(cache_bytes(r.state.cache)
                                       for r in self._graphs.values()) > _KEPT_GRAPH_BYTES:
                self._graphs.popitem(last=False)
        if tokens.shape[1] < max_new:
            pad = np.full((tokens.shape[0], max_new - tokens.shape[1]), eos,
                          tokens.dtype)
            tokens = np.concatenate([tokens, pad], axis=1)
        return tokens[:, :max_new]


def kept_tokens(tokens: np.ndarray, eos: int, max_new: int) -> int:
    """Tokens a (B, steps) block of decoded rows keeps: each row's up to and
    with its first eos, at most ``max_new``."""
    rows = tokens[:, :max_new] == eos
    first = np.where(rows.any(axis=1), rows.argmax(axis=1) + 1, rows.shape[1])
    return int(first.sum())


# ---------------------------------------------------------------------------
# Checkpoint conversion
# ---------------------------------------------------------------------------


def _dense(sd, name) -> dict:
    out = {"kernel": sd[f"{name}.weight"].T}
    if f"{name}.bias" in sd:
        out["bias"] = sd[f"{name}.bias"]
    return out


def _ln(sd, name) -> dict:
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


def convert_hf_qwen3_vl(sd: Dict[str, np.ndarray], vision_depth: int,
                        text_layers: int) -> Dict:
    """HF Qwen3VLForConditionalGeneration state dict (numpy) -> the JAX
    package's param tree (``params_from_jax`` makes it this package's
    state dict); takes 'model.visual.*' and 'visual.*' prefixes."""
    prefix = "model." if any(k.startswith("model.visual.") for k in sd) else ""
    vp = prefix + "visual."
    tp = prefix + "language_model."

    def merger(base):
        return {
            "norm": _ln(sd, base + "norm"),
            "fc1": _dense(sd, base + "linear_fc1"),
            "fc2": _dense(sd, base + "linear_fc2"),
        }

    visual: Dict = {
        "patch_embed": {
            "kernel": sd[vp + "patch_embed.proj.weight"].reshape(
                sd[vp + "patch_embed.proj.weight"].shape[0], -1).T,
            "bias": sd[vp + "patch_embed.proj.bias"],
        },
        "pos_embed": sd[vp + "pos_embed.weight"],
        "merger": merger(vp + "merger."),
    }
    n_deep = len([k for k in sd if "deepstack_merger_list" in k
                  and k.endswith("linear_fc1.weight")])
    for j in range(n_deep):
        visual[f"deepstack_merger_{j}"] = merger(
            vp + f"deepstack_merger_list.{j}.")
    for i in range(vision_depth):
        b = vp + f"blocks.{i}."
        qkv_w = sd[b + "attn.qkv.weight"]
        qkv_b = sd.get(b + "attn.qkv.bias")
        d = qkv_w.shape[1]
        block = {
            "norm1": _ln(sd, b + "norm1"),
            "norm2": _ln(sd, b + "norm2"),
            "q_proj": {"kernel": qkv_w[:d].T},
            "k_proj": {"kernel": qkv_w[d:2 * d].T},
            "v_proj": {"kernel": qkv_w[2 * d:].T},
            "o_proj": _dense(sd, b + "attn.proj"),
            "fc1": _dense(sd, b + "mlp.linear_fc1"),
            "fc2": _dense(sd, b + "mlp.linear_fc2"),
        }
        if qkv_b is not None:
            block["q_proj"]["bias"] = qkv_b[:d]
            block["k_proj"]["bias"] = qkv_b[d:2 * d]
            block["v_proj"]["bias"] = qkv_b[2 * d:]
        visual[f"block_{i}"] = block

    text: Dict = {
        "embed_tokens": {"embedding": sd[tp + "embed_tokens.weight"]},
        "final_ln": {"scale": sd[tp + "norm.weight"]},
    }
    for i in range(text_layers):
        b = tp + f"layers.{i}."
        text[f"layer_{i}"] = {
            "input_ln": {"scale": sd[b + "input_layernorm.weight"]},
            "post_ln": {"scale": sd[b + "post_attention_layernorm.weight"]},
            "q_proj": _dense(sd, b + "self_attn.q_proj"),
            "k_proj": _dense(sd, b + "self_attn.k_proj"),
            "v_proj": _dense(sd, b + "self_attn.v_proj"),
            "o_proj": _dense(sd, b + "self_attn.o_proj"),
            "q_norm_scale": sd[b + "self_attn.q_norm.weight"],
            "k_norm_scale": sd[b + "self_attn.k_norm.weight"],
            "gate_proj": _dense(sd, b + "mlp.gate_proj"),
            "up_proj": _dense(sd, b + "mlp.up_proj"),
            "down_proj": _dense(sd, b + "mlp.down_proj"),
        }
    lm_head_key = "lm_head.weight"
    if lm_head_key in sd:
        text["lm_head"] = {"kernel": sd[lm_head_key].T}
    return {"visual": visual, "language_model": text}


def qwen3_vl_config_from_hf(cfg: Dict, dtype: torch.dtype = torch.float32
                            ) -> Qwen3VLConfig:
    v = cfg.get("vision_config", {})
    t = cfg.get("text_config", {})
    rope_scaling = t.get("rope_scaling") or {}
    return Qwen3VLConfig(
        vision=QwenVisionConfig(
            depth=v.get("depth", 27),
            hidden_size=v.get("hidden_size", 1152),
            intermediate_size=v.get("intermediate_size", 4304),
            num_heads=v.get("num_heads", 16),
            patch_size=v.get("patch_size", 16),
            temporal_patch_size=v.get("temporal_patch_size", 2),
            spatial_merge_size=v.get("spatial_merge_size", 2),
            out_hidden_size=v.get("out_hidden_size", 3584),
            num_position_embeddings=v.get("num_position_embeddings", 2304),
            deepstack_visual_indexes=tuple(
                v.get("deepstack_visual_indexes", (8, 16, 24))),
            hidden_act=v.get("hidden_act", "gelu_pytorch_tanh"),
            dtype=dtype),
        text=QwenTextConfig(
            vocab_size=t.get("vocab_size", 151936),
            hidden_size=t.get("hidden_size", 4096),
            num_layers=t.get("num_hidden_layers", 36),
            num_heads=t.get("num_attention_heads", 32),
            num_kv_heads=t.get("num_key_value_heads", 8),
            head_dim=t.get("head_dim", t.get("hidden_size", 4096)
                           // t.get("num_attention_heads", 32)),
            intermediate_size=t.get("intermediate_size", 12288),
            rms_norm_eps=t.get("rms_norm_eps", 1e-6),
            rope_theta=t.get("rope_theta", 5e6),
            mrope_section=tuple(rope_scaling.get("mrope_section",
                                                 (24, 20, 20))),
            attention_bias=t.get("attention_bias", False),
            # text_config's flag wins over the top-level one
            tie_word_embeddings=t.get(
                "tie_word_embeddings", cfg.get("tie_word_embeddings", True)),
            dtype=dtype),
        image_token_id=cfg.get("image_token_id", 151655),
        video_token_id=cfg.get("video_token_id", 151656),
        vision_start_token_id=cfg.get("vision_start_token_id", 151652))
