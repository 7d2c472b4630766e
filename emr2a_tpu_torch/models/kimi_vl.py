"""Kimi-VL-A3B in PyTorch: MoonViT, its projector, and a DeepSeek-V3-style
decoder with latent attention (MLA) and a 64-expert mixture of experts.

The published model (moonshotai/Kimi-VL-A3B-Instruct, its ``config.json``
and modeling code), at its widths:

- MoonViT: each 3 x 14 x 14 patch mapped to 1,152 (with bias), plus a
  learned 64 x 64 x 1,152 position table bicubically interpolated to the
  image's (h, w) patch grid (``align_corners=False``); 27 pre-LN blocks
  (LayerNorm eps 1e-5; qkv and output projections with bias; attention
  within each image at 72^-0.5 on K8; an MLP 1,152 -> 4,304 -> 1,152 with
  GELU-tanh) with a 2D rotary on every head (its 72 dims as 36 adjacent
  pairs: pair 2k turns by col x 10000^(-4k/72), pair 2k + 1 by row x
  10000^(-4k/72)); a final LayerNorm; then each 2 x 2 block of tokens is
  gathered and projected: LayerNorm(1,152) per token, 4,608 -> 4,608,
  exact GELU, 4,608 -> 2,048. The blocks and the projector are
  ``models/qwen3_vl.py``'s ``QwenVisionBlock`` and ``QwenPatchMerger``
  with the options ``layer_norm_eps`` and ``rope_pairs``: the same
  mathematics.
- The decoder: token embeddings with the image placeholders replaced by
  the projector's output, 1-D positions, 27 pre-RMSNorm (eps 1e-5)
  residual blocks, a final norm and an untied lm_head of 163,840.
- MLA, no q-LoRA: q = W_q x split per head into q_nope (128) and q_pe
  (64); [c_kv (512) | k_pe (64)] = W_kva x; c_kv = RMSNorm(c_kv); rotary
  (theta 800,000) on q_pe and on k_pe, which all 16 heads share, its 64
  dims as 32 adjacent pairs, pair i turning by pos x 800000^(-2i/64)
  (DeepSeek's de-interleave then ``rotate_half``, up to an order of dims
  that q and k share); [k_nope | v] per head = W_kvb c_kv (512 -> 16 x
  256); logits (q_nope.k_nope + q_pe.k_pe) x 192^-0.5, causal; o_proj.
- Layer 0 is a dense SwiGLU of 11,264; layers 1-26 are expert layers:
  s = sigmoid(W_g x) in f32, the top 6 of s + b (b the correction bias;
  one group, so no group restriction), weights the chosen s over their
  sum times 2.446, y = sum_i w_i E_i(x) + S(x), each E_i a SwiGLU of
  1,408 (K11, ``ops/moe.py``) and S the shared SwiGLU of 2,816.

The cache holds, per layer and position, one 576-wide latent row: the
normalised c_kv and the rotated k_pe (31.1 KB a token over the 27
layers in bf16, against 147 KB of K and V for Qwen3-VL-8B). Prefill (more
than ``MAX_QUERIES`` positions) writes its latents, expands k_nope and v
from the cache's filled positions through W_kvb and attends in bf16 with
``scaled_dot_product_attention``. Decode runs the absorbed form over the
cache as stored: with W_kvb's per-head blocks k_nope,h = W_UK,h c_kv and
v_h = W_UV,h c_kv, q_lat,h = W_UK,h^T q_nope,h (512 wide) attends with
keys [c_kv | k_pe] against [q_lat,h | q_pe,h] at the same scale and
values c_kv, and out_h = W_UV,h o_lat,h; all as bf16 batched products
over views of the weights and of the cache (the attention logits
accumulated and kept in f32: ``torch.bmm``'s ``out_dtype`` on the card),
so no step makes a float32 copy of the cache. The weights, the cache, the
residual stream and every product's operands are bf16; the router's
scores are f32, as published. Routing is discrete: a rounding that moves
an expert's score past the sixth flips the choice, and with random
weights the flips compound over 26 expert layers.

``record_routes``: each expert layer's cache entry then also keeps, per
position, the rope position plus 1 and the ids of the experts chosen
there (``route_columns`` int32 columns, written where the latent is
written), so that a served request's routing can be read back from its
slot (``record_rows``, which ``ContinuousBatcher`` calls as a request
retires) and a reference can follow the program's choices where its own
scores tie.

Departures from the published code, each the same mathematics: the
vision qkv projection is held as three projections (q, k, v) and each
layer's experts as two stacked kernels (gate and up side by side, and
down); kernels are (in, out); MLA's rotary keeps the pairs in place where
DeepSeek de-interleaves them (the dot products are the same); the
position table is interpolated in f32 and rounded to the working dtype
once. The checkpoint's loader is not written yet (the weights come from a
state dict in these names).

The interface is ``Qwen3VLModel``'s, so ``Qwen3VLGenerator``,
``serving.ContinuousBatcher`` and their CUDA graphs serve it as they are:
``forward(input_ids, position_ids, pixel_patches, grid_thw, cache,
cache_pos, attn_mask, return_hidden)``, ``embed_multimodal``,
``language_model`` (``forward``, ``project``, ``final_ln``),
``empty_cache``, ``cache_bytes_per_row``, ``position_ids`` (1-D:
``position_axes`` = 1), ``record_rows``. Traced (``utils/profiling``): ``kimi.vision``
(the tower and projector over a prepared batch) and ``moe.experts`` (each
eager expert call, with device time); K11's device-side tally gives the
counters ``moe.pairs``, ``moe.calls``, ``moe.expert_reads`` (distinct
experts read, summed over calls) and ``moe.max_load``, each ``.prefill``
and ``.decode``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from emr2a_tpu_torch.models.layers import Dense
from emr2a_tpu_torch.models.qwen3_vl import (
    Embed,
    LayerNorm,
    QwenPatchMerger,
    QwenVisionBlock,
    QwenVisionConfig,
    RMSNorm,
    apply_rope,
    cache_write,
    vision_segment_mask,
)
from emr2a_tpu_torch.ops.decode_attention import MAX_QUERIES
from emr2a_tpu_torch.ops.moe import moe_experts
from emr2a_tpu_torch.utils.profiling import annotate


@dataclass(frozen=True)
class KimiTextConfig:
    vocab_size: int = 163840
    hidden_size: int = 2048
    num_layers: int = 27
    num_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    rms_norm_eps: float = 1e-5
    # DeepSeek-V3's kv_a_layernorm is built without the config's eps
    kv_norm_eps: float = 1e-6
    rope_theta: float = 800000.0
    dtype: torch.dtype = torch.float32

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        return self.kv_lora_rank + self.qk_rope_head_dim


def moonvit_config(dtype: torch.dtype = torch.float32) -> QwenVisionConfig:
    """MoonViT's published ``vision_config`` as the Qwen tower's options:
    no temporal patch, no deepstack, a 64 x 64 position table."""
    return QwenVisionConfig(depth=27, hidden_size=1152, intermediate_size=4304, num_heads=16,
                            in_channels=3, patch_size=14, temporal_patch_size=1,
                            spatial_merge_size=2, out_hidden_size=2048,
                            num_position_embeddings=64 * 64, deepstack_visual_indexes=(),
                            hidden_act="gelu_pytorch_tanh", dtype=dtype,
                            layer_norm_eps=1e-5, rope_pairs=True)


@dataclass(frozen=True)
class KimiVLConfig:
    vision: QwenVisionConfig = field(default_factory=moonvit_config)
    text: KimiTextConfig = field(default_factory=KimiTextConfig)
    image_token_id: int = 163605


# ---------------------------------------------------------------------------
# MoonViT
# ---------------------------------------------------------------------------


def merge_order(h: int, w: int, m: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(row-major index, row, col) of each token of an (h, w) grid in
    m x m merge-block order: blocks row-major, then the block's tokens
    row-major."""
    r = np.arange(h // m)[:, None, None, None] * m + np.arange(m)[None, None, :, None]
    c = np.arange(w // m)[None, :, None, None] * m + np.arange(m)[None, None, None, :]
    r = np.broadcast_to(r, (h // m, w // m, m, m)).reshape(-1)
    c = np.broadcast_to(c, (h // m, w // m, m, m)).reshape(-1)
    return r * w + c, r, c


def moonvit_rope(grid_thw, head_dim: int, merge: int, theta: float = 10000.0):
    """(seq, head_dim) cos / sin of the 2D rotary in merge-block order:
    pair 2k turns by col x theta^(-4k/head_dim), pair 2k + 1 by row x the
    same, each angle repeated for the pair's two dims."""
    inv = 1.0 / theta ** (np.arange(0, head_dim, 4, dtype=np.float32)[:head_dim // 4]
                          / head_dim)
    angles = []
    for t, h, w in grid_thw:
        _, rows, cols = merge_order(h, w, merge)
        a = np.stack([cols[:, None] * inv, rows[:, None] * inv], axis=-1).reshape(len(rows), -1)
        angles.append(np.tile(a, (t, 1)))
    emb = np.repeat(np.concatenate(angles).astype(np.float32), 2, axis=-1)
    return np.cos(emb), np.sin(emb)


class MoonViT(nn.Module):
    """Patches (in merge-block order, ``judge/kimi_backend``'s layout) and
    their (1, h, w) grids -> merged image tokens (n / 4, out_hidden)."""

    def __init__(self, cfg: QwenVisionConfig, device=None):
        super().__init__()
        self.config = cfg
        kw = dict(dtype=cfg.dtype, device=device)
        side = int(round(cfg.num_position_embeddings ** 0.5))
        self.patch_embed = Dense(cfg.patch_dim, cfg.hidden_size, **kw)
        self.pos_embed = nn.Parameter(torch.empty(side, side, cfg.hidden_size, **kw))
        self.blocks = nn.ModuleList([QwenVisionBlock(cfg, device) for _ in range(cfg.depth)])
        self.final_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)
        self.merger = QwenPatchMerger(cfg, False, device)

    def position_table(self, h: int, w: int) -> torch.Tensor:
        """(h * w, D) the learned table at the (h, w) grid, row-major; each
        grid's interpolation is kept (keyed by the table's storage and
        version, so new or edited weights interpolate again)."""
        table = self.pos_embed
        if tuple(table.shape[:2]) == (h, w):
            return table.reshape(h * w, -1)
        key = (h, w, table.data_ptr(), table._version)
        kept = self.__dict__.setdefault("_tables", {})
        if key not in kept:
            grid = F.interpolate(table.float().permute(2, 0, 1)[None], size=(h, w),
                                 mode="bicubic", align_corners=False)[0]
            kept[key] = grid.permute(1, 2, 0).reshape(h * w, -1).to(table.dtype)
        return kept[key]

    def forward(self, patches: torch.Tensor, grid_thw) -> torch.Tensor:
        cfg = self.config
        m, dev = cfg.spatial_merge_size, patches.device
        x = self.patch_embed(patches.to(cfg.dtype))
        pos = []
        for t, h, w in grid_thw:
            order = torch.from_numpy(merge_order(h, w, m)[0]).to(dev)
            pos.append(self.position_table(h, w)[order].repeat(t, 1))
        x = x + torch.cat(pos)
        cos, sin = (torch.from_numpy(a).to(dev) for a in moonvit_rope(grid_thw, cfg.head_dim, m))
        frames = [(h, w) for t, h, w in grid_thw for _ in range(t)]
        mask = None
        if len(set(frames)) == 1:
            # uniform images attend per frame on K8's (F, S, d) layout
            seq = frames[0][0] * frames[0][1]
            x = x.reshape(len(frames), seq, cfg.hidden_size)
            cos, sin = cos[:seq], sin[:seq]
        else:
            mask = torch.from_numpy(vision_segment_mask(grid_thw)).to(dev)
        for block in self.blocks:
            x = block(x, cos, sin, mask)
        x = self.final_ln(x.reshape(-1, cfg.hidden_size))
        return self.merger(x)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


_INV_FREQ: Dict = {}


def _inv_freq(dim: int, theta: float, device) -> torch.Tensor:
    """The rotary's inverse frequencies on ``device``, copied there once (a
    decode step captured in a CUDA graph may not copy from the host)."""
    key = (dim, float(theta), str(device))
    if key not in _INV_FREQ:
        inv = 1.0 / theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim)
        _INV_FREQ[key] = torch.from_numpy(inv).to(device)
    return _INV_FREQ[key]


def rope_cos_sin(position_ids: torch.Tensor, dim: int, theta: float):
    """(1, B, S) positions -> (B, S, dim) cos / sin, each pair's angle
    repeated for its two dims (``apply_rope(..., pairs=True)``)."""
    inv = _inv_freq(dim, theta, position_ids.device)
    ang = position_ids[0, ..., None].float() * inv
    ang = ang.repeat_interleave(2, dim=-1)
    return torch.cos(ang), torch.sin(ang)


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (batched) accumulated and returned in f32: on the card bf16
    operands read as they lie (cuBLAS's f32 output); on the CPU in f32."""
    if a.device.type == "cuda" and a.dtype in (torch.bfloat16, torch.float16):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


class KimiMLA(nn.Module):
    """Multi-head latent attention over the latent cache (see the module
    docstring)."""

    def __init__(self, cfg: KimiTextConfig, device=None):
        super().__init__()
        self.config = cfg
        H, d = cfg.num_heads, cfg.hidden_size
        kw = dict(dtype=cfg.dtype, device=device)
        self.q_proj = Dense(d, H * cfg.q_head_dim, use_bias=False, **kw)
        self.kv_a_proj = Dense(d, cfg.latent_dim, use_bias=False, **kw)
        self.kv_a_ln = RMSNorm(cfg.kv_lora_rank, cfg.kv_norm_eps, **kw)
        self.kv_b_proj = Dense(cfg.kv_lora_rank, H * (cfg.qk_nope_head_dim + cfg.v_head_dim),
                               use_bias=False, **kw)
        self.o_proj = Dense(H * cfg.v_head_dim, d, use_bias=False, **kw)

    def latents(self, h, cos, sin):
        """h (B, S, d) -> (q_nope (B, S, H, 128), rotated q_pe (B, S, H,
        64), fresh latent rows (B, S, 576): [RMSNorm(c_kv) | rotated k_pe])."""
        cfg = self.config
        B, S, _ = h.shape
        q = self.q_proj(h).reshape(B, S, cfg.num_heads, cfg.q_head_dim)
        q_nope, q_pe = q[..., :cfg.qk_nope_head_dim], q[..., cfg.qk_nope_head_dim:]
        ckv = self.kv_a_proj(h)
        c, k_pe = ckv[..., :cfg.kv_lora_rank], ckv[..., cfg.kv_lora_rank:]
        q_pe, k_pe = apply_rope(q_pe, k_pe[:, :, None, :], cos[:, :, None, :],
                                sin[:, :, None, :], pairs=True)
        return q_nope, q_pe, torch.cat([self.kv_a_ln(c), k_pe[:, :, 0]], dim=-1)

    def _blocks(self):
        """W_kvb's per-head blocks as views: W_UK (H, 512, 128), W_UV (H,
        512, 128)."""
        cfg = self.config
        w = self.kv_b_proj.kernel.view(cfg.kv_lora_rank, cfg.num_heads, -1)
        return (w[..., :cfg.qk_nope_head_dim].transpose(0, 1),
                w[..., cfg.qk_nope_head_dim:].transpose(0, 1))

    def expanded(self, q_nope, q_pe, latent, mask):
        """Attention over ``latent`` (B, L, 576) with k_nope and v expanded
        through W_kvb, in the working dtype (``scaled_dot_product_attention``);
        ``mask`` (B, S, L) additive. -> (B, S, H * v)."""
        cfg = self.config
        B, S, H, _ = q_nope.shape
        L = latent.shape[1]
        kv = self.kv_b_proj(latent[..., :cfg.kv_lora_rank]).reshape(B, L, H, -1)
        k_nope, v = kv[..., :cfg.qk_nope_head_dim], kv[..., cfg.qk_nope_head_dim:]
        k_pe = latent[:, :, None, cfg.kv_lora_rank:].expand(B, L, H, cfg.qk_rope_head_dim)
        q = torch.cat([q_nope, q_pe], dim=-1).transpose(1, 2)
        k = torch.cat([k_nope, k_pe], dim=-1).transpose(1, 2)
        out = F.scaled_dot_product_attention(q, k, v.transpose(1, 2),
                                             attn_mask=(mask == 0)[:, None],
                                             scale=cfg.q_head_dim ** -0.5)
        return out.transpose(1, 2).reshape(B, S, H * cfg.v_head_dim)

    def absorbed(self, q_nope, q_pe, latent, mask):
        """The absorbed form over the cache as stored (see the module
        docstring): ``latent`` (B, L, 576), ``mask`` (B, S, L) additive
        f32. -> (B, S, H * v)."""
        cfg = self.config
        B, S, H, _ = q_nope.shape
        L, R = latent.shape[1], cfg.kv_lora_rank
        w_uk, w_uv = self._blocks()
        q_lat = torch.bmm(q_nope.reshape(B * S, H, -1).transpose(0, 1),
                          w_uk.transpose(1, 2))                          # (H, BS, 512)
        q_all = torch.cat([q_lat.transpose(0, 1).reshape(B, S, H, R), q_pe], dim=-1)
        logits = bmm_f32(q_all.reshape(B, S * H, -1), latent.transpose(1, 2))
        logits = logits.view(B, S, H, L) * cfg.q_head_dim ** -0.5 + mask[:, :, None, :]
        probs = torch.softmax(logits, dim=-1).to(latent.dtype).view(B, S * H, L)
        o_lat = torch.bmm(probs, latent[..., :R])                       # (B, SH, 512)
        out = torch.bmm(o_lat.view(B * S, H, R).transpose(0, 1), w_uv)  # (H, BS, v)
        return out.transpose(0, 1).reshape(B, S, H * cfg.v_head_dim)

    def forward(self, h, cos, sin, latent, cache_pos, mask):
        """h (B, S, d) after the input norm; latent None or this layer's
        cache (B, L, 576); mask (B, S, L) additive f32 (L the cache's length,
        or S without a cache). Returns (o_proj's output, the cache)."""
        q_nope, q_pe, fresh = self.latents(h, cos, sin)
        S = h.shape[1]
        if latent is None:
            return self.o_proj(self.expanded(q_nope, q_pe, fresh, mask)), None
        latent = cache_write(latent, fresh, cache_pos)
        if S <= MAX_QUERIES:
            attn = self.absorbed(q_nope, q_pe, latent, mask)
        else:
            # a prefill writes at a host offset: expand the filled positions
            used = int(cache_pos) + S
            attn = self.expanded(q_nope, q_pe, latent[:, :used], mask[..., :used])
        return self.o_proj(attn), latent


class SwiGLU(nn.Module):
    """down(silu(gate(x)) * up(x))."""

    def __init__(self, d: int, width: int, dtype, device=None):
        super().__init__()
        kw = dict(use_bias=False, dtype=dtype, device=device)
        self.gate_proj = Dense(d, width, **kw)
        self.up_proj = Dense(d, width, **kw)
        self.down_proj = Dense(width, d, **kw)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


def route(x: torch.Tensor, router: torch.Tensor, bias: torch.Tensor, top_k: int,
          scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, d) -> (ids (T, top_k), weights (T, top_k) f32): sigmoid scores
    in f32, the top ``top_k`` of scores + bias, the chosen scores over
    their sum (+ 1e-20) times ``scale``."""
    scores = torch.sigmoid(x.float() @ router.float())
    ids = torch.topk(scores + bias.float(), top_k, dim=-1).indices
    w = scores.gather(1, ids)
    return ids, w / (w.sum(dim=-1, keepdim=True) + 1e-20) * scale


class KimiMoE(nn.Module):
    """The expert layer: the router, the routed experts (K11) and the
    shared experts."""

    def __init__(self, cfg: KimiTextConfig, device=None):
        super().__init__()
        self.config = cfg
        d, I, E = cfg.hidden_size, cfg.moe_intermediate_size, cfg.n_routed_experts
        kw = dict(dtype=cfg.dtype, device=device)
        self.router = nn.Parameter(torch.empty(d, E, **kw))
        self.router_bias = nn.Parameter(torch.empty(E, **kw))
        self.experts_gate_up = nn.Parameter(torch.empty(E, d, 2 * I, **kw))
        self.experts_down = nn.Parameter(torch.empty(E, I, d, **kw))
        self.shared = SwiGLU(d, I * cfg.n_shared_experts, cfg.dtype, device)

    def forward(self, x, phase: str = "prefill"):
        """x (..., d), the normed hidden state -> ((..., d) f32, the chosen
        experts (..., top_k))."""
        cfg = self.config
        lead = x.shape[:-1]
        flat = x.reshape(-1, x.shape[-1])
        ids, w = route(flat, self.router, self.router_bias, cfg.num_experts_per_tok,
                       cfg.routed_scaling_factor)
        capturing = flat.is_cuda and torch.cuda.is_current_stream_capturing()
        with annotate("moe.experts", device=None if capturing else flat.device):
            routed = moe_experts(flat, self.experts_gate_up, self.experts_down, ids, w, phase)
        return (self.shared(flat).float() + routed).reshape(*lead, -1), ids.view(*lead, -1)


class KimiDecoderLayer(nn.Module):

    def __init__(self, cfg: KimiTextConfig, index: int, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        self.input_ln = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.post_ln = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.attn = KimiMLA(cfg, device)
        if index < cfg.first_k_dense_replace:
            self.mlp = SwiGLU(cfg.hidden_size, cfg.intermediate_size, cfg.dtype, device)
        else:
            self.moe = KimiMoE(cfg, device)

    def forward(self, x, cos, sin, cache, cache_pos, mask, route_keys=None):
        """x (B, S, d); cache None or this layer's (latent,) or, recording
        routes, (latent, routes (B, L, 1 + top_k) int32), where the rows
        ``route_keys`` (B, S, 1) and the chosen experts are written.
        Returns (x, the cache)."""
        o, latent = self.attn(self.input_ln(x), cos, sin, None if cache is None else cache[0],
                              cache_pos, mask)
        x = x + o
        h = self.post_ln(x)
        if hasattr(self, "mlp"):
            return x + self.mlp(h), None if cache is None else (latent,)
        y, ids = self.moe(h, "decode" if x.shape[1] == 1 else "prefill")
        x = (x + y).to(x.dtype)
        if cache is None:
            return x, None
        if len(cache) > 1:
            cache_write(cache[1], torch.cat([route_keys, ids.to(torch.int32)], dim=-1),
                        cache_pos)
        return x, (latent, *cache[1:])


class KimiTextModel(nn.Module):

    def __init__(self, cfg: KimiTextConfig, device=None):
        super().__init__()
        self.config = cfg
        kw = dict(dtype=cfg.dtype, device=device)
        self.embed_tokens = Embed(cfg.vocab_size, cfg.hidden_size, **kw)
        self.layers = nn.ModuleList([KimiDecoderLayer(cfg, i, device)
                                     for i in range(cfg.num_layers)])
        self.final_ln = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.lm_head = Dense(cfg.hidden_size, cfg.vocab_size, use_bias=False, **kw)

    def forward(self, inputs_embeds, position_ids, cache=None, cache_pos=0, attn_mask=None,
                visual_mask=None, deepstack=None, visual_gather_idx=None,
                return_hidden: bool = False):
        """inputs_embeds (B, S, D); position_ids (1, B, S); cache: a list of
        per-layer (latent,) or None; attn_mask (B, S, L) additive (causal
        over S without one). The visual arguments are the Qwen decoder's
        (deepstack), which this one has not. Returns (logits or hidden,
        new cache)."""
        cfg = self.config
        x = inputs_embeds
        B, S, _ = x.shape
        if attn_mask is None:
            idx = torch.arange(S, device=x.device)
            attn_mask = torch.where(idx[None, :] <= idx[:, None], 0.0, float("-inf"))
            attn_mask = attn_mask.float()[None].expand(B, S, S)
        cos, sin = rope_cos_sin(position_ids, cfg.qk_rope_head_dim, cfg.rope_theta)
        keys = None
        if cache is not None and len(cache[-1]) > 1:    # route records kept
            keys = (position_ids[0, ..., None] + 1).to(torch.int32)
        new_cache = None if cache is None else []
        for i, layer in enumerate(self.layers):
            x, c = layer(x, cos, sin, None if cache is None else cache[i], cache_pos, attn_mask,
                         keys)
            if cache is not None:
                new_cache.append(c)
        x = self.final_ln(x)
        return (x if return_hidden else self.project(x)), new_cache

    def project(self, hidden):
        return self.lm_head(hidden)


def random_state(config: KimiVLConfig, seed: int = 0, device="cuda") -> Dict[str, torch.Tensor]:
    """Seeded random weights in this module's names, drawn on ``device`` in
    the configuration's dtypes: norm scales 1, every other tensor (kernels,
    biases, embeddings, the position table, routers) N(0, 0.02)."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, p in KimiVLModel(config, device="meta").state_dict().items():
        if name.endswith(".weight"):
            out[name] = torch.ones(p.shape, dtype=p.dtype, device=device)
        else:
            out[name] = torch.randn(p.shape, generator=g, dtype=p.dtype, device=device) * 0.02
    return out


class KimiVLModel(nn.Module):
    """Multimodal forward: ids + optional image patches -> logits, with
    ``Qwen3VLModel``'s interface (see the module docstring)."""

    position_axes = 1

    def __init__(self, config: KimiVLConfig, device=None, record_routes: bool = False):
        super().__init__()
        self.config = config
        self.record_routes = record_routes
        self.visual = MoonViT(config.vision, device)
        self.language_model = KimiTextModel(config.text, device)

    @classmethod
    def from_params(cls, config: KimiVLConfig, state: Mapping[str, torch.Tensor],
                    record_routes: bool = False) -> "KimiVLModel":
        """The model over ``state`` (these names), taking its tensors as they
        are (no copy). Inference only."""
        model = cls(config, device="meta", record_routes=record_routes)
        model.load_state_dict(dict(state), strict=True, assign=True)
        return model.requires_grad_(False)

    @property
    def route_columns(self) -> int:
        """A route record's int32 columns: the rope position plus 1, then
        the chosen experts."""
        return 1 + self.config.text.num_experts_per_tok

    def _recording(self, layer: int) -> bool:
        return self.record_routes and layer >= self.config.text.first_k_dense_replace

    def empty_cache(self, batch: int, max_len: int, kv_dtype: str):
        """A zeroed latent cache: per layer (latent (batch, max_len, 576),),
        and with ``record_routes`` an expert layer's routes (batch, max_len,
        ``route_columns``) int32 beside its latent."""
        if kv_dtype != "bf16":
            raise ValueError(f"the latent cache is held in the working dtype; kv_dtype "
                             f"{kv_dtype!r} is not supported")
        t = self.config.text
        dev = self.language_model.final_ln.weight.device

        def zeros(width, dtype):
            return torch.zeros((batch, max_len, width), dtype=dtype, device=dev)

        return [(zeros(t.latent_dim, t.dtype),
                 *((zeros(self.route_columns, torch.int32),) if self._recording(i) else ()))
                for i in range(t.num_layers)]

    def cache_bytes_per_row(self, max_len: int, kv_dtype: str) -> int:
        t = self.config.text
        routes = sum(self._recording(i) for i in range(t.num_layers)) * self.route_columns * 4
        return max_len * (t.latent_dim * t.dtype.itemsize * t.num_layers + routes)

    def record_rows(self, cache, row: int) -> Optional[torch.Tensor]:
        """A copy of row ``row``'s route records, (expert layers, L,
        ``route_columns``) int32, on the device; None without
        ``record_routes``."""
        if not self.record_routes:
            return None
        return torch.stack([layer[1][row] for layer in cache if len(layer) > 1])

    def position_ids(self, input_ids: np.ndarray, grid_thw) -> np.ndarray:
        """(1, B, S) plain positions: every token, image or text, one on."""
        B, S = np.shape(input_ids)
        return np.broadcast_to(np.arange(S, dtype=np.int64), (1, B, S)).copy()

    def embed_multimodal(self, input_ids, pixel_patches, grid_thw):
        """Token embeddings with the projector's output at the image
        placeholders: (embeds, image-token mask or None, None)."""
        lm = self.language_model
        embeds = lm.embed_tokens(input_ids).to(lm.config.dtype)
        if pixel_patches is None:
            return embeds, None, None
        with annotate("kimi.vision", device=pixel_patches.device):
            image = self.visual(pixel_patches, tuple(grid_thw))
        mask = input_ids == self.config.image_token_id
        idx = torch.clamp(torch.cumsum(mask.reshape(-1).to(torch.int64), 0) - 1, min=0)
        spliced = image[torch.clamp(idx, max=image.shape[0] - 1)].view(*mask.shape, -1)
        return torch.where(mask[..., None], spliced.to(embeds.dtype), embeds), mask, None

    def forward(self, input_ids, position_ids, pixel_patches=None, grid_thw=(), cache=None,
                cache_pos=0, attn_mask=None, return_hidden: bool = False):
        embeds, _, _ = self.embed_multimodal(input_ids, pixel_patches, grid_thw)
        return self.language_model(embeds, position_ids, cache=cache, cache_pos=cache_pos,
                                   attn_mask=attn_mask, return_hidden=return_hidden)
