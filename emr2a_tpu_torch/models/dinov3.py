"""DINOv3 ViT: RoPE over patch centres, LayerScale, register tokens.

Port of ``emr2a_tpu/models/dinov3.py`` (HF ``DINOv3ViTModel``'s forward):
patch embed (the conv as a reshape and one ``Dense``) -> [cls | registers |
patches] -> N x (pre-LN attention with patch-only RoPE and LayerScale,
pre-LN (gated) MLP and LayerScale) -> final LN, then the pooling (``none``,
``cls`` or ``mean_all``, the mean over every token, which the DINO encoder
takes).

RoPE: 2-D patch-centre coordinates normalised to [-1, 1], angle base
``rope_theta``, head_dim / 4 frequencies an axis, the angles tiled twice,
the rotate-half convention, on the patch tokens only (the prefix tokens
pass through). The tables are numpy f32, as JAX's, and are cast to the
working dtype before they meet q and k. Attention logits and softmax are
f32, the probabilities cast to the working dtype.

Projections route on what their params hold, as JAX's ``_QuantRoutingModule``
does: ``models/layers.load_params`` makes every ``Dense`` whose state
arrives as ``kernel_q`` / ``kernel_scale`` an ``Int8Dense`` (K5,
``ops/linear_int8.py``). DINOv3's blocks have no fused-kernel path in either
package (RoPE and LayerScale sit inside them), so W8A8 params put all six or
seven projections of a block on K5, and RoPE, softmax and LayerScale stay in
the working dtype. Parameter names follow the JAX package's tree
(``models/convert.params_from_jax``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from emr2a_tpu_torch.models.clip import init_tower
from emr2a_tpu_torch.models.layers import ACTIVATIONS, Dense


@dataclass(frozen=True)
class DINOv3Config:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 1024      # vitl16
    num_layers: int = 24
    num_heads: int = 16
    mlp_dim: int = 4096
    activation: str = "gelu"
    ln_eps: float = 1e-5
    num_register_tokens: int = 4
    rope_theta: float = 100.0
    use_gated_mlp: bool = False
    query_bias: bool = True
    key_bias: bool = False
    value_bias: bool = True
    proj_bias: bool = True
    mlp_bias: bool = True
    dtype: torch.dtype = torch.float32


# facebook/dinov3-vitl16: 1,024 x 24 layers, 16 heads, 4 registers, theta 100
DINOV3_VITL16 = DINOv3Config()


def rope_angles(num_h: int, num_w: int, head_dim: int, theta: float):
    """cos, sin (num_h * num_w, head_dim) f32 numpy tables of patch-centre
    RoPE."""
    coords_h = np.arange(0.5, num_h, dtype=np.float32) / num_h
    coords_w = np.arange(0.5, num_w, dtype=np.float32) / num_w
    hh, ww = np.meshgrid(coords_h, coords_w, indexing="ij")
    coords = np.stack([hh, ww], axis=-1).reshape(-1, 2) * 2.0 - 1.0   # (hw, 2)
    inv_freq = 1.0 / theta ** np.arange(0, 1, 4 / head_dim, dtype=np.float32)
    angles = 2 * np.pi * coords[:, :, None] * inv_freq[None, None, :]
    angles = angles.reshape(angles.shape[0], -1)
    angles = np.tile(angles, (1, 2))                                 # (hw, head_dim)
    return np.cos(angles), np.sin(angles)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope_to_patches(q, k, cos, sin, num_prefix: int):
    """q, k (B, S, H, D); RoPE on tokens [num_prefix:], the tables in the
    working dtype (JAX keeps bf16 q and k bf16)."""
    cos = cos.to(q.dtype)[None, :, None, :]
    sin = sin.to(q.dtype)[None, :, None, :]
    qp, kp = q[:, num_prefix:], k[:, num_prefix:]
    qp = qp * cos + _rotate_half(qp) * sin
    kp = kp * cos + _rotate_half(kp) * sin
    return (torch.cat([q[:, :num_prefix], qp], dim=1),
            torch.cat([k[:, :num_prefix], kp], dim=1))


class DINOv3Attention(nn.Module):

    def __init__(self, cfg: DINOv3Config, device=None):
        super().__init__()
        self.config = cfg
        d = cfg.hidden_size
        kw = dict(dtype=cfg.dtype, device=device)
        self.q_proj = Dense(d, d, cfg.query_bias, **kw)
        self.k_proj = Dense(d, d, cfg.key_bias, **kw)
        self.v_proj = Dense(d, d, cfg.value_bias, **kw)
        self.o_proj = Dense(d, d, cfg.proj_bias, **kw)

    def forward(self, x, cos, sin, num_prefix: int):
        cfg = self.config
        B, S, d = x.shape
        hd = d // cfg.num_heads
        shape = (B, S, cfg.num_heads, hd)
        q = self.q_proj(x).reshape(shape)
        k = self.k_proj(x).reshape(shape)
        v = self.v_proj(x).reshape(shape)
        q, k = apply_rope_to_patches(q, k, cos, sin, num_prefix)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd ** -0.5
        probs = torch.softmax(logits, dim=-1).to(cfg.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(cfg.dtype)).reshape(B, S, d)
        return self.o_proj(out)


class DINOv3Mlp(nn.Module):

    def __init__(self, cfg: DINOv3Config, device=None):
        super().__init__()
        self.config = cfg
        kw = dict(dtype=cfg.dtype, device=device)
        d, m = cfg.hidden_size, cfg.mlp_dim
        if cfg.use_gated_mlp:
            self.gate_proj = Dense(d, m, cfg.mlp_bias, **kw)
        self.up_proj = Dense(d, m, cfg.mlp_bias, **kw)
        self.down_proj = Dense(m, d, cfg.mlp_bias, **kw)

    def forward(self, x):
        act = ACTIVATIONS[self.config.activation]
        if self.config.use_gated_mlp:
            h = act(self.gate_proj(x)) * self.up_proj(x)
        else:
            h = act(self.up_proj(x))
        return self.down_proj(h)


class DINOv3Block(nn.Module):

    def __init__(self, cfg: DINOv3Config, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        d = cfg.hidden_size
        self.norm1 = nn.LayerNorm(d, eps=cfg.ln_eps, **kw)
        self.attn = DINOv3Attention(cfg, device)
        self.layer_scale1 = nn.Parameter(torch.ones(d, **kw))
        self.norm2 = nn.LayerNorm(d, eps=cfg.ln_eps, **kw)
        self.mlp = DINOv3Mlp(cfg, device)
        self.layer_scale2 = nn.Parameter(torch.ones(d, **kw))

    def forward(self, x, cos, sin, num_prefix: int):
        x = x + self.layer_scale1 * self.attn(self.norm1(x), cos, sin, num_prefix)
        return x + self.layer_scale2 * self.mlp(self.norm2(x))


class DINOv3ViT(nn.Module):

    def __init__(self, config: DINOv3Config, pooling: str = "none", device=None):
        super().__init__()
        if pooling not in ("none", "cls", "mean_all"):
            raise ValueError(f"unknown pooling {pooling}")
        cfg = self.config = config
        self.pooling = pooling
        kw = dict(dtype=cfg.dtype, device=device)
        d = cfg.hidden_size
        self.patch_embed = Dense(cfg.patch_size ** 2 * 3, d, **kw)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, **kw))
        if cfg.num_register_tokens:
            self.register_tokens = nn.Parameter(
                torch.zeros(1, cfg.num_register_tokens, d, **kw))
        self.blocks = nn.ModuleList(DINOv3Block(cfg, device)
                                    for _ in range(cfg.num_layers))
        self.final_ln = nn.LayerNorm(d, eps=cfg.ln_eps, **kw)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels (B, H, W, 3) preprocessed -> (B, S, d), or (B, d) pooled."""
        cfg = self.config
        B, H, W, C = pixels.shape
        p = cfg.patch_size
        gh, gw = H // p, W // p
        x = pixels.reshape(B, gh, p, gw, p, C).permute(0, 1, 3, 2, 4, 5)
        x = self.patch_embed(x.reshape(B, gh * gw, p * p * C))
        d = cfg.hidden_size
        prefix = [self.cls_token.expand(B, 1, d).to(x.dtype)]
        if cfg.num_register_tokens:
            prefix.append(self.register_tokens.expand(
                B, cfg.num_register_tokens, d).to(x.dtype))
        num_prefix = 1 + cfg.num_register_tokens
        x = torch.cat(prefix + [x], dim=1)
        cos, sin = (torch.from_numpy(t).to(x.device) for t in
                    rope_angles(gh, gw, d // cfg.num_heads, cfg.rope_theta))
        for block in self.blocks:
            x = block(x, cos, sin, num_prefix)
        x = self.final_ln(x)
        if self.pooling == "cls":
            return x[:, 0]
        if self.pooling == "mean_all":
            return x.mean(dim=1)
        return x


def init_dinov3(tower: DINOv3ViT, generator: torch.Generator) -> DINOv3ViT:
    """Random weights in place: ``init_tower``'s (Dense kernels N(0,
    1/fan_in), biases zero, LayerNorms identity), then the class and
    register tokens N(0, 0.02) and the LayerScales one, JAX's initialisers
    for those."""
    init_tower(tower, generator)
    with torch.no_grad():
        for name, param in tower.named_parameters():
            if name in ("cls_token", "register_tokens"):
                param.copy_((torch.randn(param.shape, generator=generator) * 0.02)
                            .to(param.dtype))
            elif name.rsplit(".", 1)[-1].startswith("layer_scale"):
                param.fill_(1.0)
    return tower


def convert_hf_dinov3(sd: Mapping[str, np.ndarray], num_layers: int,
                      prefix: str = "") -> Dict[str, torch.Tensor]:
    """HF ``DINOv3ViTModel`` state dict (numpy) -> ``DINOv3ViT`` state dict."""
    from emr2a_tpu_torch.models.convert import (
        _dense,
        _ln,
        _patch_conv_to_dense,
        params_from_jax,
    )

    e = prefix + "embeddings."
    tree = {
        "patch_embed": _patch_conv_to_dense(
            sd[e + "patch_embeddings.weight"], sd.get(e + "patch_embeddings.bias")),
        "cls_token": sd[e + "cls_token"],
        "final_ln": _ln(sd, prefix + "norm"),
    }
    if e + "register_tokens" in sd and sd[e + "register_tokens"].shape[1]:
        tree["register_tokens"] = sd[e + "register_tokens"]
    for i in range(num_layers):
        p = f"{prefix}layer.{i}."
        mlp = {}
        if p + "mlp.gate_proj.weight" in sd:
            mlp["gate_proj"] = _dense(sd, p + "mlp.gate_proj")
        mlp["up_proj"] = _dense(sd, p + "mlp.up_proj")
        mlp["down_proj"] = _dense(sd, p + "mlp.down_proj")
        tree[f"block_{i}"] = {
            "norm1": _ln(sd, p + "norm1"),
            "attn": {name: _dense(sd, p + f"attention.{name}")
                     for name in ("q_proj", "k_proj", "v_proj", "o_proj")},
            "layer_scale1": sd[p + "layer_scale1.lambda1"],
            "norm2": _ln(sd, p + "norm2"),
            "layer_scale2": sd[p + "layer_scale2.lambda1"],
            "mlp": mlp,
        }
    return params_from_jax(tree)
