"""Vision Transformer for the image towers.

Port of ``emr2a_tpu/models/vit.py``: patchify-as-matmul (the conv patch
embed as a reshape to (B, n_patches, p*p*3) and one ``Dense``), a class
token, learned position embeddings, an optional pre-LN, pre-LN blocks and
the poolings ``cls_ln`` / ``cls`` / ``mean`` / ``avg_fc_norm`` / ``none``.

``ViTConfig.dtype`` is the dtype the tower's parameters and activations are
held in; ``fused_attn`` / ``fused_mlp`` route the blocks through the fused
ops (see ``models/layers.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from emr2a_tpu_torch.models.layers import Dense, TransformerBlock


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    activation: str = "gelu"
    ln_eps: float = 1e-5          # HF ViT uses 1e-12, CLIP 1e-5
    use_cls_token: bool = True
    use_pre_layernorm: bool = False   # CLIP vision: True
    patch_bias: bool = True           # CLIP vision: False
    pooling: str = "mean"             # "cls_ln" (CLIP) | "mean" | "cls" | "none"
    dtype: torch.dtype = torch.float32
    fused_mlp: bool = False           # fused LN+MLP+residual op
    fused_attn: bool = False          # fused LN+attention+residual op

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


# The zoo's presets (emr2a_tpu/models/vit.py:56-67).
# HF CLIP vision towers: pre-LN, quick_gelu, a bias-free patch embed,
# the post-LN cls token ("pooler").
CLIP_VIT_B16_VISION = ViTConfig(
    activation="quick_gelu", use_pre_layernorm=True, patch_bias=False,
    pooling="cls_ln", ln_eps=1e-5)
CLIP_VIT_L14_336_VISION = ViTConfig(
    image_size=336, patch_size=14, hidden_size=1024, num_layers=24,
    num_heads=16, mlp_dim=4096, activation="quick_gelu",
    use_pre_layernorm=True, patch_bias=False, pooling="cls_ln", ln_eps=1e-5)
# HF ViTModel: LN over the tokens, then the mean of the patches.
HF_VIT_B16 = ViTConfig(ln_eps=1e-12, pooling="mean")
# timm global_pool="avg": the mean of the patch tokens, then fc_norm.
TIMM_VIT_B16 = ViTConfig(ln_eps=1e-6, pooling="avg_fc_norm")
# timm ViT-B/16 inside open_clip's BiomedCLIP: token pooling, eps 1e-6.
BIOMEDCLIP_VIT_B16 = ViTConfig(ln_eps=1e-6, pooling="cls")


class VisionTransformer(nn.Module):

    def __init__(self, config: ViTConfig, device=None):
        super().__init__()
        cfg = self.config = config
        kw = dict(dtype=cfg.dtype, device=device)
        d = cfg.hidden_size
        self.patch_embed = Dense(cfg.patch_size ** 2 * 3, d,
                                 use_bias=cfg.patch_bias, **kw)
        seq = cfg.num_patches
        if cfg.use_cls_token:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, d, **kw))
            seq += 1
        self.pos_embed = nn.Parameter(torch.zeros(1, seq, d, **kw))
        self.pre_ln = (nn.LayerNorm(d, eps=cfg.ln_eps, **kw)
                       if cfg.use_pre_layernorm else None)
        self.blocks = nn.ModuleList(
            TransformerBlock(d, cfg.num_heads, cfg.mlp_dim,
                             activation=cfg.activation, ln_eps=cfg.ln_eps,
                             fused_mlp=cfg.fused_mlp,
                             fused_attn=cfg.fused_attn, **kw)
            for _ in range(cfg.num_layers))
        self.final_ln = nn.LayerNorm(d, eps=cfg.ln_eps, **kw)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels (B, H, W, 3) preprocessed -> pooled (B, hidden), or
        (B, S, hidden) with pooling="none"."""
        cfg = self.config
        B, H, W, C = pixels.shape
        p = cfg.patch_size
        gh, gw = H // p, W // p
        # row-major (ph, pw, c) within a patch, the converter's layout
        x = pixels.reshape(B, gh, p, gw, p, C).permute(0, 1, 3, 2, 4, 5)
        x = self.patch_embed(x.reshape(B, gh * gw, p * p * C))
        if cfg.use_cls_token:
            x = torch.cat([self.cls_token.expand(B, 1, -1).to(x.dtype), x],
                          dim=1)
        seq = x.shape[1]
        x = x + self.pos_embed.to(x.dtype)
        if self.pre_ln is not None:
            x = self.pre_ln(x)

        # Fused path: pad the token axis to a multiple of 8 once and keep
        # it padded through every block; pad keys are masked by valid_len
        # and pad rows are dropped before pooling.
        valid_len: Optional[int] = None
        if cfg.fused_attn and seq % 8:
            valid_len = seq
            x = F.pad(x, (0, 0, 0, (-seq) % 8))
        for block in self.blocks:
            x = block(x, valid_len=valid_len)
        if valid_len is not None:
            x = x[:, :valid_len]

        if cfg.pooling in ("cls_ln", "cls"):
            # LN is row-wise: normalising only the cls row is exact
            return self.final_ln(x[:, 0])
        start = 1 if cfg.use_cls_token else 0
        if cfg.pooling == "mean":
            return self.final_ln(x)[:, start:].mean(dim=1)
        if cfg.pooling == "avg_fc_norm":
            return self.final_ln(x[:, start:].mean(dim=1))
        if cfg.pooling == "none":
            return self.final_ln(x)
        raise ValueError(f"unknown pooling {cfg.pooling}")
