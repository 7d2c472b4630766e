"""BioMedCLIP's two towers.

Port of ``emr2a_tpu/models/clip.py``: ``BioMedCLIPImageTower`` (the timm
ViT-B/16 trunk, cls-pooled, then a bias-free linear head into the 512-d
CLIP space) and ``BioMedCLIPTextTower`` (PubMedBERT, cls-pooled, then
open_clip's ``proj="mlp"`` head: bias-free ``proj_fc1`` and ``proj_fc2``
with the exact erf gelu between them). Both return unnormalised
embeddings; the encoders L2-normalise them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from emr2a_tpu_torch.models.layers import Dense
from emr2a_tpu_torch.models.text import BertConfig, BertEncoder
from emr2a_tpu_torch.models.vit import ViTConfig, VisionTransformer


@dataclass(frozen=True)
class BioMedCLIPConfig:
    """``emr2a_tpu.models.clip.BioMedCLIPConfig``; ``text=None`` gives an
    image-only model."""
    vision: ViTConfig
    text: Optional[BertConfig] = None
    projection_dim: int = 512
    # open_clip HFTextEncoder proj="mlp": hidden = (d_model + proj) // 2
    text_proj: str = "mlp"


class BioMedCLIPImageTower(nn.Module):

    def __init__(self, config: BioMedCLIPConfig, device=None):
        super().__init__()
        self.config = config
        self.trunk = VisionTransformer(config.vision, device=device)
        self.head_proj = Dense(config.vision.hidden_size,
                               config.projection_dim, use_bias=False,
                               dtype=config.vision.dtype, device=device)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels (B, H, W, 3) -> unnormalised embeddings (B, proj)."""
        return self.head_proj(self.trunk(pixels))


class BioMedCLIPTextTower(nn.Module):

    def __init__(self, config: BioMedCLIPConfig, device=None):
        super().__init__()
        if config.text is None:
            raise ValueError("BioMedCLIPTextTower needs config.text")
        self.config = config
        text = config.text
        kw = dict(use_bias=False, dtype=text.dtype, device=device)
        self.bert = BertEncoder(text, pooling="cls", device=device)
        d, proj = text.hidden_size, config.projection_dim
        if config.text_proj == "mlp":
            hidden = (d + proj) // 2
            self.proj_fc1 = Dense(d, hidden, **kw)
            self.proj_fc2 = Dense(hidden, proj, **kw)
        else:
            self.proj = Dense(d, proj, **kw)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """input_ids (B, S) -> unnormalised embeddings (B, proj)."""
        pooled = self.bert(input_ids, attention_mask)
        if self.config.text_proj == "mlp":
            h = F.gelu(self.proj_fc1(pooled), approximate="none")
            return self.proj_fc2(h.to(pooled.dtype))
        return self.proj(pooled)


def init_tower(tower: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights in place: Dense kernels N(0, 1/fan_in), position and
    token embeddings N(0, 0.02), biases and the class token zero,
    LayerNorms identity. Drawn on the CPU from ``generator`` in parameter
    order and copied, so a seed gives the same weights on every device."""
    with torch.no_grad():
        for name, param in tower.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "kernel":
                std = param.shape[0] ** -0.5
            elif leaf in ("pos_embed", "embedding"):
                std = 0.02
            elif leaf == "weight":        # LayerNorm scale
                param.fill_(1.0)
                continue
            else:
                param.zero_()
                continue
            draw = torch.randn(param.shape, generator=generator) * std
            param.copy_(draw.to(param.dtype))
    return tower
