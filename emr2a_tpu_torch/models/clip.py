"""BioMedCLIP image tower.

Port of ``emr2a_tpu/models/clip.py:BioMedCLIPImageTower``: the timm
ViT-B/16 trunk, cls-pooled, then a bias-free linear head into the 512-d
CLIP space. The PubMedBERT text tower is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
import torch
from torch import nn

from emr2a_tpu_torch.models.layers import Dense
from emr2a_tpu_torch.models.vit import ViTConfig, VisionTransformer


@dataclass(frozen=True)
class BioMedCLIPConfig:
    """The image side of ``emr2a_tpu.models.clip.BioMedCLIPConfig``; the
    text fields arrive with the text tower."""
    vision: ViTConfig
    projection_dim: int = 512


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


def init_image_tower(tower: BioMedCLIPImageTower,
                     generator: torch.Generator) -> BioMedCLIPImageTower:
    """Random weights in place: Dense kernels N(0, 1/fan_in), position
    embeddings N(0, 0.02), biases and the class token zero, LayerNorms
    identity. Drawn on the CPU from ``generator`` and copied, so a seed
    gives the same weights on every device."""
    with torch.no_grad():
        for name, param in tower.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "kernel":
                std = param.shape[0] ** -0.5
            elif name.endswith("pos_embed"):
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
