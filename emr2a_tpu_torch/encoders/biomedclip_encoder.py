"""BioMedCLIP encoder: open_clip checkpoint -> the port's image tower.

Port of ``emr2a_tpu/encoders/biomedclip_encoder.py`` for the image side.
``fast=True`` holds the tower in bf16 and routes every block through the
fused LN+attention and LN+MLP kernels (the same semantics as the JAX
package's ``fast=True``: bf16 weights, fused flags). ``fast="int8"`` is not
ported yet and raises, as does ``encode_batch_texts``: the text side
(tokenizer, PubMedBERT tower) arrives with the text tower's port.
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional

import numpy as np
import torch

from emr2a_tpu_torch.encoders.jit_encoder import BatchedImageEncoder
from emr2a_tpu_torch.models.clip import (
    BioMedCLIPConfig,
    BioMedCLIPImageTower,
    init_image_tower,
)
from emr2a_tpu_torch.models.convert import (
    convert_biomedclip_image_tower,
    load_state_dict,
)
from emr2a_tpu_torch.models.vit import BIOMEDCLIP_VIT_B16
from emr2a_tpu_torch.ops.preprocess import BIOMEDCLIP_PREPROCESS

_INT8_TODO = ("fast='int8' (W8A8 tower) is not ported yet: ROADMAP.md, "
              "Queue 1, the int8 image tower")
_TEXT_TODO = ("the PubMedBERT text tower is not ported yet: ROADMAP.md, "
              "Queue 1, the text tower")


def default_biomedclip_config() -> BioMedCLIPConfig:
    """hf-hub:microsoft/BiomedCLIP-PubMedBERT_256-vit_base_patch16_224:
    timm ViT-B/16 image tower projected to 512 (the PubMedBERT text tower's
    config arrives with its port)."""
    return BioMedCLIPConfig(vision=BIOMEDCLIP_VIT_B16, projection_dim=512)


def _fast_config(config: BioMedCLIPConfig) -> BioMedCLIPConfig:
    """bf16 tower with the fused LN+attention and LN+MLP kernels."""
    return dataclasses.replace(
        config, vision=dataclasses.replace(
            config.vision, dtype=torch.bfloat16, fused_mlp=True,
            fused_attn=True))


class BioMedCLIPEncoder(BatchedImageEncoder):
    """``params``: a ``BioMedCLIPImageTower`` state dict (torch tensors or
    numpy arrays, e.g. from ``models.convert.params_from_jax``)."""

    def __init__(self, model_path: Optional[str] = None, device: str = "cuda",
                 config: Optional[BioMedCLIPConfig] = None,
                 params: Optional[Mapping] = None, max_batch: int = 256,
                 mesh=None, fast=False):
        if fast == "int8":
            raise NotImplementedError(_INT8_TODO)
        if config is None:
            config = default_biomedclip_config()
        if model_path is not None:
            params = convert_biomedclip_image_tower(
                load_state_dict(model_path), config.vision.num_layers)
        if params is None:
            raise ValueError("BioMedCLIPEncoder needs model_path or params")
        if fast:
            config = _fast_config(config)
        self.config = config
        tower = BioMedCLIPImageTower(config)
        tower.load_state_dict({k: torch.as_tensor(v)
                               for k, v in params.items()})
        super().__init__(tower, preprocess=BIOMEDCLIP_PREPROCESS,
                         normalize=True, max_batch=max_batch, device=device,
                         mesh=mesh)

    @classmethod
    def random_init(cls, config: Optional[BioMedCLIPConfig] = None,
                    seed: int = 0, **kw) -> "BioMedCLIPEncoder":
        """Random f32 weights from ``torch.Generator().manual_seed(seed)``
        (not ``jax.random``'s: the two packages' random towers differ)."""
        config = config or default_biomedclip_config()
        tower = init_image_tower(BioMedCLIPImageTower(config),
                                 torch.Generator().manual_seed(seed))
        return cls(config=config, params=tower.state_dict(), **kw)

    def encode_batch_texts(self, texts: List[str]) -> List[Optional[np.ndarray]]:
        raise NotImplementedError(_TEXT_TODO)


# The reference exports the typo'd class name; keep the alias.
BioMedCLIPLEncoder = BioMedCLIPEncoder
