"""ViT image encoder (timm vit_base_patch16_224).

Port of ``emr2a_tpu/encoders/vit_encoder.py``: timm ViT-B/16 with gelu and
``avg_fc_norm`` pooling (``TIMM_VIT_B16``; timm's ``num_classes=0,
global_pool="avg"``), a checkpoint read with ``clean_checkpoint_keys`` and
``convert_timm_vit``, image-only (text raises ``NotImplementedError``), and
features not L2-normalised, as in the reference. Preprocessing is timm's
crop_pct 0.9 geometry (224: resize 248, crop 224; another size s: resize
int(s / 0.9), crop s).

``fast=True`` holds the tower in bf16 and routes every block through the
fused LN+attention and LN+MLP kernels (K3, K1); ``fast="int8"`` casts to
bf16, then quantizes the blocks W8A8, which run K4 and K2.

``params`` is a state dict of this package (e.g. ``models.convert.
params_from_jax`` of a JAX ``VisionTransformer`` tree). Without
``model_path`` or ``params`` the tower takes random weights
(``models/clip.init_tower`` from ``torch.Generator().manual_seed(0)``);
JAX's takes a flax init from ``PRNGKey(0)``, so the two packages' random
towers differ (a recorded divergence).
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional

import torch

from emr2a_tpu_torch.encoders.jit_encoder import BatchedImageTextEncoder, fast_state
from emr2a_tpu_torch.models.clip import init_tower
from emr2a_tpu_torch.models.convert import convert_timm_vit, load_state_dict
from emr2a_tpu_torch.models.layers import load_params
from emr2a_tpu_torch.models.vit import TIMM_VIT_B16, ViTConfig, VisionTransformer
from emr2a_tpu_torch.ops.preprocess import TIMM_VIT_PREPROCESS, PreprocessSpec


def clean_checkpoint_keys(sd: dict) -> dict:
    """Strip the wrapper prefixes ``module.`` and ``model.`` from a state
    dict's keys (``emr2a_tpu/encoders/vit_encoder.py:24``)."""
    out = {}
    for k, v in sd.items():
        for prefix in ("module.", "model."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        out[k] = v
    return out


class ViTEncoder(BatchedImageTextEncoder):

    def __init__(self, model_name: str = "vit_base_patch16_224",
                 model_path: Optional[str] = None, device: str = "cuda",
                 config: Optional[ViTConfig] = None,
                 params: Optional[Mapping] = None, max_batch: int = 256,
                 fast=False, mesh=None):
        self.model_name = model_name
        config = config or TIMM_VIT_B16
        if fast:
            config = dataclasses.replace(config, dtype=torch.bfloat16,
                                         fused_mlp=True, fused_attn=True)
        self.config = config
        if model_path is not None:
            sd = clean_checkpoint_keys(load_state_dict(model_path))
            params = convert_timm_vit(sd, config.num_layers)
        if params is None:
            params = init_tower(VisionTransformer(dataclasses.replace(
                config, dtype=torch.float32)), torch.Generator().manual_seed(0)
            ).state_dict()
        if fast:
            params = fast_state(params, fast)
        tower = load_params(VisionTransformer(config),
                            {k: torch.as_tensor(v) for k, v in params.items()})
        if config.image_size == 224:
            spec = TIMM_VIT_PREPROCESS
        else:
            spec = PreprocessSpec(resize_size=int(config.image_size / 0.9),
                                  crop_size=config.image_size,
                                  mean=TIMM_VIT_PREPROCESS.mean,
                                  std=TIMM_VIT_PREPROCESS.std)
        super().__init__(tower, preprocess=spec, normalize=False,
                         max_batch=max_batch, device=device, mesh=mesh)

    def encode_batch_texts(self, texts: List[str]):
        raise NotImplementedError("ViT encoder does not support text encoding")

    def encode_text(self, text: str):
        raise NotImplementedError("ViT encoder does not support text encoding")
