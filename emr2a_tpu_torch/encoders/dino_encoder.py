"""DINOv3 image encoder.

Port of ``emr2a_tpu/encoders/dino_encoder.py`` (HF
``facebook/dinov3-vitl16``): the mean over every token of the final LN's
output (cls, registers and patches, ``pooling="mean_all"``), then the L2
norm; text returns ``None``. ``dinov3_config_from_hf`` reads an HF
``config.json``; without one a checkpoint takes ``DINOV3_VITL16``.

DINOv3's blocks (RoPE and LayerScale inside) have no fused-kernel path, so
``fast=True`` is the dtype cut (bf16 params and activations) and
``fast="int8"`` also quantizes every block projection W8A8, which runs on
K5 (``ops/linear_int8.py``); RoPE, softmax and LayerScale stay bf16.

``params`` is a ``DINOv3ViT`` state dict of this package. Without
``model_path`` or ``params`` the tower takes random weights
(``models/dinov3.init_dinov3`` from ``torch.Generator().manual_seed(0)``);
JAX's takes a flax init from ``PRNGKey(0)`` (a recorded divergence).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Mapping, Optional

import torch

from emr2a_tpu_torch.encoders.jit_encoder import BatchedImageTextEncoder, fast_state
from emr2a_tpu_torch.models.convert import load_state_dict
from emr2a_tpu_torch.models.dinov3 import (
    DINOV3_VITL16,
    DINOv3Config,
    DINOv3ViT,
    convert_hf_dinov3,
    init_dinov3,
)
from emr2a_tpu_torch.models.layers import load_params
from emr2a_tpu_torch.ops.preprocess import DINOV3_PREPROCESS


def dinov3_config_from_hf(cfg: dict) -> DINOv3Config:
    return DINOv3Config(
        image_size=cfg.get("image_size", 224),
        patch_size=cfg.get("patch_size", 16),
        hidden_size=cfg.get("hidden_size", 1024),
        num_layers=cfg.get("num_hidden_layers", 24),
        num_heads=cfg.get("num_attention_heads", 16),
        mlp_dim=cfg.get("intermediate_size", 4096),
        activation=cfg.get("hidden_act", "gelu"),
        ln_eps=cfg.get("layer_norm_eps", 1e-5),
        num_register_tokens=cfg.get("num_register_tokens", 0),
        rope_theta=cfg.get("rope_theta", 100.0),
        use_gated_mlp=cfg.get("use_gated_mlp", False),
        query_bias=cfg.get("query_bias", True),
        key_bias=cfg.get("key_bias", False),
        value_bias=cfg.get("value_bias", True),
        proj_bias=cfg.get("proj_bias", True),
        mlp_bias=cfg.get("mlp_bias", True))


class DINOEncoder(BatchedImageTextEncoder):

    def __init__(self, model_path: Optional[str] = None, device: str = "cuda",
                 config: Optional[DINOv3Config] = None,
                 params: Optional[Mapping] = None, max_batch: int = 128,
                 fast=False, mesh=None):
        if model_path is not None:
            mp = Path(model_path)
            if (mp / "config.json").exists():
                with (mp / "config.json").open() as f:
                    config = dinov3_config_from_hf(json.load(f))
            config = config or DINOV3_VITL16
            params = convert_hf_dinov3(load_state_dict(mp), config.num_layers)
        config = config or DINOV3_VITL16
        if params is None:
            params = init_dinov3(
                DINOv3ViT(dataclasses.replace(config, dtype=torch.float32)),
                torch.Generator().manual_seed(0)).state_dict()
        if fast:
            config = dataclasses.replace(config, dtype=torch.bfloat16)
            params = fast_state(params, fast)
        self.config = config
        tower = load_params(DINOv3ViT(config, pooling="mean_all"),
                            {k: torch.as_tensor(v) for k, v in params.items()})
        super().__init__(tower, preprocess=DINOV3_PREPROCESS, normalize=True,
                         max_batch=max_batch, device=device, mesh=mesh)

    def encode_batch_texts(self, texts: List[str]):
        return [None for _ in texts]

    def encode_text(self, text: str):
        return None
