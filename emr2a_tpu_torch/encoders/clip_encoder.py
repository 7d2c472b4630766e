"""CLIP encoder: HF ``CLIPModel`` checkpoints -> the port's two towers.

Port of ``emr2a_tpu/encoders/clip_encoder.py``: image = the vision tower's
post-LN cls token -> visual projection; text = the EOT-pooled text
transformer -> text projection; both L2-normalised. ``clip_config_from_hf``
reads an HF ``config.json``; ``random_init`` draws random weights for tests
and dry runs.

``fast=True`` holds both towers in bf16; the vision blocks take the fused
LN+attention and LN+MLP kernels (K3, K1, with K1's quick_gelu epilogue)
only where the reference's VMEM rule admits the shape
(``models/layers.py``): ViT-B/16 does, ViT-L/14-336 (S = 577, a 1,024 x
4,096 bf16 MLP) does not and runs the unfused blocks. ``fast="int8"``
casts to bf16, then quantizes both towers W8A8. ViT-L/14-336's int8 MLP
then fits the rule and runs K2 (quick_gelu); its attention still does not
(S = 584), so K4 does not run there and the attention's projections run on
K5. The causal text blocks run every projection on K5.

``params`` is ``{"image": state dict, "text": state dict}`` of this
package (``CLIPImageTower`` / ``CLIPTextTower``). The tokenizer is the
checkpoint's HF tokenizer read with ``local_files_only`` (a recorded
divergence), or the one passed in; without one ``encode_batch_texts``
raises.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Mapping, Optional

import numpy as np
import torch

from emr2a_tpu_torch.encoders.jit_encoder import (
    BatchedImageTextEncoder,
    fast_config,
    fast_state,
    load_hf,
)
from emr2a_tpu_torch.models.clip import (
    CLIPConfig,
    CLIPImageTower,
    CLIPTextTower,
    init_tower,
)
from emr2a_tpu_torch.models.convert import (
    convert_hf_clip_image_tower,
    convert_hf_clip_text_tower,
    load_state_dict,
)
from emr2a_tpu_torch.models.layers import load_params
from emr2a_tpu_torch.models.text import CLIPTextConfig
from emr2a_tpu_torch.models.vit import ViTConfig
from emr2a_tpu_torch.ops.preprocess import CLIP_PREPROCESS, PreprocessSpec


def clip_config_from_hf(cfg: dict) -> CLIPConfig:
    v = cfg.get("vision_config", {})
    t = cfg.get("text_config", {})
    vision = ViTConfig(
        image_size=v.get("image_size", 224),
        patch_size=v.get("patch_size", 32),
        hidden_size=v.get("hidden_size", 768),
        num_layers=v.get("num_hidden_layers", 12),
        num_heads=v.get("num_attention_heads", 12),
        mlp_dim=v.get("intermediate_size", 3072),
        activation=v.get("hidden_act", "quick_gelu"),
        ln_eps=v.get("layer_norm_eps", 1e-5),
        use_pre_layernorm=True, patch_bias=False, pooling="cls_ln")
    text = CLIPTextConfig(
        vocab_size=t.get("vocab_size", 49408),
        max_length=t.get("max_position_embeddings", 77),
        hidden_size=t.get("hidden_size", 512),
        num_layers=t.get("num_hidden_layers", 12),
        num_heads=t.get("num_attention_heads", 8),
        mlp_dim=t.get("intermediate_size", 2048),
        activation=t.get("hidden_act", "quick_gelu"),
        ln_eps=t.get("layer_norm_eps", 1e-5),
        eos_token_id=t.get("eos_token_id", 49407))
    return CLIPConfig(vision=vision, text=text,
                      projection_dim=cfg.get("projection_dim", 512))


class CLIPEncoder(BatchedImageTextEncoder):

    def __init__(self, model_path: Optional[str] = None, device: str = "cuda",
                 config: Optional[CLIPConfig] = None,
                 params: Optional[Mapping[str, Mapping]] = None, tokenizer=None,
                 max_batch: int = 256, mesh=None, fast=False):
        if model_path is not None:
            mp = Path(model_path)
            with (mp / "config.json").open() as f:
                config = clip_config_from_hf(json.load(f))
            sd = load_state_dict(mp)
            params = {"image": convert_hf_clip_image_tower(sd, config.vision.num_layers),
                      "text": convert_hf_clip_text_tower(sd, config.text.num_layers)}
            if tokenizer is None:
                tokenizer = load_hf(mp)
        if config is None:
            raise ValueError("CLIPEncoder needs model_path or (config, params)")
        if fast:
            config = fast_config(config)
            params = {k: fast_state(v, fast) for k, v in params.items()}
        self.config = config
        self._tokenizer = tokenizer
        state = lambda tree: {k: torch.as_tensor(v) for k, v in tree.items()}
        image = load_params(CLIPImageTower(config), state(params["image"]))
        text = load_params(CLIPTextTower(config), state(params["text"]))
        spec = PreprocessSpec(resize_size=config.vision.image_size,
                              crop_size=config.vision.image_size,
                              mean=CLIP_PREPROCESS.mean, std=CLIP_PREPROCESS.std)
        super().__init__(image, text_model=text, tokenize=self._tokenize_texts,
                         preprocess=spec, normalize=True, max_batch=max_batch,
                         device=device, mesh=mesh)

    @classmethod
    def random_init(cls, config: CLIPConfig, tokenizer=None, seed: int = 0,
                    **kw) -> "CLIPEncoder":
        """Random f32 weights for both towers, image tower first, from
        ``torch.Generator().manual_seed(seed)`` (``init_tower``; not
        ``jax.random``'s: the two packages' random towers differ)."""
        f32 = dataclasses.replace(
            config, vision=dataclasses.replace(config.vision, dtype=torch.float32),
            text=dataclasses.replace(config.text, dtype=torch.float32))
        gen = torch.Generator().manual_seed(seed)
        params = {"image": init_tower(CLIPImageTower(f32), gen).state_dict(),
                  "text": init_tower(CLIPTextTower(f32), gen).state_dict()}
        return cls(config=config, params=params, tokenizer=tokenizer, **kw)

    def _tokenize_texts(self, texts: List[str]):
        if self._tokenizer is None:
            raise NotImplementedError("no tokenizer available")
        enc = self._tokenizer(texts, padding="max_length",
                              max_length=self.config.text.max_length,
                              truncation=True, return_tensors="np")
        return enc["input_ids"].astype(np.int32), None
