"""BioMedCLIP encoder: open_clip checkpoint -> the port's two towers.

Port of ``emr2a_tpu/encoders/biomedclip_encoder.py``: the timm ViT-B/16
image tower and the PubMedBERT-256 text tower, L2-normalised image and text
features. ``fast=True`` holds both towers in bf16 and routes every image
block through the fused LN+attention and LN+MLP kernels (K3, K1).
``fast="int8"`` first casts the params to bf16, then quantizes the image
trunk and the whole text tree W8A8 (``models/quantize.py``), in the JAX
package's order: every image block then runs K4 and K2, and every BERT
projection K5 (its masked attention never takes a fused block).

``params`` is a state dict of this package with ``image.*`` and,
optionally, ``text.*`` entries, e.g. ``models.convert.params_from_jax(
{"image": ..., "text": ...})`` of a JAX package param tree. Without a text
tree (or a tokenizer) ``encode_batch_texts`` raises.
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional

import numpy as np
import torch

from emr2a_tpu_torch.encoders.jit_encoder import BatchedImageTextEncoder
from emr2a_tpu_torch.models.clip import (
    BioMedCLIPConfig,
    BioMedCLIPImageTower,
    BioMedCLIPTextTower,
    init_tower,
)
from emr2a_tpu_torch.models.convert import (
    convert_biomedclip_image_tower,
    convert_biomedclip_text_tower,
    load_state_dict,
    params_from_jax,
    params_to_jax,
)
from emr2a_tpu_torch.models.layers import load_params
from emr2a_tpu_torch.models.quantize import (
    quantize_params_tree,
    quantize_tower_params,
)
from emr2a_tpu_torch.models.text import BertConfig
from emr2a_tpu_torch.models.vit import BIOMEDCLIP_VIT_B16
from emr2a_tpu_torch.ops.preprocess import BIOMEDCLIP_PREPROCESS


def default_biomedclip_config() -> BioMedCLIPConfig:
    """hf-hub:microsoft/BiomedCLIP-PubMedBERT_256-vit_base_patch16_224:
    timm ViT-B/16 image tower, PubMedBERT (context 256, proj mlp)."""
    return BioMedCLIPConfig(
        vision=BIOMEDCLIP_VIT_B16,
        text=BertConfig(vocab_size=30522, max_length=512, hidden_size=768,
                        num_layers=12, num_heads=12, mlp_dim=3072),
        projection_dim=512, text_proj="mlp")


def _fast_config(config: BioMedCLIPConfig) -> BioMedCLIPConfig:
    """bf16 towers; the image tower gets the fused LN+attention and LN+MLP
    kernels."""
    return dataclasses.replace(
        config,
        vision=dataclasses.replace(config.vision, dtype=torch.bfloat16,
                                   fused_mlp=True, fused_attn=True),
        text=(dataclasses.replace(config.text, dtype=torch.bfloat16)
              if config.text is not None else None))


def _fast_params(params: Mapping, fast) -> dict:
    """Cast f32 params to bf16; with ``fast="int8"`` then quantize the image
    trunk and the text tree."""
    params = {k: torch.as_tensor(v) for k, v in params.items()}
    params = {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v
              for k, v in params.items()}
    if fast != "int8":
        return params
    tree = params_to_jax(params)
    tree["image"]["trunk"] = quantize_tower_params(tree["image"]["trunk"])
    if "text" in tree:
        tree["text"] = quantize_params_tree(tree["text"])
    return params_from_jax(tree)


def _sub(params: Mapping, prefix: str) -> dict:
    return {k[len(prefix):]: torch.as_tensor(v) for k, v in params.items()
            if k.startswith(prefix)}


def _load_tokenizer(model_path):
    """The checkpoint directory's HF tokenizer, from local files only, or
    None when there is none (or no ``transformers``)."""
    try:
        from transformers import AutoTokenizer
        return AutoTokenizer.from_pretrained(str(model_path),
                                             local_files_only=True)
    except Exception:
        return None


class BioMedCLIPEncoder(BatchedImageTextEncoder):

    def __init__(self, model_path: Optional[str] = None, device: str = "cuda",
                 config: Optional[BioMedCLIPConfig] = None,
                 params: Optional[Mapping] = None, tokenizer=None,
                 max_batch: int = 256, context_length: int = 256, mesh=None,
                 fast=False):
        if config is None:
            config = default_biomedclip_config()
        if fast:
            config = _fast_config(config)
        if model_path is not None:
            sd = load_state_dict(model_path)
            params = {f"image.{k}": v for k, v in convert_biomedclip_image_tower(
                sd, config.vision.num_layers).items()}
            if config.text is not None:
                params.update({f"text.{k}": v for k, v in
                               convert_biomedclip_text_tower(
                                   sd, config.text.num_layers).items()})
            if tokenizer is None:
                tokenizer = _load_tokenizer(model_path)
        if params is None:
            raise ValueError("BioMedCLIPEncoder needs model_path or params")
        if fast:
            params = _fast_params(params, fast)
        self.config = config
        self.context_length = context_length
        self._tokenizer = tokenizer
        image = load_params(BioMedCLIPImageTower(config),
                            _sub(params, "image."))
        text_state = _sub(params, "text.")
        text = (load_params(BioMedCLIPTextTower(config), text_state)
                if config.text is not None and text_state else None)
        super().__init__(image, text_model=text, tokenize=self._tokenize_texts,
                         preprocess=BIOMEDCLIP_PREPROCESS, normalize=True,
                         max_batch=max_batch, device=device, mesh=mesh)

    @classmethod
    def random_init(cls, config: Optional[BioMedCLIPConfig] = None,
                    tokenizer=None, seed: int = 0,
                    **kw) -> "BioMedCLIPEncoder":
        """Random f32 weights for both towers (the text tower when
        ``config.text`` is set), drawn image tower first from
        ``torch.Generator().manual_seed(seed)`` (not ``jax.random``'s: the
        two packages' random towers differ)."""
        config = config or default_biomedclip_config()
        gen = torch.Generator().manual_seed(seed)
        params = {f"image.{k}": v for k, v in init_tower(
            BioMedCLIPImageTower(config), gen).state_dict().items()}
        if config.text is not None:
            params.update({f"text.{k}": v for k, v in init_tower(
                BioMedCLIPTextTower(config), gen).state_dict().items()})
        return cls(config=config, params=params, tokenizer=tokenizer, **kw)

    def _tokenize_texts(self, texts: List[str]):
        if self._tokenizer is None:
            raise NotImplementedError("no tokenizer available")
        enc = self._tokenizer(texts, padding="max_length",
                              max_length=self.context_length,
                              truncation=True, return_tensors="np")
        return (enc["input_ids"].astype(np.int32),
                enc["attention_mask"].astype(np.int32))


# The reference exports the typo'd class name; keep the alias.
BioMedCLIPLEncoder = BioMedCLIPEncoder
