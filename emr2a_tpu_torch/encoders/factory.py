"""Encoder factory with the alias surface of
``emr2a_tpu/encoders/factory.py``. ``fake`` and ``biomedclip`` are ported;
every other family raises until its slice of the port lands."""

from __future__ import annotations

import logging
from typing import Optional

from emr2a_tpu_torch.encoders.base import BaseEncoder
from emr2a_tpu_torch.encoders.biomedclip_encoder import BioMedCLIPEncoder
from emr2a_tpu_torch.encoders.fake import FakeEncoder

_QWEN_8B_ALIASES = {"qwen3_vl", "qwen3", "qwen3_vl_8b", "qwen3_vl_8b_thinking"}
_QWEN_2B_ALIASES = {"qwen3_vl_2b", "qwen3_vl_2b_thinking"}
_CLIP_ALIASES = {"clip", "clip_vit_large_patch14_336"}
_DINO_ALIASES = {"dino", "dinov3", "dinov3_vitl16"}

SUPPORTED_TYPES = sorted(
    _QWEN_8B_ALIASES | _QWEN_2B_ALIASES | _CLIP_ALIASES | _DINO_ALIASES
    | {"vit", "biomedclip", "fake"})
PORTED_TYPES = ("biomedclip", "fake")

logger = logging.getLogger(__name__)


def create_encoder(encoder_type: str, device: str = "cuda",
                   model_path: Optional[str] = None,
                   model_name: Optional[str] = None, **kwargs) -> BaseEncoder:
    et = encoder_type.lower()

    if et == "fake":
        if kwargs.get("mesh") or kwargs.get("fast"):
            logger.warning("fake encoder runs host-side; mesh/fast ignored")
        return FakeEncoder(dim=kwargs.get("dim", 64), device=device)

    if et == "biomedclip":
        return BioMedCLIPEncoder(
            model_path=model_path or kwargs.get("biomedclip_config", {}).get("model_path"),
            device=device, mesh=kwargs.get("mesh"),
            tokenizer=kwargs.get("tokenizer"),
            fast=kwargs.get("fast", False))

    if et in SUPPORTED_TYPES:
        raise NotImplementedError(
            f"encoder type {encoder_type!r} is not yet ported to "
            f"emr2a_tpu_torch (ported: {', '.join(PORTED_TYPES)}); see "
            f"ROADMAP.md Queue 1")
    raise ValueError(
        f"Unsupported encoder type: {encoder_type}. "
        f"Supported types: {SUPPORTED_TYPES}")
