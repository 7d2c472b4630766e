"""Encoder factory with the alias surface of
``emr2a_tpu/encoders/factory.py`` (``:21-96``), ``fake`` included, and its
per-family kwarg plumbing: ``<family>_config`` dicts carry a default
``model_path`` (and ViT's ``model_name``); the Qwen aliases reject ``mesh``
and ``fast`` with JAX's message. ``tokenizer`` is passed on to the
families that take one (BioMedCLIP, CLIP), so that a run without a
checkpoint can still encode text."""

from __future__ import annotations

import logging
from typing import Optional

from emr2a_tpu_torch.encoders.base import BaseEncoder
from emr2a_tpu_torch.encoders.biomedclip_encoder import BioMedCLIPEncoder
from emr2a_tpu_torch.encoders.clip_encoder import CLIPEncoder
from emr2a_tpu_torch.encoders.dino_encoder import DINOEncoder
from emr2a_tpu_torch.encoders.fake import FakeEncoder
from emr2a_tpu_torch.encoders.vit_encoder import ViTEncoder

_QWEN_8B_ALIASES = {"qwen3_vl", "qwen3", "qwen3_vl_8b", "qwen3_vl_8b_thinking"}
_QWEN_2B_ALIASES = {"qwen3_vl_2b", "qwen3_vl_2b_thinking"}
_CLIP_ALIASES = {"clip", "clip_vit_large_patch14_336"}
_DINO_ALIASES = {"dino", "dinov3", "dinov3_vitl16"}

SUPPORTED_TYPES = sorted(
    _QWEN_8B_ALIASES | _QWEN_2B_ALIASES | _CLIP_ALIASES | _DINO_ALIASES
    | {"vit", "biomedclip", "fake"})

logger = logging.getLogger(__name__)


def _reject_unsupported(et: str, kwargs: dict, *names: str) -> None:
    """A capability the family lacks fails loudly rather than being
    dropped."""
    for name in names:
        if kwargs.get(name):
            raise ValueError(
                f"encoder type {et!r} does not support {name!r} "
                f"(--data_parallel/--fast); drop the flag or pick a "
                f"supporting encoder (clip/biomedclip/vit/dino)")


def create_encoder(encoder_type: str, device: str = "cuda",
                   model_path: Optional[str] = None,
                   model_name: Optional[str] = None, **kwargs) -> BaseEncoder:
    et = encoder_type.lower()
    path_of = lambda family: model_path or kwargs.get(f"{family}_config", {}).get(
        "model_path")

    if et == "fake":
        if kwargs.get("mesh") or kwargs.get("fast"):
            logger.warning("fake encoder runs host-side; mesh/fast ignored")
        return FakeEncoder(dim=kwargs.get("dim", 64), device=device)

    if et in _QWEN_8B_ALIASES or et in _QWEN_2B_ALIASES:
        _reject_unsupported(et, kwargs, "mesh", "fast")
        from emr2a_tpu_torch.encoders.qwen3_vl_encoder import Qwen3VLEncoder
        cfg_key = "qwen3_vl_2b_config" if et in _QWEN_2B_ALIASES else "qwen3_vl_8b_config"
        return Qwen3VLEncoder(
            model_path=model_path or kwargs.get(cfg_key, {}).get("model_path"),
            device=device,
            target_layers=kwargs.get("target_layers", [-3, -2, -1]))

    if et == "vit":
        return ViTEncoder(
            model_name=model_name or kwargs.get("vit_config", {}).get(
                "model_name", "vit_base_patch16_224"),
            model_path=path_of("vit"), device=device, mesh=kwargs.get("mesh"),
            fast=kwargs.get("fast", False))

    if et == "biomedclip":
        return BioMedCLIPEncoder(
            model_path=path_of("biomedclip"), device=device,
            mesh=kwargs.get("mesh"), tokenizer=kwargs.get("tokenizer"),
            fast=kwargs.get("fast", False))

    if et in _CLIP_ALIASES:
        return CLIPEncoder(
            model_path=path_of("clip"), device=device, mesh=kwargs.get("mesh"),
            tokenizer=kwargs.get("tokenizer"), fast=kwargs.get("fast", False))

    if et in _DINO_ALIASES:
        return DINOEncoder(
            model_path=path_of("dino"), device=device, mesh=kwargs.get("mesh"),
            fast=kwargs.get("fast", False))

    raise ValueError(
        f"Unsupported encoder type: {encoder_type}. "
        f"Supported types: {SUPPORTED_TYPES}")
