"""Kimi-VL-A3B generation backend: the audit judge on
``models/kimi_vl.KimiVLModel``.

The backend surface is ``QwenVLBackend``'s, and its serving is the same:
``generate`` serves one request through ``Qwen3VLGenerator`` (decode from
CUDA graphs on the card), ``generate_batch`` a static batch, and
``generate_stream`` continuous batching through
``models/serving.ContinuousBatcher``; the prompt's positions and the
cache's layout come from the model. What differs:

- the chat text: Kimi-VL's template (``<|im_system|>``, ``<|im_user|>``,
  ``<|im_assistant|>``, each role then ``<|im_middle|>``, each message
  ended by ``<|im_end|>``; an image is ``<|media_start|>image
  <|media_content|><|media_pad|><|media_end|>``);
- the images (``KimiImageProcessor``): pixels / 255, mean and std 0.5,
  patches of 3 x 14 x 14 in 2 x 2 merge-block order, sides resized to the
  nearest multiple of 28 where they are not one already; each image's
  ``<|media_pad|>`` expands to h x w / 4 tokens (324 for 504 x 504).

``params`` is a state dict of ``KimiVLModel``'s names with its ``config``;
the weights are used as they lie (bf16, the latent cache in bf16). No
checkpoint loader is written yet. ``record_routes`` keeps the expert
choices of every position in the cache (``KimiVLModel.record_routes``), so
that ``generate_stream``'s batcher holds each request's in its
``records``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from emr2a_tpu_torch.judge.qwen_backend import QwenVLBackend
from emr2a_tpu_torch.models.kimi_vl import KimiVLConfig, KimiVLModel
from emr2a_tpu_torch.models.qwen3_vl import Qwen3VLGenerator


def kimi_patches(image: np.ndarray, patch: int = 14, merge: int = 2):
    """(H, W, 3) uint8, sides multiples of ``patch * merge`` -> ((gh * gw,
    3 * patch^2) f32 patches in merge-block order, each (c, y, x); the grid
    (1, gh, gw))."""
    H, W, C = image.shape
    gh, gw = H // patch, W // patch
    x = image.astype(np.float32) * np.float32(2 / 255) - np.float32(1.0)
    x = x.reshape(gh // merge, merge, patch, gw // merge, merge, patch, C)
    x = x.transpose(0, 3, 1, 4, 6, 2, 5)
    return x.reshape(gh * gw, C * patch * patch), (1, gh, gw)


class KimiImageProcessor:
    """The image processor's surface that ``QwenVLBackend._prepare`` calls:
    ``(images=[array], return_tensors="np")`` -> ``pixel_values`` and
    ``image_grid_thw``."""

    def __init__(self, patch: int = 14, merge: int = 2):
        self.patch, self.merge = patch, merge

    def __call__(self, images, return_tensors="np"):
        img = np.asarray(images[0])
        side = self.patch * self.merge
        H, W = img.shape[:2]
        h, w = max(side, round(H / side) * side), max(side, round(W / side) * side)
        if (h, w) != (H, W):
            from PIL import Image
            img = np.asarray(Image.fromarray(img).resize((w, h), Image.BICUBIC))
        patches, grid = kimi_patches(img[..., :3], self.patch, self.merge)
        return {"pixel_values": patches, "image_grid_thw": np.asarray([grid])}


class KimiVLBackend(QwenVLBackend):

    def __init__(self, config: KimiVLConfig, params, tokenizer, prompt_bucket: int = 128,
                 kv_dtype: str = "bf16", decode_chunk: Optional[int] = 64,
                 record_routes: bool = False):
        self.mesh = None
        self.prompt_bucket = prompt_bucket
        self.standardize_images = None
        self.decode_chunk = decode_chunk
        self.config = config
        self.tokenizer = tokenizer
        v = config.vision
        self.image_processor = KimiImageProcessor(v.patch_size, v.spatial_merge_size)
        self.model = KimiVLModel.from_params(config, params, record_routes=record_routes)
        eos = getattr(tokenizer, "eos_token_id", None) or 163586
        self.generator = Qwen3VLGenerator(self.model, eos_token_id=int(eos), kv_dtype=kv_dtype)
        self._batchers = {}
        self.spec_generator = None

    def _render_chat(self, n_images: int, prompt: str, system: Optional[str]) -> str:
        sys_part = f"<|im_system|>system<|im_middle|>{system}<|im_end|>" if system else ""
        img = "<|media_start|>image<|media_content|><|media_pad|><|media_end|>" * n_images
        return (f"{sys_part}<|im_user|>user<|im_middle|>{img}{prompt}<|im_end|>"
                f"<|im_assistant|>assistant<|im_middle|>")
