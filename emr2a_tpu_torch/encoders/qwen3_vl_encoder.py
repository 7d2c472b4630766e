"""The Qwen3-VL image processor (the hidden-state-tap encoder is not
ported yet: ROADMAP.md, Queue 1, item 4).

``make_image_processor`` is ``emr2a_tpu/encoders/qwen3_vl_encoder.py``'s,
which builds transformers' ``Qwen2VLImageProcessor``. The card's machine has
no ``transformers``, so ``QwenImageProcessor`` is a numpy/PIL copy of that
class's image path: ``smart_resize`` to a multiple of patch * merge within
[min_pixels, max_pixels], a PIL bicubic resize, rescale by 1/255 (in f64,
then f32), the CLIP mean and std, the frame repeated to the temporal patch,
and the patches flattened in merge order. ``tests/test_torch_judge.py``
holds it to transformers' class (pixel values within 1e-6, grids equal).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
from PIL import Image

OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def smart_resize(height: int, width: int, factor: int = 28,
                 min_pixels: int = 56 * 56, max_pixels: int = 14 * 14 * 4 * 1280):
    """(h, w) divisible by ``factor``, with h * w in [min_pixels,
    max_pixels] and the aspect ratio kept as closely as possible."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError(f"absolute aspect ratio must be smaller than 200, got "
                         f"{max(height, width) / min(height, width)}")
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, math.floor(height / beta / factor) * factor)
        w_bar = max(factor, math.floor(width / beta / factor) * factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


class QwenImageProcessor:
    """``processor(images=[...], return_tensors="np")`` -> ``{"pixel_values":
    (sum t*h*w, C * temporal * patch^2) f32, "image_grid_thw": (n, 3)}``,
    one grid per image. Images are PIL images or (H, W, 3) uint8 arrays."""

    def __init__(self, patch_size: int = 14, temporal_patch_size: int = 2,
                 merge_size: int = 2, min_pixels: int = 56 * 56,
                 max_pixels: int = 28 * 28 * 1280,
                 image_mean: Optional[Sequence[float]] = None,
                 image_std: Optional[Sequence[float]] = None):
        self.patch_size = patch_size
        self.temporal_patch_size = temporal_patch_size
        self.merge_size = merge_size
        self.min_pixels = min_pixels
        self.max_pixels = max_pixels
        self.image_mean = np.asarray(image_mean or OPENAI_CLIP_MEAN, np.float32)
        self.image_std = np.asarray(image_std or OPENAI_CLIP_STD, np.float32)

    def _patches(self, image) -> tuple:
        if isinstance(image, Image.Image):
            image = image.convert("RGB")
        else:
            image = Image.fromarray(np.asarray(image, np.uint8))
        width, height = image.size
        p, m, tp = self.patch_size, self.merge_size, self.temporal_patch_size
        rh, rw = smart_resize(height, width, factor=p * m,
                              min_pixels=self.min_pixels, max_pixels=self.max_pixels)
        arr = np.array(image.resize((rw, rh), resample=Image.BICUBIC))
        arr = (arr.astype(np.float64) * (1 / 255)).astype(np.float32)
        arr = (arr - self.image_mean) / self.image_std
        frames = np.repeat(arr.transpose(2, 0, 1)[None], tp, axis=0)  # (tp, C, H, W)
        c = frames.shape[1]
        gh, gw = rh // p, rw // p
        x = frames.reshape(1, tp, c, gh // m, m, p, gw // m, m, p)
        x = x.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
        return x.reshape(gh * gw, c * tp * p * p), (1, gh, gw)

    def __call__(self, images, return_tensors: str = "np"):
        patches, grids = zip(*(self._patches(img) for img in images))
        return {"pixel_values": np.concatenate(patches, axis=0),
                "image_grid_thw": np.asarray(grids, np.int64)}


def make_image_processor(vision_cfg, min_pixels: int = 56 * 56,
                         max_pixels: int = 12845056, **kwargs) -> QwenImageProcessor:
    """The Qwen patch-layout image processor of a vision config (CLIP
    normalisation; pass ``image_mean`` / ``image_std`` for other
    releases)."""
    return QwenImageProcessor(
        patch_size=vision_cfg.patch_size,
        temporal_patch_size=vision_cfg.temporal_patch_size,
        merge_size=vision_cfg.spatial_merge_size,
        min_pixels=min_pixels, max_pixels=max_pixels, **kwargs)
