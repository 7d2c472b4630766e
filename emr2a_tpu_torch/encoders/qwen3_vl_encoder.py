"""The Qwen3-VL hidden-state-tap encoder and its image processor.

Port of ``emr2a_tpu/encoders/qwen3_vl_encoder.py``:

- image embedding (``encode_batch_images``): the vision tower's outputs at
  ``target_layers`` (default -3, -2, -1), each mean-pooled over its tokens,
  then averaged across the taps; one image a forward, so a single frame,
  which the tower attends on its flat path (no K8), as JAX's does;
- text embedding (``encode_batch_texts``): the decoder's final hidden state
  (``return_hidden``) of the chat-wrapped prompt, padded to a multiple of
  128 tokens (JAX's compile bucket, kept so that the two agree on the same
  ids) and mean-pooled over its true length (masked: the causal mask keeps
  the padding out of the valid positions, so the bucket changes nothing).

The constructor takes ``model_path`` (``models/checkpoint.load_qwen3_vl``:
config.json, the safetensors or torch files, weights in bf16), or
``(config, params)`` (a state dict of this package), or ``model``, an
already-built ``Qwen3VLModel`` whose weights it shares (the judge's, so that
one card holds one copy); without any of them it raises JAX's
``ValueError``. Divergences: a failed image or text encode is logged and
gives ``None`` only where the image processor or the tokenizer fails (JAX
also catches a failed forward). ``cache_params`` reads and writes the
converted-params cache beside the checkpoint (``models/checkpoint``: the
port's own format where JAX keeps Orbax's).

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

import logging
import math
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from emr2a_tpu_torch.encoders.base import BaseEncoder

logger = logging.getLogger(__name__)

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


class Qwen3VLEncoder(BaseEncoder):

    def __init__(self, model_path: Optional[str] = None, device: str = "cuda",
                 target_layers: Sequence[int] = (-3, -2, -1), config=None,
                 params=None, tokenizer=None, image_processor=None,
                 cache_params: bool = True, model=None):
        from emr2a_tpu_torch.models.qwen3_vl import Qwen3VLModel

        super().__init__(device)
        self.target_layers = list(target_layers)
        if model_path is not None and model is None:
            from emr2a_tpu_torch.encoders.jit_encoder import load_hf
            from emr2a_tpu_torch.models.checkpoint import load_qwen3_vl
            config, params = load_qwen3_vl(Path(model_path), config, params,
                                           cache_params=cache_params)
            if tokenizer is None:
                tokenizer = load_hf(model_path)
            if image_processor is None:
                image_processor = load_hf(model_path, "AutoImageProcessor")
        if model is not None:
            config = model.config
        elif config is None or params is None:
            raise ValueError("Qwen3VLEncoder needs model_path or (config, params)")
        else:
            model = Qwen3VLModel.from_params(
                config, {k: torch.as_tensor(v).to(device) for k, v in params.items()})
        self.config = config
        self.model = model.eval()
        self.tokenizer = tokenizer
        self.image_processor = image_processor or make_image_processor(config.vision)
        self.embed_dim = config.vision.hidden_size

        depth = config.vision.depth
        self.tap_indices = tuple(sorted(
            depth + t if t < 0 else t for t in self.target_layers
            if 0 <= (depth + t if t < 0 else t) < depth))
        if not self.tap_indices:
            raise ValueError(
                f"target_layers {self.target_layers} are all out of "
                f"range for a depth-{depth} vision tower")

    @property
    def _device(self) -> torch.device:
        return next(self.model.parameters()).device

    # -- image path --

    @torch.inference_mode()
    def _tap_embedding(self, patches: np.ndarray, grid) -> np.ndarray:
        _, _, taps = self.model.visual(torch.from_numpy(patches).to(self._device),
                                       grid, tap_layers=self.tap_indices)
        pooled = torch.stack([t.mean(dim=0) for t in taps]).mean(dim=0)
        return pooled.float().cpu().numpy()

    def encode_batch_images(self, images: List[Optional[np.ndarray]]
                            ) -> List[Optional[np.ndarray]]:
        out: List[Optional[np.ndarray]] = []
        for img in images:
            if img is None:
                out.append(None)
                continue
            try:
                proc = self.image_processor(images=[np.asarray(img)],
                                            return_tensors="np")
            except Exception as e:
                logger.warning("Failed to encode image: %s", e)
                out.append(None)
                continue
            grid = tuple(tuple(int(x) for x in g) for g in proc["image_grid_thw"])
            out.append(self._tap_embedding(proc["pixel_values"], grid))
        return out

    # -- text path --

    def _chat_wrap(self, text: str) -> str:
        if self.tokenizer is not None and hasattr(self.tokenizer,
                                                  "apply_chat_template"):
            try:
                return self.tokenizer.apply_chat_template(
                    [{"role": "user", "content": text}], tokenize=False,
                    add_generation_prompt=True)
            except Exception:
                pass
        return text

    @torch.inference_mode()
    def _text_embedding(self, ids: np.ndarray, true_len: int) -> np.ndarray:
        from emr2a_tpu_torch.models.qwen3_vl import compute_mrope_position_ids

        pos = compute_mrope_position_ids(ids, [], self.config.image_token_id)
        lm = self.model.language_model
        dev = self._device
        ids_t = torch.from_numpy(ids).to(dev)
        hidden, _ = lm(lm.embed_tokens(ids_t), torch.from_numpy(pos).to(dev),
                       return_hidden=True)
        valid = (torch.arange(hidden.shape[1], device=dev)[None, :, None]
                 < true_len).to(hidden.dtype)
        denom = torch.tensor(max(true_len, 1), dtype=hidden.dtype, device=dev)
        return ((hidden * valid).sum(dim=1) / denom)[0].float().cpu().numpy()

    def encode_batch_texts(self, texts: List[str]) -> List[Optional[np.ndarray]]:
        if self.tokenizer is None:
            raise NotImplementedError("no tokenizer available")
        out: List[Optional[np.ndarray]] = []
        for text in texts:
            try:
                ids = np.asarray(self.tokenizer(self._chat_wrap(text),
                                                return_tensors="np")["input_ids"],
                                 dtype=np.int64)
            except Exception as e:
                logger.warning("Failed to encode text: %s", e)
                out.append(None)
                continue
            # JAX's 128 bucket: the masked mean makes it exact
            true_len = ids.shape[1]
            bucket = -(-true_len // 128) * 128
            if bucket > true_len:
                ids = np.pad(ids, [(0, 0), (0, bucket - true_len)])
            out.append(self._text_embedding(ids, true_len))
        return out

    def to(self, device: str):
        self.model.to(device)
        return super().to(device)
