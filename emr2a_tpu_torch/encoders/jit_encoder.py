"""The batched encoding engine shared by the port's real encoders.

Port of ``emr2a_tpu/encoders/jit_encoder.py`` (the module keeps its name so
that its counterpart is easy to find; PyTorch runs eagerly, so the engine
is ``BatchedImageTextEncoder``). What it keeps:

- host canonicalisation of mixed-size images to the preprocess size, then
  grouping by shape and chunking to ``max_batch``, so each group is one
  static-shape device batch;
- uint8 batches go to the device; preprocessing, the tower and the final
  L2 normalisation run there;
- the path-based ``encode_images``: for an exact-resize spec (or any spec
  with ``assume_square_sources``), the C++ decode pool
  (``data/native_loader.py``) decodes and resizes chunks of ``max_batch``
  paths on a worker thread, double-buffered against the device: chunk i+1
  is submitted before chunk i's embeddings are read back, each chunk into a
  fresh array, failed rows dropped. Otherwise (BioMedCLIP's shortest-edge
  spec on sources not known to be square, or no C++ compiler) the per-image
  host decode of ``encoders/base.py``, then the batched path;
- the text path: tokenize to one fixed length on the host, chunk to
  ``max_batch``, then the text tower and the L2 normalisation on the
  device.

What it drops: the power-of-two bucket padding of image and text batches,
which bounds JAX recompiles and is only wasted rows in eager PyTorch;
and ``mesh`` (data-parallel ``shard_map`` over chips), which has no one-GPU
counterpart and is rejected. As in the JAX package, subclasses do not take
``assume_square_sources``: a caller sets the attribute.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from emr2a_tpu_torch.data.images import group_by_shape, resize_to
from emr2a_tpu_torch.data.native_loader import decode_batch, native_available
from emr2a_tpu_torch.encoders.base import BaseEncoder
from emr2a_tpu_torch.ops.preprocess import PreprocessSpec, preprocess_images
from emr2a_tpu_torch.ops.similarity import l2_normalize_rows


def fast_state(state: Mapping, fast) -> dict:
    """The encoders' ``fast`` cut of a state dict: every f32 tensor cast to
    bf16 and, with ``fast="int8"``, every tower level of the tree quantized
    W8A8 (``models/quantize.quantize_params_tree``), in the JAX package's
    order (cast, then quantize)."""
    from emr2a_tpu_torch.models.convert import params_from_jax, params_to_jax
    from emr2a_tpu_torch.models.quantize import quantize_params_tree

    state = {k: torch.as_tensor(v) for k, v in state.items()}
    state = {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v
             for k, v in state.items()}
    if fast != "int8":
        return state
    return params_from_jax(quantize_params_tree(params_to_jax(state)))


def fast_config(config):
    """bf16 towers; the image tower gets the fused LN+attention and LN+MLP
    kernels (BioMedCLIP's and CLIP's configs)."""
    return dataclasses.replace(
        config,
        vision=dataclasses.replace(config.vision, dtype=torch.bfloat16,
                                   fused_mlp=True, fused_attn=True),
        text=(dataclasses.replace(config.text, dtype=torch.bfloat16)
              if config.text is not None else None))


def load_hf(model_path, cls_name: str = "AutoTokenizer"):
    """A checkpoint directory's HF tokenizer (or another ``transformers``
    auto class, e.g. ``AutoImageProcessor``) from local files only, or None
    when there is none (or no ``transformers``)."""
    try:
        import transformers
        return getattr(transformers, cls_name).from_pretrained(
            str(model_path), local_files_only=True)
    except Exception:
        return None


class BatchedImageTextEncoder(BaseEncoder):
    """Wraps an image tower (``nn.Module``: preprocessed (B, H, W, 3) f32
    pixels -> (B, D) features) and optionally a text tower (``(input_ids,
    attention_mask | None) -> (B, D)``) with its ``tokenize(texts) -> (ids,
    mask | None)`` (numpy, padded to one length) into the encoder API.
    Features come back as f32 numpy rows, L2-normalised when
    ``normalize``."""

    def __init__(self, image_model: nn.Module,
                 text_model: Optional[nn.Module] = None,
                 tokenize: Optional[Callable] = None,
                 preprocess: PreprocessSpec = PreprocessSpec(),
                 normalize: bool = True, max_batch: int = 256,
                 device: str = "cuda", assume_square_sources: bool = False,
                 mesh=None):
        if mesh is not None:
            raise ValueError(
                "mesh (data-parallel encoding over chips) has no counterpart "
                "in the one-GPU port; drop --data_parallel")
        super().__init__(device)
        self.image_model = image_model.to(device).eval()
        self.text_model = (None if text_model is None
                           else text_model.to(device).eval())
        self._tokenize = tokenize
        self.preprocess = preprocess
        self.normalize = normalize
        self.max_batch = max_batch
        # CT slices are square; setting this lets shortest-edge specs use the
        # decode pool (a square shortest-edge resize is an exact square one).
        self.assume_square_sources = assume_square_sources

    def _finish(self, feats: torch.Tensor) -> np.ndarray:
        feats = feats.float()
        if self.normalize:
            feats = l2_normalize_rows(feats)
        return feats.cpu().numpy()

    @torch.inference_mode()
    def _image_forward(self, batch_u8: np.ndarray) -> np.ndarray:
        images = torch.from_numpy(np.ascontiguousarray(batch_u8)).to(self.device)
        return self._finish(self.image_model(
            preprocess_images(images, self.preprocess)))

    @torch.inference_mode()
    def _text_forward(self, ids: np.ndarray,
                      mask: Optional[np.ndarray]) -> np.ndarray:
        ids_t = torch.from_numpy(ids.astype(np.int64)).to(self.device)
        mask_t = (None if mask is None
                  else torch.from_numpy(mask.astype(np.int64)).to(self.device))
        return self._finish(self.text_model(ids_t, mask_t))

    def encode_batch_images(self, images: List[Optional[np.ndarray]]
                            ) -> List[Optional[np.ndarray]]:
        out: List[Optional[np.ndarray]] = [None] * len(images)
        spec = self.preprocess
        canon: List[Optional[np.ndarray]] = [
            None if img is None else resize_to(
                img, spec.resize_size, shortest_edge=spec.shortest_edge,
                method=spec.method)
            for img in images]
        for idxs in group_by_shape(canon).values():
            for start in range(0, len(idxs), self.max_batch):
                chunk = idxs[start:start + self.max_batch]
                feats = self._image_forward(np.stack([canon[i] for i in chunk]))
                for j, i in enumerate(chunk):
                    out[i] = feats[j]
        return out

    def encode_images(self, image_paths) -> np.ndarray:
        """Path-based encode on the C++ decode pool where the spec allows
        it (see the module docstring), else the per-image host decode."""
        spec = self.preprocess
        if (self.image_model is None
                or (spec.shortest_edge and not self.assume_square_sources)
                or not native_available()):
            return super().encode_images(image_paths)
        size = spec.resize_size
        chunks = [image_paths[s:s + self.max_batch]
                  for s in range(0, len(image_paths), self.max_batch)]
        out_embs: List[np.ndarray] = []
        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(decode_batch, chunks[0], size, size) if chunks else None
            for i in range(len(chunks)):
                batch, ok = fut.result()
                if i + 1 < len(chunks):
                    fut = ex.submit(decode_batch, chunks[i + 1], size, size)
                if not ok.any():
                    continue
                # the device runs this chunk while the worker decodes the next
                out_embs.append(self._image_forward(batch[ok]))
        if out_embs:
            return np.concatenate(out_embs, axis=0)
        return np.array([])

    def encode_batch_texts(self, texts: List[str]) -> List[Optional[np.ndarray]]:
        if self.text_model is None or self._tokenize is None:
            raise NotImplementedError(f"{type(self).__name__} is text-less")
        if not texts:
            return []
        ids, mask = self._tokenize(texts)
        out: List[Optional[np.ndarray]] = []
        for start in range(0, len(texts), self.max_batch):
            stop = start + self.max_batch
            feats = self._text_forward(
                ids[start:stop], None if mask is None else mask[start:stop])
            out.extend(feats[i] for i in range(len(feats)))
        return out

    def to(self, device: str):
        self.image_model.to(device)
        if self.text_model is not None:
            self.text_model.to(device)
        return super().to(device)
