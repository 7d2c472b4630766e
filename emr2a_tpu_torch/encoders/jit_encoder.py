"""The batched image-encoding engine shared by the port's real encoders.

Port of ``emr2a_tpu/encoders/jit_encoder.py`` (the module keeps its name so
that its counterpart is easy to find; PyTorch runs eagerly, so the engine
is ``BatchedImageEncoder``). What it keeps:

- host canonicalisation of mixed-size images to the preprocess size, then
  grouping by shape and chunking to ``max_batch``, so each group is one
  static-shape device batch;
- uint8 batches go to the device; preprocessing, the tower and the final
  L2 normalisation run there;
- the path-based ``encode_images`` (``encoders/base.py``): host decode,
  then the batched path.

What it drops: the power-of-two bucket padding of batches, which bounds
JAX recompiles and is only wasted rows in eager PyTorch; ``mesh``
(data-parallel ``shard_map`` over chips), which has no one-GPU
counterpart and is rejected; and the C++ decode-pool branch of
``encode_images``, which BioMedCLIP's shortest-edge spec never takes (it
returns with the first exact-resize encoder).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn

from emr2a_tpu.data.images import group_by_shape, resize_to
from emr2a_tpu_torch.encoders.base import BaseEncoder
from emr2a_tpu_torch.ops.preprocess import PreprocessSpec, preprocess_images
from emr2a_tpu_torch.ops.similarity import l2_normalize_rows


class BatchedImageEncoder(BaseEncoder):
    """Wraps an image tower (``nn.Module``: preprocessed (B, H, W, 3) f32
    pixels -> (B, D) features) into the encoder API. Features come back as
    f32 numpy rows, L2-normalised when ``normalize``."""

    def __init__(self, image_model: nn.Module,
                 preprocess: PreprocessSpec = PreprocessSpec(),
                 normalize: bool = True, max_batch: int = 256,
                 device: str = "cuda", mesh=None):
        if mesh is not None:
            raise ValueError(
                "mesh (data-parallel encoding over chips) has no counterpart "
                "in the one-GPU port; drop --data_parallel")
        super().__init__(device)
        self.image_model = image_model.to(device).eval()
        self.preprocess = preprocess
        self.normalize = normalize
        self.max_batch = max_batch

    @torch.inference_mode()
    def _image_forward(self, batch_u8: np.ndarray) -> np.ndarray:
        images = torch.from_numpy(np.ascontiguousarray(batch_u8)).to(self.device)
        feats = self.image_model(preprocess_images(images, self.preprocess))
        feats = feats.float()
        if self.normalize:
            feats = l2_normalize_rows(feats)
        return feats.cpu().numpy()

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

    def encode_batch_texts(self, texts: List[str]) -> List[Optional[np.ndarray]]:
        raise NotImplementedError(f"{type(self).__name__} is image-only")

    def to(self, device: str):
        self.image_model.to(device)
        return super().to(device)
