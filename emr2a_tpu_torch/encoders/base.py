"""Encoder API, the surface of ``emr2a_tpu/encoders/base.py``:
encode_image / encode_text singles and batches, and the path-based
``encode_images`` that decodes and drops failures. The batched call is the
primitive; singles are batches of one.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from pathlib import Path
from typing import List, Optional

import numpy as np

from emr2a_tpu_torch.data.images import load_images_rgb


class BaseEncoder(ABC):

    def __init__(self, device: str = "cuda"):
        self.device = device

    # -- batched primitives (implement these) --

    @abstractmethod
    def encode_batch_images(self, images: List[Optional[np.ndarray]]
                            ) -> List[Optional[np.ndarray]]:
        """uint8 RGB arrays (possibly mixed sizes, None for failures) ->
        per-image embeddings (None preserved positionally)."""

    @abstractmethod
    def encode_batch_texts(self, texts: List[str]) -> List[Optional[np.ndarray]]:
        ...

    # -- conveniences --

    def encode_image(self, image) -> Optional[np.ndarray]:
        arr = np.asarray(image.convert("RGB")) if hasattr(image, "convert") \
            else np.asarray(image)
        return self.encode_batch_images([arr])[0]

    def encode_text(self, text: str) -> Optional[np.ndarray]:
        return self.encode_batch_texts([text])[0]

    def encode_images(self, image_paths: List[Path]) -> np.ndarray:
        """Decode paths, encode, drop failures (failed decodes and encodes
        are silently dropped from the stack)."""
        images = load_images_rgb(image_paths)
        embeddings = self.encode_batch_images(images)
        valid = [e for e in embeddings if e is not None]
        if valid:
            return np.array(valid)
        return np.array([])

    def to(self, device: str):
        self.device = device
        return self
