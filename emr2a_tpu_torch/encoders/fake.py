"""Deterministic fake encoder for tests and pipeline dry-runs.

SURVEY.md §4(c): a hash-based encoder lets every pipeline stage run
end-to-end with no model weights — embeddings are deterministic
functions of content, so artifact contracts and metrics are exactly
reproducible across runs/machines.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional

import numpy as np

from emr2a_tpu_torch.encoders.base import BaseEncoder


def _hash_to_vec(data: bytes, dim: int) -> np.ndarray:
    """SHA256-seeded gaussian vector, L2-normalized."""
    seed = int.from_bytes(hashlib.sha256(data).digest()[:8], "little")
    rng = np.random.RandomState(seed % (2 ** 32))
    v = rng.randn(dim).astype(np.float32)
    return v / np.linalg.norm(v)


class FakeEncoder(BaseEncoder):

    def __init__(self, dim: int = 64, device: str = "cpu", fail_on: str = ""):
        super().__init__(device)
        self.dim = dim
        # substring that triggers an encode failure (tests the reference's
        # skip-and-continue semantics)
        self.fail_on = fail_on

    def encode_batch_images(self, images: List[Optional[np.ndarray]]
                            ) -> List[Optional[np.ndarray]]:
        out: List[Optional[np.ndarray]] = []
        for img in images:
            if img is None:
                out.append(None)
            else:
                arr = np.ascontiguousarray(np.asarray(img, dtype=np.uint8))
                out.append(_hash_to_vec(arr.tobytes() + bytes(arr.shape), self.dim))
        return out

    def encode_batch_texts(self, texts: List[str]) -> List[Optional[np.ndarray]]:
        out: List[Optional[np.ndarray]] = []
        for t in texts:
            if self.fail_on and self.fail_on in t:
                out.append(None)
            else:
                out.append(_hash_to_vec(t.encode("utf-8"), self.dim))
        return out
