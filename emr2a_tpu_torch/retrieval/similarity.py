"""numpy-in/numpy-out similarity wrappers.

Port of ``emr2a_tpu/retrieval/similarity.py``: the reference's
``retrieval/similarity.py`` signatures for callers holding numpy arrays;
the compute runs through ``ops/similarity.py`` on the CPU. float64 and
integer inputs are taken in float32, as JAX takes them.
"""

from __future__ import annotations

import numpy as np
import torch

from emr2a_tpu_torch.ops import similarity as _ops


def _tensor(a) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype == np.float64 or arr.dtype.kind in "iub":
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr))


def compute_cosine_similarity(query: np.ndarray, database: np.ndarray) -> np.ndarray:
    return _ops.cosine_similarity(_tensor(query), _tensor(database)).numpy()


def compute_euclidean_similarity(query: np.ndarray, database: np.ndarray) -> np.ndarray:
    return _ops.euclidean_similarity(_tensor(query), _tensor(database)).numpy()
