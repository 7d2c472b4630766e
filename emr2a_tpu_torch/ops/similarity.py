"""Similarity primitives on tensors.

Port of ``emr2a_tpu/ops/similarity.py`` for what the step2 slice uses: the
row-wise L2 normalisation the encoders apply to their features.
"""

from __future__ import annotations

import torch

EPS = 1e-8


def l2_normalize_rows(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Row-wise L2 normalisation with +eps in the denominator
    (``emr2a_tpu/ops/similarity.py:l2_normalize_rows``)."""
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)
