"""Similarity primitives on tensors.

Port of ``emr2a_tpu/ops/similarity.py``: the row-wise L2 normalisation the
encoders and the retrieval path apply, the single-vector normalisation with
the reference's zero guard, and the cosine and max-normalised euclidean
similarities. Scores of bf16 inputs are taken in f32, as the JAX package
asks for with ``preferred_element_type``.
"""

from __future__ import annotations

import torch

EPS = 1e-8


def l2_normalize(vec: torch.Tensor) -> torch.Tensor:
    """Single-vector L2 normalisation; a zero vector comes back unchanged."""
    norm = torch.linalg.vector_norm(vec)
    return torch.where(norm == 0, vec, vec / torch.where(norm == 0, 1.0, norm))


def l2_normalize_rows(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Row-wise L2 normalisation with +eps in the denominator
    (``emr2a_tpu/ops/similarity.py:l2_normalize_rows``)."""
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def cosine_similarity(query: torch.Tensor, database: torch.Tensor) -> torch.Tensor:
    """One query (dim,) against the database (n, dim) -> (n,)."""
    q = query / (torch.linalg.vector_norm(query) + EPS)
    return l2_normalize_rows(database) @ q


def cosine_similarity_matrix(queries: torch.Tensor, database: torch.Tensor,
                             normalize: bool = True) -> torch.Tensor:
    """(q, dim) x (n, dim) -> (q, n) scores; with ``normalize=False`` the
    inputs are taken as pre-normalised. Low-precision inputs are scored
    in f32."""
    if normalize:
        queries = l2_normalize_rows(queries)
        database = l2_normalize_rows(database)
    if queries.dtype in (torch.bfloat16, torch.float16):
        queries, database = queries.float(), database.float()
    return queries @ database.T


def euclidean_similarity(query: torch.Tensor, database: torch.Tensor) -> torch.Tensor:
    """1 - distance / max distance (1 - distance when every distance is 0)."""
    distances = torch.linalg.vector_norm(database - query[None, :], dim=1)
    max_dist = distances.max()
    return torch.where(max_dist > 0, 1.0 - distances / max_dist, 1.0 - distances)
