"""Cosine similarity + top-k retrieval, the plain path.

Port of ``emr2a_tpu/ops/topk.py:topk_scores`` and ``cosine_topk`` (the XLA
paths). Ties go to the lowest index, as ``jax.lax.top_k`` gives them:
``torch.topk`` promises no order among equal scores, so the selection is a
stable descending sort. The fused streaming kernel of the JAX package
(``cosine_topk_pallas``) is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

from emr2a_tpu_torch.ops.similarity import l2_normalize_rows


def topk_scores(scores: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., n) scores -> top-k (values, indices), descending, ties to the
    lowest index."""
    values, indices = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def cosine_topk(queries: torch.Tensor, database: torch.Tensor, k: int,
                normalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries (q, dim), database (n, dim) -> values (q, k), indices (q, k),
    scores in f32."""
    queries = queries.float()
    database = database.float()
    if normalize:
        queries = l2_normalize_rows(queries)
        database = l2_normalize_rows(database)
    return topk_scores(torch.matmul(queries, database.T), k)
