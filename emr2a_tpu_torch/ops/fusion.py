"""Early and late fusion of image and text signals.

Port of ``emr2a_tpu/ops/fusion.py``: score normalisation per row (so a
batch of queries is normalised query by query), the weighted late fusion
of score matrices, the weighted concatenation with row L2 (text first), the
single-vector concatenation with the zero-guarded norm, and the CV
evaluator's [image | text] row fusion.
"""

from __future__ import annotations

import torch

from emr2a_tpu_torch.ops.similarity import EPS, l2_normalize, l2_normalize_rows


def normalize_scores(scores: torch.Tensor, mode: str = "none") -> torch.Tensor:
    """``zscore`` (population std) or ``minmax`` over the last axis; any
    other mode returns the scores unchanged."""
    if mode == "zscore":
        mean = scores.mean(dim=-1, keepdim=True)
        std = torch.sqrt(((scores - mean) ** 2).mean(dim=-1, keepdim=True))
        return (scores - mean) / (std + EPS)
    if mode == "minmax":
        mn = scores.amin(dim=-1, keepdim=True)
        mx = scores.amax(dim=-1, keepdim=True)
        return (scores - mn) / (mx - mn + EPS)
    return scores


def late_fusion(text_scores: torch.Tensor, image_scores: torch.Tensor,
                text_weight: float = 0.4, score_mode: str = "none") -> torch.Tensor:
    """w * text + (1 - w) * image over the (optionally normalised) scores."""
    t = normalize_scores(text_scores, score_mode)
    i = normalize_scores(image_scores, score_mode)
    return text_weight * t + (1.0 - text_weight) * i


def early_fusion(text_embeddings: torch.Tensor, image_embeddings: torch.Tensor,
                 text_weight: float = 1.0, image_weight: float = 1.0) -> torch.Tensor:
    """Weighted [text | image] concatenation, then row L2."""
    fused = torch.cat([text_embeddings * text_weight,
                       image_embeddings * image_weight], dim=-1)
    return l2_normalize_rows(fused)


def concat_embeddings(text_emb: torch.Tensor, image_emb: torch.Tensor,
                      text_weight: float = 1.0, image_weight: float = 1.0) -> torch.Tensor:
    """Single-vector weighted [text | image] concatenation with the
    zero-guarded L2 norm."""
    return l2_normalize(torch.cat([text_emb * text_weight,
                                   image_emb * image_weight], dim=0))


def concat_fusion_rows(img: torch.Tensor, txt: torch.Tensor) -> torch.Tensor:
    """Row-wise [image | text] concatenation + eps-L2 norm, the CV
    evaluator's fusion."""
    return l2_normalize_rows(torch.cat([img, txt], dim=-1))
