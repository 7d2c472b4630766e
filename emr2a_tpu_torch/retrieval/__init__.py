from emr2a_tpu_torch.ops.fusion import early_fusion, late_fusion, normalize_scores
from emr2a_tpu_torch.ops.similarity import (
    cosine_similarity as compute_cosine_similarity_jax,
    euclidean_similarity as compute_euclidean_similarity_jax,
)
from emr2a_tpu_torch.retrieval.database import ShardedEmbeddingDatabase
from emr2a_tpu_torch.retrieval.evaluator import RetrievalEvaluator
from emr2a_tpu_torch.retrieval.similarity import (
    compute_cosine_similarity,
    compute_euclidean_similarity,
)

# The ``*_jax`` names are the JAX package's exports, kept so that callers
# written against it import unchanged: here they are the tensor-in ops.
__all__ = [
    "compute_cosine_similarity",
    "compute_euclidean_similarity",
    "compute_cosine_similarity_jax",
    "compute_euclidean_similarity_jax",
    "late_fusion",
    "early_fusion",
    "normalize_scores",
    "ShardedEmbeddingDatabase",
    "RetrievalEvaluator",
]
