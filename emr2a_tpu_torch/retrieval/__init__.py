from emr2a_tpu_torch.retrieval.database import ShardedEmbeddingDatabase

__all__ = ["ShardedEmbeddingDatabase"]
