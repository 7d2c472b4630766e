"""Tracing, timing and the reference-compatible helper re-exports of
``emr2a_tpu/utils/__init__.py``. JAX's ``compile_cache`` (its compilation
cache) has no counterpart here."""

from emr2a_tpu_torch.utils.profiling import (
    StageTimer,
    ThroughputMeter,
    annotate,
    trace_to,
)
from emr2a_tpu_torch.eval.metrics import (  # reference-compatible re-exports
    compute_accuracy,
    compute_confusion_matrix,
    compute_precision_recall_f1,
    compute_top_k_accuracy,
)
from emr2a_tpu_torch.ops.fusion import concat_embeddings
from emr2a_tpu_torch.ops.similarity import l2_normalize

__all__ = [
    "StageTimer",
    "ThroughputMeter",
    "annotate",
    "trace_to",
    "compute_accuracy",
    "compute_top_k_accuracy",
    "compute_precision_recall_f1",
    "compute_confusion_matrix",
    "concat_embeddings",
    "l2_normalize",
]
