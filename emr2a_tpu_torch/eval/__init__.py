from emr2a_tpu_torch.eval.cv import CVRetrievalEvaluator
from emr2a_tpu_torch.eval.metrics import (
    compute_accuracy,
    compute_confusion_matrix,
    compute_precision_recall_f1,
    compute_top_k_accuracy,
)

__all__ = [
    "compute_accuracy",
    "compute_top_k_accuracy",
    "compute_precision_recall_f1",
    "compute_confusion_matrix",
    "CVRetrievalEvaluator",
]
