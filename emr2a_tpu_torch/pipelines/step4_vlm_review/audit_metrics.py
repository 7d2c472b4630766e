"""The reference's import location for the audit metrics."""

from emr2a_tpu_torch.eval.audit_metrics import (  # noqa: F401
    AbstainQualityMetrics,
    AuditMetricsAggregator,
    ErrorDetectionMetrics,
    SelectivePredictionMetrics,
    compute_audit_metrics,
)
