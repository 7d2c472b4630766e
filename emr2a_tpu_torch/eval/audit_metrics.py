"""Selective-prediction / error-detection / abstain-quality metrics of
the step4 audit.

Port of ``emr2a_tpu/eval/audit_metrics.py``: the same output keys, AURC,
error-detection AUROC (0.5 for a single class) and 101-point optimal-F1
scan, and abstain rates. sklearn is not on the card's machine, so
``roc_auc_score``, ``roc_curve``, ``precision_recall_curve`` and
``f1_score`` are numpy copies of sklearn's binary versions (thresholds from
a stable descending sort of the scores; ``roc_curve`` drops the collinear
intermediate points and starts at an ``inf`` threshold;
``precision_recall_curve`` keeps every threshold); ``tests/test_torch_judge.py``
holds them equal to sklearn's.
"""

from __future__ import annotations

import logging
from typing import Dict, List

import numpy as np

logger = logging.getLogger(__name__)


def _clf_curve(y_true: np.ndarray, y_score: np.ndarray):
    """(fps, tps, thresholds) at each distinct score, descending: sklearn's
    ``confusion_matrix_at_thresholds`` for 0/1 labels."""
    y_true = np.asarray(y_true, np.float64)
    y_score = np.asarray(y_score, np.float64)
    # the order inside a run of tied scores does not change the counts
    order = np.argsort(y_score, kind="stable")[::-1]
    y_score, y_true = y_score[order], y_true[order]
    idx = np.r_[np.nonzero(np.diff(y_score))[0], y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    return fps, tps, y_score[idx]


def roc_curve(y_true, y_score):
    """sklearn's ``roc_curve`` (drop_intermediate=True) for 0/1 labels."""
    fps, tps, thresholds = _clf_curve(y_true, y_score)
    if fps.shape[0] > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)),
                              True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds.astype(np.float64)]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thresholds


def roc_auc_score(y_true, y_score) -> float:
    """sklearn's binary ``roc_auc_score``: the trapezoid under
    ``roc_curve``."""
    fpr, tpr, _ = roc_curve(y_true, y_score)
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    return float(trapezoid(tpr, fpr))


def precision_recall_curve(y_true, y_score):
    """sklearn's ``precision_recall_curve`` (drop_intermediate=False) for
    0/1 labels: (precision, recall, thresholds), recall decreasing."""
    fps, tps, thresholds = _clf_curve(y_true, y_score)
    ps = tps + fps
    precision = np.where(ps != 0, np.divide(tps, ps, where=ps != 0,
                                            out=np.zeros_like(tps)), 0.0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    return (np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0],
            thresholds[::-1])


def f1_score(y_true, y_pred, zero_division: float = 0.0) -> float:
    """sklearn's binary ``f1_score`` (positive label 1)."""
    y_true = np.asarray(y_true) == 1
    y_pred = np.asarray(y_pred) == 1
    tp = int(np.sum(y_true & y_pred))
    fp = int(np.sum(~y_true & y_pred))
    fn = int(np.sum(y_true & ~y_pred))
    denom = 2 * tp + fp + fn
    return float(2 * tp / denom) if denom else float(zero_division)


class SelectivePredictionMetrics:
    """Coverage-vs-accuracy trade-off of accept decisions, plus AURC."""

    def __init__(self) -> None:
        self.coverage_curve: List[float] = []
        self.accuracy_curve: List[float] = []
        self.thresholds: List[float] = []
        self.aurc: float = 0.0

    def compute(self, main_predictions: List[str], ground_truth: List[str],
                audit_decisions: List[str],
                audit_confidences: List[float]) -> Dict:
        n = len(main_predictions)
        acceptance = np.where(
            np.asarray(audit_decisions) == "accept",
            np.asarray(audit_confidences, dtype=float), 0.0)
        correct = np.asarray(
            [p == t for p, t in zip(main_predictions, ground_truth)], dtype=float)

        order = np.argsort(acceptance)[::-1]
        # Prefix accuracy over samples ranked by acceptance score.
        cum_correct = np.cumsum(correct[order])
        ks = np.arange(1, n + 1)
        coverage = ks / n
        accuracy = cum_correct / ks

        self.coverage_curve = coverage.tolist()
        self.accuracy_curve = accuracy.tolist()
        self.thresholds = acceptance[order].tolist()
        risks = 1.0 - accuracy
        # np.trapezoid is NumPy>=2 only; fall back on the old name.
        trapezoid = getattr(np, "trapezoid", np.trapz)
        self.aurc = float(trapezoid(risks, coverage))
        return {
            "coverage_curve": self.coverage_curve,
            "accuracy_curve": self.accuracy_curve,
            "thresholds": self.thresholds,
            "aurc": self.aurc,
        }

    def get_metrics_at_coverage(self, target_coverage: float) -> Dict:
        if not self.coverage_curve:
            return {"accuracy": 0.0, "threshold": 0.0}
        idx = int(np.argmin(np.abs(np.asarray(self.coverage_curve) - target_coverage)))
        return {
            "coverage": self.coverage_curve[idx],
            "accuracy": self.accuracy_curve[idx],
            "threshold": self.thresholds[idx],
        }


class ErrorDetectionMetrics:
    """Audit error-scores as a binary detector of main-pipeline errors."""

    def __init__(self) -> None:
        self.auroc: float = 0.0
        self.optimal_threshold: float = 0.5
        self.f1_at_optimal: float = 0.0
        self.precision_curve: List[float] = []
        self.recall_curve: List[float] = []

    def compute(self, main_predictions: List[str], ground_truth: List[str],
                audit_scores: List[float]) -> Dict:
        y_true = np.asarray(
            [1.0 if p != t else 0.0
             for p, t in zip(main_predictions, ground_truth)])
        y_scores = np.asarray(audit_scores, dtype=float)

        if len(np.unique(y_true)) < 2:
            logger.warning(
                "Only one class present in error detection, AUROC undefined")
            self.auroc = 0.5
        else:
            self.auroc = float(roc_auc_score(y_true, y_scores))

        if len(np.unique(y_true)) < 2:
            # sklearn's curves emit NaN tpr/precision for a single
            # class, which json.dump writes as invalid strict JSON —
            # the reference ships that broken artifact
            # (step4_vlm_review/audit_metrics.py:157; reference bug,
            # fixed): degenerate inputs get empty curves instead
            fpr = tpr = roc_thresholds = np.asarray([])
            precision = recall = np.asarray([])
        else:
            fpr, tpr, roc_thresholds = roc_curve(y_true, y_scores)
            precision, recall, _ = precision_recall_curve(y_true, y_scores)
        self.precision_curve = precision.tolist()
        self.recall_curve = recall.tolist()

        thresholds_to_try = np.linspace(0, 1, 101)
        f1s = []
        for thresh in thresholds_to_try:
            y_pred = (y_scores >= thresh).astype(int)
            if y_pred.sum() == 0:
                f1s.append(0.0)
            else:
                f1s.append(f1_score(y_true, y_pred, zero_division=0))
        best = int(np.argmax(f1s))
        self.optimal_threshold = float(thresholds_to_try[best])
        self.f1_at_optimal = float(f1s[best])

        return {
            "auroc": self.auroc,
            "optimal_threshold": self.optimal_threshold,
            "f1_at_optimal": self.f1_at_optimal,
            "fpr": fpr.tolist(),
            "tpr": tpr.tolist(),
            "roc_thresholds": roc_thresholds.tolist(),
        }


class AbstainQualityMetrics:
    """Rates of rejected-errors vs wrongly-rejected-correct predictions."""

    def __init__(self) -> None:
        self.error_rejection_rate: float = 0.0
        self.correct_rejection_rate: float = 0.0
        self.abstain_precision: float = 0.0
        self.abstain_recall: float = 0.0

    def compute(self, main_predictions: List[str], ground_truth: List[str],
                audit_decisions: List[str]) -> Dict:
        is_error = np.asarray(
            [p != t for p, t in zip(main_predictions, ground_truth)])
        is_rejected = np.asarray(
            [d in ("reject", "abstain") for d in audit_decisions])

        n_errors = int(is_error.sum())
        n_correct = int((~is_error).sum())
        n_rejected = int(is_rejected.sum())
        errors_rejected = int((is_error & is_rejected).sum())
        correct_rejected = int((~is_error & is_rejected).sum())

        self.error_rejection_rate = (
            errors_rejected / n_errors if n_errors > 0 else 0.0)
        self.correct_rejection_rate = (
            correct_rejected / n_correct if n_correct > 0 else 0.0)
        self.abstain_precision = (
            errors_rejected / n_rejected if n_rejected > 0 else 0.0)
        self.abstain_recall = self.error_rejection_rate

        denom = self.abstain_precision + self.abstain_recall
        abstain_f1 = (2 * self.abstain_precision * self.abstain_recall / denom
                      if denom > 0 else 0.0)

        return {
            "error_rejection_rate": self.error_rejection_rate,
            "correct_rejection_rate": self.correct_rejection_rate,
            "abstain_precision": self.abstain_precision,
            "abstain_recall": self.abstain_recall,
            "abstain_f1": abstain_f1,
            "n_errors": n_errors,
            "n_correct": n_correct,
            "n_rejected": n_rejected,
            "errors_rejected": errors_rejected,
            "correct_rejected": correct_rejected,
        }


class AuditMetricsAggregator:

    def __init__(self) -> None:
        self.selective = SelectivePredictionMetrics()
        self.error_detection = ErrorDetectionMetrics()
        self.abstain_quality = AbstainQualityMetrics()

    def compute_all(self, main_predictions: List[str], ground_truth: List[str],
                    audit_decisions: List[str], audit_confidences: List[float],
                    audit_scores: List[float]) -> Dict:
        selective = self.selective.compute(
            main_predictions, ground_truth, audit_decisions, audit_confidences)
        error_detection = self.error_detection.compute(
            main_predictions, ground_truth, audit_scores)
        abstain = self.abstain_quality.compute(
            main_predictions, ground_truth, audit_decisions)
        return {
            "selective_prediction": selective,
            "error_detection": error_detection,
            "abstain_quality": abstain,
            "coverage_80": self.selective.get_metrics_at_coverage(0.80),
            "coverage_90": self.selective.get_metrics_at_coverage(0.90),
            "coverage_95": self.selective.get_metrics_at_coverage(0.95),
            "summary": {
                "aurc": selective["aurc"],
                "auroc_error_detection": error_detection["auroc"],
                "error_rejection_rate": abstain["error_rejection_rate"],
                "correct_rejection_rate": abstain["correct_rejection_rate"],
                "abstain_f1": abstain["abstain_f1"],
            },
        }


def compute_audit_metrics(main_predictions: List[str], ground_truth: List[str],
                          audit_decisions: List[str],
                          audit_confidences: List[float],
                          audit_error_scores: List[float]) -> Dict:
    return AuditMetricsAggregator().compute_all(
        main_predictions, ground_truth, audit_decisions, audit_confidences,
        audit_error_scores)
