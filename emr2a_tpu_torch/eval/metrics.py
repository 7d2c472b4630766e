"""Classification metrics over string labels.

Host code, the port's own copy of ``emr2a_tpu/eval/metrics.py``:
accuracy, top-k accuracy over per-query candidate lists, per-label
precision/recall/F1/support, and a labeled nested-dict confusion matrix.
These run on hosts over small lists; no device round-trip is warranted.
"""

from __future__ import annotations

from typing import Dict, List


def compute_accuracy(predictions: List[str], ground_truth: List[str]) -> float:
    if len(predictions) != len(ground_truth):
        raise ValueError("Predictions and ground truth must have the same length")
    correct = sum(1 for p, g in zip(predictions, ground_truth) if p == g)
    return correct / len(ground_truth)


def compute_top_k_accuracy(predictions: List[List[str]],
                           ground_truth: List[str], k: int) -> float:
    if len(predictions) != len(ground_truth):
        raise ValueError("Predictions and ground truth must have the same length")
    correct = sum(1 for cand, g in zip(predictions, ground_truth) if g in cand[:k])
    return correct / len(ground_truth)


def compute_precision_recall_f1(predictions: List[str], ground_truth: List[str],
                                labels: List[str]) -> Dict[str, Dict[str, float]]:
    metrics: Dict[str, Dict[str, float]] = {}
    for label in labels:
        tp = sum(1 for p, g in zip(predictions, ground_truth) if p == label and g == label)
        fp = sum(1 for p, g in zip(predictions, ground_truth) if p == label and g != label)
        fn = sum(1 for p, g in zip(predictions, ground_truth) if p != label and g == label)
        precision = tp / (tp + fp) if (tp + fp) > 0 else 0.0
        recall = tp / (tp + fn) if (tp + fn) > 0 else 0.0
        f1 = (2 * precision * recall / (precision + recall)
              if (precision + recall) > 0 else 0.0)
        metrics[label] = {
            "precision": precision,
            "recall": recall,
            "f1": f1,
            "support": sum(1 for g in ground_truth if g == label),
        }
    return metrics


def compute_confusion_matrix(predictions: List[str], ground_truth: List[str],
                             labels: List[str]) -> Dict[str, Dict[str, int]]:
    counts = {t: {p: 0 for p in labels} for t in labels}
    known = set(labels)
    for p, g in zip(predictions, ground_truth):
        if p in known and g in known:
            counts[g][p] += 1
    return counts
