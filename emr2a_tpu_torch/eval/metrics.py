"""Classification metrics over string labels.

Host code, the port's own copy of ``emr2a_tpu/eval/metrics.py``:
accuracy, top-k accuracy over per-query candidate lists, per-label
precision/recall/F1/support, and a labeled nested-dict confusion matrix.
These run on hosts over small lists; no device round-trip is warranted.
``precision_recall_fscore`` (and its macro average) and
``confusion_matrix_array`` are numpy copies of sklearn's, for the baselines (their JAX counterparts call
sklearn).
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


def precision_recall_fscore(y_true, y_pred, labels) -> tuple:
    """Per-label (precision, recall, F1, support) arrays as sklearn's
    ``precision_recall_fscore_support(y_true, y_pred, labels=labels,
    zero_division=0)`` computes them: tp / predicted, tp / true and 2 tp /
    (true + predicted) in f64, 0 where the denominator is 0. Averaging
    with ``np.mean`` gives its ``average="macro"`` (over
    ``np.union1d(y_true, y_pred)`` when sklearn picks the labels)."""
    import numpy as np

    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    tp = np.array([np.sum((y_true == c) & (y_pred == c)) for c in labels])
    pred = np.array([np.sum(y_pred == c) for c in labels])
    true = np.array([np.sum(y_true == c) for c in labels])

    def divide(num, den):
        den = np.asarray(den, np.float64)
        zero = den == 0
        out = np.asarray(num, np.float64) / np.where(zero, 1.0, den)
        out[zero] = 0.0
        return out

    return divide(tp, pred), divide(tp, true), divide(2.0 * tp, true + pred), true


def precision_recall_fscore_macro(y_true, y_pred) -> tuple:
    """sklearn's ``precision_recall_fscore_support(y_true, y_pred,
    average="macro", zero_division=0)[:3]``: the per-label metrics over the
    sorted union of the labels that occur, then their means."""
    import numpy as np

    labels = np.union1d(np.asarray(y_true), np.asarray(y_pred))
    return tuple(float(np.mean(m))
                 for m in precision_recall_fscore(y_true, y_pred, labels)[:3])


def confusion_matrix_array(y_true, y_pred, labels):
    """sklearn's ``confusion_matrix(y_true, y_pred, labels=labels)``: an
    int64 array, rows true, columns predicted, pairs outside ``labels``
    dropped."""
    import numpy as np

    index = {c: i for i, c in enumerate(labels)}
    cm = np.zeros((len(labels), len(labels)), np.int64)
    for t, p in zip(y_true, y_pred):
        if t in index and p in index:
            cm[index[t], index[p]] += 1
    return cm
