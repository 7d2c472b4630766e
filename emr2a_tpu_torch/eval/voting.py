"""Neighbor-vote prediction rules shared by the retrieval evaluators.

Host code, the port's own copy of ``emr2a_tpu/eval/voting.py``.
Tie-breaking parity with the reference:
- majority vote uses ``Counter.most_common(1)`` (first-encountered label
  wins among equal counts — cv_evaluator.py:284-285);
- weighted vote accumulates scores per label in encounter order and
  takes ``max`` over the dict items (first-inserted wins ties —
  cv_evaluator.py:288-293).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence, Tuple


def majority_vote(top_labels: Sequence[str]) -> str:
    return Counter(top_labels).most_common(1)[0][0]


def weighted_vote(top_labels: Sequence[str], top_scores: Sequence[float]) -> str:
    label_to_score: Dict[str, float] = {}
    for label, score in zip(top_labels, top_scores):
        label_to_score[label] = label_to_score.get(label, 0.0) + float(score)
    return max(label_to_score.items(), key=lambda x: x[1])[0]


def vote_accuracy(all_top_labels: List[List[str]],
                  all_top_scores: List[List[float]],
                  true_labels: List[str], weighted: bool = False) -> float:
    """Parity: cv_evaluator.py:132-155."""
    correct = 0
    for labels, scores, truth in zip(all_top_labels, all_top_scores, true_labels):
        pred = weighted_vote(labels, scores) if weighted else majority_vote(labels)
        if pred == truth:
            correct += 1
    return correct / len(true_labels)


def predictions_from_topk(all_top_labels: List[List[str]],
                          all_top_scores: List[List[float]]
                          ) -> Tuple[List[str], List[str], List[str]]:
    """Per-query (top1, majority, weighted) prediction triples."""
    top1 = [labels[0] for labels in all_top_labels]
    vote = [majority_vote(labels) for labels in all_top_labels]
    weighted = [weighted_vote(l, s) for l, s in zip(all_top_labels, all_top_scores)]
    return top1, vote, weighted
