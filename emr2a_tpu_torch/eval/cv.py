"""Stratified k-fold cross-validated retrieval evaluation, the main eval
engine.

Port of ``emr2a_tpu/eval/cv.py`` (``CVRetrievalEvaluator``) with the same
constructor knobs, the same fold ``metrics.json`` keys (including the
``all_top_labels / all_top_scores / all_top_patient_ids /
test_patient_ids`` lists that step4 reads), ``summary.csv`` and the
confusion-matrix PNG. Differences:

- ``device`` (default ``cuda``) is where the fold math runs: StandardScaler
  -> PCA -> L2 (``ops/stats.py``), the fusion, the score matmul and the
  stable top-k. It runs in float64, as the original sklearn protocol does,
  so that the card and the CPU rank the same neighbours (the JAX package
  works in f32).
- The folds come from ``stratified_kfold``, a numpy copy of sklearn's
  ``StratifiedKFold(shuffle=True)`` fold assignment, seeded through
  ``np.random.RandomState``: the same folds, without sklearn. Step3's
  hold-out split has its copy beside it, ``train_test_split``.
- The confusion PNG needs matplotlib; where it does not import, one warning
  names the PNG that was not written and every other artifact is the same.
  It is drawn with matplotlib alone (JAX's uses seaborn, which imports
  pandas).
"""

from __future__ import annotations

import csv
import json
import logging
import re
import warnings
from math import ceil
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from emr2a_tpu_torch.eval.metrics import (
    compute_confusion_matrix,
    compute_precision_recall_f1,
)
from emr2a_tpu_torch.eval.voting import predictions_from_topk, vote_accuracy
from emr2a_tpu_torch.ops.fusion import concat_fusion_rows
from emr2a_tpu_torch.ops.stats import fit_whiten_transform, whiten_no_pca
from emr2a_tpu_torch.ops.topk import topk_scores

logger = logging.getLogger(__name__)


def make_serializable(obj):
    """numpy -> native types for JSON."""
    if isinstance(obj, dict):
        return {k: make_serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [make_serializable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    return obj


def stratified_kfold(labels: Sequence, n_splits: int, seed: int
                     ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(train indices, test indices) per fold, as
    ``sklearn.model_selection.StratifiedKFold(n_splits, shuffle=True,
    random_state=seed).split(X, labels)`` gives them: classes encoded in
    order of first appearance, per-fold class counts by round robin over the
    sorted codes, then each class's fold ids shuffled by one RandomState."""
    y = np.asarray(labels)
    n = len(y)
    if n_splits < 2:
        raise ValueError(f"n_splits must be at least 2, got {n_splits}")
    if n_splits > n:
        raise ValueError(f"Cannot have number of splits n_splits={n_splits} "
                         f"greater than the number of samples: n_samples={n}.")
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv.reshape(-1)]
    n_classes = len(y_idx)
    y_counts = np.bincount(y_encoded)
    if np.all(n_splits > y_counts):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the "
                         f"number of members in each class.")
    if n_splits > y_counts.min():
        warnings.warn(f"The least populated class in y has only "
                      f"{y_counts.min()} members, which is less than "
                      f"n_splits={n_splits}.", UserWarning)
    y_order = np.sort(y_encoded)
    allocation = np.asarray([np.bincount(y_order[i::n_splits], minlength=n_classes)
                             for i in range(n_splits)])
    rng = np.random.RandomState(seed)
    test_folds = np.empty(n, dtype="i")
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class
    indices = np.arange(n)
    return [(indices[test_folds != i], indices[test_folds == i])
            for i in range(n_splits)]


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """sklearn's ``_approximate_mode``: per-class draws, floored shares
    topped up by largest remainder, ties broken by ``rng.choice``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def _stratified_shuffle_split(y: np.ndarray, n_train: int, n_test: int,
                              rng: np.random.RandomState
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """The first split of sklearn's ``StratifiedShuffleSplit._iter_indices``."""
    classes, y_indices, class_counts = np.unique(
        y, return_inverse=True, return_counts=True)
    y_indices = y_indices.reshape(-1)
    n_classes = classes.shape[0]
    if np.min(class_counts) < 2:
        raise ValueError(
            "The least populated classes in y have only 1 member, which is too "
            "few. The minimum number of groups for any class cannot be less "
            "than 2. Classes with too few members are: %s"
            % (classes[class_counts < 2].tolist()))
    if n_train < n_classes:
        raise ValueError("The train_size = %d should be greater or equal to "
                         "the number of classes = %d" % (n_train, n_classes))
    if n_test < n_classes:
        raise ValueError("The test_size = %d should be greater or equal to "
                         "the number of classes = %d" % (n_test, n_classes))
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(n_classes):
        permutation = rng.permutation(class_counts[i])
        perm_indices = class_indices[i].take(permutation, mode="clip")
        train.extend(perm_indices[:n_i[i]])
        test.extend(perm_indices[n_i[i]:n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def train_test_split(*arrays, stratify, test_size: float,
                     random_state: int) -> list:
    """``sklearn.model_selection.train_test_split(*arrays, test_size=...,
    random_state=..., stratify=...)`` in numpy, for the case step3 takes: a
    float ``test_size`` in (0, 1) (the test count rounds up) and an integer
    seed. The same indices and errors as ``StratifiedShuffleSplit`` gives
    them. Returns the lists [a_train, a_test, b_train, b_test, ...]."""
    n_samples = len(arrays[0])
    if any(len(a) != n_samples for a in arrays):
        raise ValueError(f"Found input variables with inconsistent numbers "
                         f"of samples: {[len(a) for a in arrays]}")
    if not 0 < test_size < 1:
        raise ValueError(f"test_size={test_size} should be either positive and "
                         f"smaller than the number of samples {n_samples} or a "
                         f"float in the (0, 1) range")
    n_test = ceil(test_size * n_samples)
    n_train = n_samples - n_test
    if n_train == 0:
        raise ValueError(f"With n_samples={n_samples}, test_size={test_size} "
                         f"and train_size=None, the resulting train set will be "
                         f"empty. Adjust any of the aforementioned parameters.")
    train, test = _stratified_shuffle_split(
        np.asarray(stratify), n_train, n_test, np.random.RandomState(random_state))
    return [part for a in arrays
            for part in ([a[i] for i in train], [a[i] for i in test])]


class CVRetrievalEvaluator:

    def __init__(self, cv_folds: int = 5, pca_dim: int = 128, top_k: int = 5,
                 seed: int = 42, device: str = "cuda"):
        self.cv_folds = cv_folds
        self.pca_dim = pca_dim
        self.top_k = top_k
        self.seed = seed
        self.device = torch.device(device)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float64), device=self.device)

    # -- splitting (host, numpy: the same folds as sklearn) --

    def stratified_split(self, patient_ids: List[str], labels: List[str]
                         ) -> List[Tuple[List[str], List[str]]]:
        return [([patient_ids[i] for i in train_idx],
                 [patient_ids[i] for i in test_idx])
                for train_idx, test_idx in stratified_kfold(
                    labels, self.cv_folds, self.seed)]

    # -- fold math on the device --

    def process_embeddings(self, train_embeddings: np.ndarray,
                           test_embeddings: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """Scaler -> PCA (clamped to min(pca_dim, n_train - 1, dim)) -> L2."""
        train = self._tensor(train_embeddings)
        test = self._tensor(test_embeddings)
        n_samples, n_features = train.shape
        n_components = min(self.pca_dim, n_samples - 1, n_features)
        if n_components <= 0:
            tr, te = whiten_no_pca(train, test)
        else:
            tr, te = fit_whiten_transform(train, test, n_components)
        return tr.cpu().numpy(), te.cpu().numpy()

    def concat_fusion(self, img_vec: np.ndarray, txt_vec: np.ndarray) -> np.ndarray:
        return concat_fusion_rows(self._tensor(img_vec),
                                  self._tensor(txt_vec)).cpu().numpy()

    def compute_cosine_similarity(self, query_vec: np.ndarray,
                                  db_vecs: np.ndarray) -> np.ndarray:
        """Plain dot (inputs are L2-normalised after whitening)."""
        return (self._tensor(db_vecs) @ self._tensor(query_vec)).cpu().numpy()

    def retrieve_topk(self, query_vec: np.ndarray, db_vecs: np.ndarray,
                      db_labels: List[str], top_k: int,
                      db_ids: Optional[List[str]] = None
                      ) -> Tuple[List[str], List[float], List[str]]:
        """Single-query top-k: labels, scores and ids of the neighbours."""
        vals, idx = self._batched_topk(np.asarray(query_vec)[None, :], db_vecs,
                                       top_k)
        idx, vals = idx[0], vals[0]
        top_labels = [db_labels[i] for i in idx]
        top_scores = [float(v) for v in vals]
        ids = ([db_ids[i] for i in idx] if db_ids
               else [f"neighbor_{i}" for i in idx])
        return top_labels, top_scores, ids

    def compute_vote_accuracy(self, top_labels, top_scores, true_labels,
                              weighted: bool = False) -> float:
        return vote_accuracy(top_labels, top_scores, true_labels, weighted)

    def _topk(self, scores: torch.Tensor, k: int) -> Tuple[np.ndarray, np.ndarray]:
        vals, idx = topk_scores(scores, min(k, scores.shape[-1]))
        return vals.cpu().numpy(), idx.cpu().numpy()

    def _batched_topk(self, query_vecs: np.ndarray, db_vecs: np.ndarray,
                      k: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        scores = self._tensor(query_vecs) @ self._tensor(db_vecs).T
        return self._topk(scores, k or self.top_k)

    def evaluate_fold(self, train_img, train_txt, test_img, test_txt,
                      train_labels: List[str], test_labels: List[str],
                      test_ids: List[str], fusion: str = "concat",
                      top_k_list: Optional[List[int]] = None,
                      w_text: float = 0.5,
                      train_ids: Optional[List[str]] = None) -> Dict:
        if top_k_list is None:
            top_k_list = [1, 3, 5, self.top_k]
        # enough neighbours for every requested top-k metric; the stored
        # all_top_* lists keep self.top_k entries
        k_retrieve = max([self.top_k] + list(top_k_list))

        train_img_proc = test_img_proc = train_txt_proc = test_txt_proc = None
        if train_img is not None and test_img is not None:
            train_img_proc, test_img_proc = self.process_embeddings(train_img, test_img)
        if train_txt is not None and test_txt is not None:
            train_txt_proc, test_txt_proc = self.process_embeddings(train_txt, test_txt)

        if fusion == "image_only":
            if train_img_proc is None or test_img_proc is None:
                raise ValueError("image_only fusion requires image embeddings")
            vals, idx = self._batched_topk(test_img_proc, train_img_proc, k_retrieve)
        elif fusion == "text_only":
            if train_txt_proc is None or test_txt_proc is None:
                raise ValueError("text_only fusion requires text embeddings")
            vals, idx = self._batched_topk(test_txt_proc, train_txt_proc, k_retrieve)
        elif fusion == "concat":
            if (train_img_proc is None or test_img_proc is None
                    or train_txt_proc is None or test_txt_proc is None):
                raise ValueError("concat fusion requires both image and text embeddings")
            db_vecs = self.concat_fusion(train_img_proc, train_txt_proc)
            query_vecs = self.concat_fusion(test_img_proc, test_txt_proc)
            vals, idx = self._batched_topk(query_vecs, db_vecs, k_retrieve)
        elif fusion == "late":
            if (train_img_proc is None or test_img_proc is None
                    or train_txt_proc is None or test_txt_proc is None):
                raise ValueError("late fusion requires both image and text embeddings")
            img_scores = self._tensor(test_img_proc) @ self._tensor(train_img_proc).T
            txt_scores = self._tensor(test_txt_proc) @ self._tensor(train_txt_proc).T
            combined = w_text * txt_scores + (1.0 - w_text) * img_scores
            vals, idx = self._topk(combined, k_retrieve)
        else:
            raise ValueError(f"Unknown fusion type: {fusion}")

        # host bookkeeping over the (q, k_retrieve) results: metrics use the
        # full retrieval, the stored lists and votes self.top_k
        full_top_labels = [[train_labels[j] for j in row] for row in idx]
        all_top_labels = [row[:self.top_k] for row in full_top_labels]
        all_top_scores = [[float(s) for s in row[:self.top_k]] for row in vals]
        if train_ids:
            all_top_patient_ids = [[train_ids[j] for j in row[:self.top_k]]
                                   for row in idx]
        else:
            all_top_patient_ids = [[f"neighbor_{j}" for j in row[:self.top_k]]
                                   for row in idx]

        pred_top1, pred_vote, pred_weighted = predictions_from_topk(
            all_top_labels, all_top_scores)

        results: Dict = {}
        for k in top_k_list:
            hits = [1 if t in lbls[:k] else 0
                    for lbls, t in zip(full_top_labels, test_labels)]
            results[f"top{k}"] = float(np.mean(hits))

        results["vote_acc"] = vote_accuracy(
            all_top_labels, all_top_scores, test_labels, weighted=False)
        results["weighted_vote_acc"] = vote_accuracy(
            all_top_labels, all_top_scores, test_labels, weighted=True)

        labels = sorted(set(train_labels + test_labels))
        prf = compute_precision_recall_f1(pred_vote, test_labels, labels)
        results["macro_precision"] = float(np.mean([v["precision"] for v in prf.values()]))
        results["macro_recall"] = float(np.mean([v["recall"] for v in prf.values()]))
        results["macro_f1"] = float(np.mean([v["f1"] for v in prf.values()]))

        results["confusion_matrix_top1"] = compute_confusion_matrix(
            pred_top1, test_labels, labels)
        results["confusion_matrix_vote"] = compute_confusion_matrix(
            pred_vote, test_labels, labels)

        results["all_top_labels"] = all_top_labels
        results["all_top_scores"] = all_top_scores
        results["all_top_patient_ids"] = all_top_patient_ids
        results["test_patient_ids"] = list(test_ids)
        return results

    def run_cv(self, patient_ids: List[str], labels: List[str],
               embeddings: Dict[str, Dict[str, np.ndarray]],
               fusion: str = "concat", top_k_list: Optional[List[int]] = None,
               w_text: float = 0.5) -> Dict:
        splits = self.stratified_split(patient_ids, labels)
        pid_to_label = dict(zip(patient_ids, labels))

        all_results = []
        for fold_idx, (train_ids, test_ids) in enumerate(splits):
            logger.info("Processing fold %d/%d (train=%d test=%d)",
                        fold_idx + 1, self.cv_folds, len(train_ids), len(test_ids))
            train_labels = [pid_to_label[p] for p in train_ids]
            test_labels = [pid_to_label[p] for p in test_ids]

            train_img = test_img = train_txt = test_txt = None
            if fusion in {"concat", "image_only", "late"}:
                train_img = np.stack([embeddings[p]["image"] for p in train_ids])
                test_img = np.stack([embeddings[p]["image"] for p in test_ids])
            if fusion in {"concat", "text_only", "late"}:
                train_txt = np.stack([embeddings[p]["text"] for p in train_ids])
                test_txt = np.stack([embeddings[p]["text"] for p in test_ids])

            fold_results = self.evaluate_fold(
                train_img, train_txt, test_img, test_txt,
                train_labels, test_labels, test_ids, fusion,
                top_k_list, w_text, train_ids)
            fold_results["fold"] = fold_idx + 1
            fold_results["train_ids"] = train_ids
            all_results.append(fold_results)
            k0 = min(int(k[3:]) for k in fold_results
                     if re.fullmatch(r"top\d+", k))
            logger.info("Fold %d: top%d=%.4f vote=%.4f weighted=%.4f",
                        fold_idx + 1, k0, fold_results[f"top{k0}"],
                        fold_results["vote_acc"],
                        fold_results["weighted_vote_acc"])

        return {"fold_results": all_results,
                "summary": self._compute_summary(all_results)}

    def _compute_summary(self, all_results: List[Dict]) -> Dict:
        summary = {}
        # the top-k keys the folds computed, whatever top_k_list was
        topk_keys = sorted(
            (k for k in all_results[0] if re.fullmatch(r"top\d+", k)),
            key=lambda k: int(k[3:]))
        for metric in topk_keys + ["vote_acc", "weighted_vote_acc",
                                   "macro_precision", "macro_recall",
                                   "macro_f1"]:
            values = [r[metric] for r in all_results]
            summary[metric] = {
                "mean": float(np.mean(values)),
                "std": float(np.std(values)),
                "min": float(np.min(values)),
                "max": float(np.max(values)),
            }
        return summary

    # -- artifacts (the JAX package's layout) --

    def save_results(self, results: Dict, output_dir: Path, experiment_id: str,
                     config: Dict) -> None:
        exp_dir = Path(output_dir) / f"exp_{experiment_id}"
        exp_dir.mkdir(parents=True, exist_ok=True)

        with (exp_dir / "config.json").open("w", encoding="utf-8") as f:
            json.dump(config, f, ensure_ascii=False, indent=2)

        for fold_result in results["fold_results"]:
            fold_dir = exp_dir / f"fold_{fold_result['fold']}"
            fold_dir.mkdir(exist_ok=True)
            with (fold_dir / "metrics.json").open("w", encoding="utf-8") as f:
                json.dump(make_serializable(fold_result), f,
                          ensure_ascii=False, indent=2)

        self._save_summary_csv(results["summary"], exp_dir / "summary.csv")

        if "vlm_review" in results:
            with (exp_dir / "vlm_review_summary.json").open("w", encoding="utf-8") as f:
                json.dump(results["vlm_review"], f, ensure_ascii=False, indent=2)

        self._plot_confusion_matrices(results, exp_dir)
        logger.info("Results saved to %s", exp_dir)

    def _save_summary_csv(self, summary: Dict, output_path: Path) -> None:
        with Path(output_path).open("w", newline="", encoding="utf-8") as f:
            writer = csv.writer(f)
            writer.writerow(["Metric", "Mean", "Std", "Min", "Max"])
            for metric, stats in summary.items():
                writer.writerow([metric, f"{stats['mean']:.4f}",
                                 f"{stats['std']:.4f}", f"{stats['min']:.4f}",
                                 f"{stats['max']:.4f}"])

    def _plot_confusion_matrices(self, results: Dict, output_dir: Path) -> None:
        png = Path(output_dir) / "confusion_matrices.png"
        try:
            import matplotlib
        except ImportError:
            logger.warning("matplotlib is not installed: %s was not written", png)
            return
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        labels = sorted({k for r in results["fold_results"]
                         for k in r["confusion_matrix_top1"].keys()})
        n = len(labels)
        avg = {"top1": np.zeros((n, n)), "vote": np.zeros((n, n))}
        for r in results["fold_results"]:
            for key, cm_key in (("top1", "confusion_matrix_top1"),
                                ("vote", "confusion_matrix_vote")):
                # a fold may lack rare labels entirely -> count 0
                avg[key] += np.array(
                    [[r[cm_key].get(t, {}).get(p, 0) for p in labels]
                     for t in labels])
        for key in avg:
            avg[key] /= len(results["fold_results"])

        # matplotlib alone: seaborn's heatmap (JAX's) would import pandas
        fig, axes = plt.subplots(1, 2, figsize=(12, 5))
        for ax, (key, title) in zip(axes, [("top1", "Confusion Matrix (Top1)"),
                                           ("vote", "Confusion Matrix (Vote)")]):
            im = ax.imshow(avg[key], cmap="Blues")
            ax.set_xticks(range(n), labels)
            ax.set_yticks(range(n), labels)
            for i in range(n):
                for j in range(n):
                    ax.text(j, i, f"{avg[key][i, j]:.1f}", ha="center", va="center")
            fig.colorbar(im, ax=ax)
            ax.set_title(title)
            ax.set_xlabel("Predicted")
            ax.set_ylabel("True")
        plt.tight_layout()
        plt.savefig(png, dpi=150, bbox_inches="tight")
        plt.close(fig)
