"""Hold-out retrieval evaluator.

Port of ``emr2a_tpu/retrieval/evaluator.py`` (``RetrievalEvaluator``): the
same constructor (plus ``device``), the same seeded stratified split
(``random.Random(seed)`` shuffles each label group in order of first
appearance, on the host), the same result keys (``top{k}``,
``text_top{k}``, ``image_top{k}``, the ``weighted`` variants and
``all_top_labels_top5``). Each score matrix is one batched product and one
top-k, ties to the lowest index as ``lax.top_k`` gives them.

``device`` (default ``cuda``) is where the scores, the fusion, the top-k
and ``process_embeddings`` run. The working type is float64 there (JAX:
float32), as the CV evaluator's (``eval/cv.py``), so that the card and the
CPU rank the same neighbours; on seeded embeddings the labels, top-k lists
and metrics equal JAX's (``tests/test_torch_step3.py``).
"""

from __future__ import annotations

import random
from typing import Dict, List, Tuple

import numpy as np
import torch

from emr2a_tpu_torch.eval.voting import weighted_vote
from emr2a_tpu_torch.ops.fusion import early_fusion, late_fusion
from emr2a_tpu_torch.ops.similarity import cosine_similarity_matrix
from emr2a_tpu_torch.ops.stats import fit_whiten_transform, whiten_no_pca
from emr2a_tpu_torch.ops.topk import topk_scores


class RetrievalEvaluator:

    def __init__(self, test_ratio: float = 0.2, seed: int = 42,
                 use_pca: bool = False, pca_dim: int = 128,
                 device: str = "cuda"):
        self.test_ratio = test_ratio
        self.seed = seed
        self.use_pca = use_pca
        self.pca_dim = pca_dim
        self.device = torch.device(device)
        self.rng = random.Random(seed)

    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float64)
        return torch.as_tensor(np.asarray(x, np.float64), device=self.device)

    def stratified_split(self, labels: List[str]) -> Tuple[List[int], List[int]]:
        """Seeded per-label shuffle split. The split is defined by the order
        in which ``random.Random(seed)`` shuffles each label group: groups
        in order of first appearance, one ``shuffle`` call per group."""
        groups: Dict[str, List[int]] = {}
        for idx, label in enumerate(labels):
            groups.setdefault(str(label), []).append(idx)

        per_group = [self._split_group(idxs) for idxs in groups.values()]
        train_idx = [i for tr, _ in per_group for i in tr]
        test_idx = [i for _, te in per_group for i in te]
        return train_idx, test_idx

    def _split_group(self, idxs: List[int]) -> Tuple[List[int], List[int]]:
        """Shuffle one label group in place and carve the leading test
        slice: a group of one goes wholly to train; the test count is
        clamped to [1, len - 1]."""
        self.rng.shuffle(idxs)
        if len(idxs) <= 1:
            return idxs, []
        n_test = max(1, min(int(round(len(idxs) * self.test_ratio)),
                            len(idxs) - 1))
        return idxs[n_test:], idxs[:n_test]

    def process_embeddings(self, train_embeddings: np.ndarray,
                           test_embeddings: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """Scaler -> optional clamped PCA -> row L2."""
        train = self._tensor(train_embeddings)
        test = self._tensor(test_embeddings)
        if self.use_pca:
            n_samples, n_features = train.shape
            n_components = min(self.pca_dim, n_samples - 1, n_features)
            if n_components > 0:
                tr, te = fit_whiten_transform(train, test, n_components)
                return tr.cpu().numpy(), te.cpu().numpy()
        tr, te = whiten_no_pca(train, test)
        return tr.cpu().numpy(), te.cpu().numpy()

    def align_dims(self, train_text, test_text, train_image, test_image):
        if train_text is not None and test_text is not None:
            train_text, test_text = self.process_embeddings(train_text, test_text)
        if train_image is not None and test_image is not None:
            train_image, test_image = self.process_embeddings(train_image, test_image)
        return train_text, test_text, train_image, test_image

    # -- batched internals --

    def _scores(self, test_emb, train_emb) -> torch.Tensor:
        """Cosine score matrix; the reference re-normalises inside its
        similarity call, so do the same here."""
        return cosine_similarity_matrix(self._tensor(test_emb),
                                        self._tensor(train_emb), normalize=True)

    def _matrix_metrics(self, scores: torch.Tensor, train_labels, test_labels,
                        top_k_list, prefix: str = ""):
        """Every per-matrix metric from one top-k: it is sorted descending,
        so ``idx[:, :k]`` is the top-k for each k (``np.argsort[-k:]``
        semantics on cohorts smaller than k)."""
        kmax = min(max(list(top_k_list) + [5]), scores.shape[-1])
        vals, idx = topk_scores(scores, kmax)
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        out: Dict = {}
        for top_k in top_k_list:
            kk = min(top_k, kmax)
            correct = sum(
                1 for i, t in enumerate(test_labels)
                if t in [train_labels[j] for j in idx[i, :kk]])
            out[f"{prefix}top{top_k}"] = correct / len(test_labels)
        k5 = min(5, kmax)
        correct = 0
        for i, t in enumerate(test_labels):
            labels = [train_labels[j] for j in idx[i, :k5]]
            if weighted_vote(labels, vals[i, :k5]) == t:
                correct += 1
        out[f"{prefix}weighted"] = correct / len(test_labels)
        return out, idx

    def evaluate_retrieval(self, train_text, test_text, train_image, test_image,
                           train_labels: List[str], test_labels: List[str],
                           text_weight: float = 0.4, fusion_type: str = "late",
                           score_mode: str = "none",
                           top_k_list: List[int] = [1, 3, 5]) -> Dict:
        results: Dict = {}

        if fusion_type == "early":
            if (train_text is None or test_text is None
                    or train_image is None or test_image is None):
                raise ValueError("Early fusion requires both text and image embeddings")
            train_fused = early_fusion(self._tensor(train_text),
                                       self._tensor(train_image),
                                       text_weight, 1 - text_weight)
            test_fused = early_fusion(self._tensor(test_text),
                                      self._tensor(test_image),
                                      text_weight, 1 - text_weight)
            scores = self._scores(test_fused, train_fused)
            metrics, _ = self._matrix_metrics(scores, train_labels,
                                              test_labels, top_k_list)
            results.update(metrics)
            return results

        text_scores = image_scores = None
        if test_text is not None and train_text is not None:
            text_scores = self._scores(test_text, train_text)
            metrics, _ = self._matrix_metrics(
                text_scores, train_labels, test_labels, top_k_list,
                prefix="text_")
            results.update(metrics)

        if test_image is not None and train_image is not None:
            image_scores = self._scores(test_image, train_image)
            metrics, _ = self._matrix_metrics(
                image_scores, train_labels, test_labels, top_k_list,
                prefix="image_")
            results.update(metrics)

        if text_scores is not None and image_scores is not None:
            fused_scores = late_fusion(text_scores, image_scores,
                                       text_weight, score_mode)
            metrics, idx = self._matrix_metrics(
                fused_scores, train_labels, test_labels, top_k_list)
            results.update(metrics)
            k5 = min(5, idx.shape[1])
            results["all_top_labels_top5"] = [
                [train_labels[j] for j in row] for row in idx[:, :k5]]

        return results

    def get_all_top_labels(self, scores: np.ndarray, train_labels: List[str],
                           test_labels: List[str], top_k: int = 5
                           ) -> List[List[str]]:
        _, idx = topk_scores(self._tensor(scores), min(top_k, scores.shape[-1]))
        return [[train_labels[j] for j in row] for row in idx.cpu().numpy()]
