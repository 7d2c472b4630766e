"""Step 3 — hold-out retrieval evaluation over embeddings.npz.

Port of ``emr2a_tpu/pipelines/step3_retrieval/evaluate_retrieval.py``: the
same flags and the same ``retrieval_results.json`` (``image_top{1,3,5[,k]}``
and ``image_weighted``: the "none" fusion path computes image-only
metrics), plus ``--device`` (default ``cuda``), where the evaluator's
scores and top-k run (float64; ``retrieval/evaluator.py``). The split is
``eval/cv.train_test_split``, a numpy copy of sklearn's with
``random_state=42, stratify=labels``: the same patients, without sklearn.

    python -m emr2a_tpu_torch.pipelines.step3_retrieval.run \\
        --manifest_path outputs/manifest.jsonl \\
        --embeddings_path outputs/features/embeddings.npz [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from emr2a_tpu_torch.data.manifest import load_manifest
from emr2a_tpu_torch.eval.cv import train_test_split
from emr2a_tpu_torch.retrieval.evaluator import RetrievalEvaluator

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Evaluate retrieval performance")
    parser.add_argument("--manifest_path", default="outputs/manifest.jsonl")
    parser.add_argument("--embeddings_path",
                        default="outputs/features/embeddings.npz")
    parser.add_argument("--output_dir", default="outputs/results")
    parser.add_argument("--test_size", type=float, default=0.2)
    parser.add_argument("--top_k", type=int, default=5)
    parser.add_argument("--text_weight", type=float, default=0.4)
    parser.add_argument("--device", default="cuda",
                        help="where the scores and top-k run: cuda (default) or cpu")
    return parser


def load_embeddings(embeddings_path: Path) -> Dict[str, np.ndarray]:
    data = np.load(embeddings_path)
    return {k: data[k] for k in data.files}


def prepare_data(manifest: List[Dict], embeddings: Dict[str, np.ndarray],
                 test_size: float = 0.2) -> Tuple[List[str], List[str], List[str], List[str]]:
    patient_ids = list(embeddings.keys())
    pid_to_label = {r.get("patient_id"): r.get("label", "unknown")
                    for r in manifest}
    labels = [pid_to_label.get(pid, "unknown") for pid in patient_ids]
    return train_test_split(patient_ids, labels, test_size=test_size,
                            random_state=42, stratify=labels)


def evaluate_retrieval(train_ids, test_ids, train_labels, test_labels,
                       embeddings: Dict[str, np.ndarray], top_k: int = 5,
                       device: str = "cuda") -> Dict:
    evaluator = RetrievalEvaluator(device=device)
    # per-patient mean over the slice axis, then the batched evaluator
    train_emb = np.stack([embeddings[p].mean(axis=0) for p in train_ids])
    test_emb = np.stack([embeddings[p].mean(axis=0) for p in test_ids])
    return evaluator.evaluate_retrieval(
        train_text=None, test_text=None,
        train_image=train_emb, test_image=test_emb,
        train_labels=train_labels, test_labels=test_labels,
        fusion_type="none", top_k_list=[1, 3, 5, top_k])


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    args = build_parser().parse_args(argv)

    manifest = load_manifest(args.manifest_path)
    logger.info("Loaded %d records from manifest", len(manifest))
    embeddings = load_embeddings(Path(args.embeddings_path))
    logger.info("Loaded embeddings for %d patients", len(embeddings))

    train_ids, test_ids, train_labels, test_labels = prepare_data(
        manifest, embeddings, args.test_size)
    logger.info("Train set: %d, Test set: %d", len(train_ids), len(test_ids))

    results = evaluate_retrieval(train_ids, test_ids, train_labels,
                                 test_labels, embeddings, args.top_k,
                                 device=args.device)

    output_dir = Path(args.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    with (output_dir / "retrieval_results.json").open("w", encoding="utf-8") as f:
        json.dump(results, f, ensure_ascii=False, indent=2)
    logger.info("Saved results to %s", output_dir / "retrieval_results.json")

    logger.info("Retrieval evaluation completed")
    logger.info("Image Top-1 accuracy: %.4f", results.get("image_top1", 0))
    logger.info("Image Top-3 accuracy: %.4f", results.get("image_top3", 0))
    logger.info("Image Top-5 accuracy: %.4f", results.get("image_top5", 0))


if __name__ == "__main__":
    main()
