"""Per-class metrics from stored CNN-baseline fold confusion matrices.

The port's own copy of ``emr2a_tpu/baselines/cnn/compute_cnn_metrics.py``
(numpy only): per-class precision/recall/F1/specificity over the 4
classes, mean±std over folds, plus a markdown table; the report string is
JAX's character for character.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List

import numpy as np

CLASSES = ["Bacterial", "Normal", "PJP", "Viral"]


def compute_per_class_metrics(confusion_matrix_list: List[np.ndarray],
                              classes: List[str] = CLASSES) -> Dict:
    all_metrics = {cls: {"precision": [], "recall": [], "f1": [],
                         "specificity": []} for cls in classes}
    for cm in confusion_matrix_list:
        cm = np.asarray(cm)
        for i, cls in enumerate(classes):
            tp = cm[i, i]
            fp = cm[:, i].sum() - tp  # rows=true, cols=pred
            fn = cm[i, :].sum() - tp
            tn = cm.sum() - tp - fp - fn
            precision = tp / (tp + fp) if (tp + fp) > 0 else 0.0
            recall = tp / (tp + fn) if (tp + fn) > 0 else 0.0
            f1 = (2 * precision * recall / (precision + recall)
                  if (precision + recall) > 0 else 0.0)
            specificity = tn / (tn + fp) if (tn + fp) > 0 else 0.0
            all_metrics[cls]["precision"].append(precision)
            all_metrics[cls]["recall"].append(recall)
            all_metrics[cls]["f1"].append(f1)
            all_metrics[cls]["specificity"].append(specificity)
    return all_metrics


def format_report(all_metrics: Dict, classes: List[str] = CLASSES) -> str:
    lines = ["=" * 80, "Per-Class Metrics (mean±std over folds)", "=" * 80, ""]
    for cls in classes:
        m = all_metrics[cls]
        lines.append(f"### {cls}")
        for name in ("precision", "recall", "f1", "specificity"):
            lines.append(f"  {name.capitalize():11s} "
                         f"{np.mean(m[name]):.4f} ± {np.std(m[name]):.4f}")
        lines.append("")
    lines += ["| Class     | Precision (mean±std) | Recall (mean±std) | "
              "F1 (mean±std) | Specificity (mean±std) |",
              "|-----------|---------------------|------------------|"
              "---------------|----------------------|"]
    for cls in classes:
        m = all_metrics[cls]
        cells = [f"{np.mean(m[k]):.4f}±{np.std(m[k]):.4f}"
                 for k in ("precision", "recall", "f1", "specificity")]
        lines.append(f"| {cls:9s} | {cells[0]:19s} | {cells[1]:16s} | "
                     f"{cells[2]:13s} | {cells[3]:20s} |")
    return "\n".join(lines)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Compute per-class metrics for CNN baseline")
    parser.add_argument(
        "--results_path",
        default="outputs/cnn_baselines/exp_image_only/results.json")
    args = parser.parse_args(argv)

    with open(args.results_path) as f:
        results = json.load(f)
    cms = [np.array(fr["confusion_matrix"])
           for fr in results.get("fold_results", [])]
    print(format_report(compute_per_class_metrics(cms)))


if __name__ == "__main__":
    main()
