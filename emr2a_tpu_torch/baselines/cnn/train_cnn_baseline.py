"""CNN baseline: the trained classifier head to head with retrieval.

Port of ``emr2a_tpu/baselines/cnn/train_cnn_baseline.py``, with the
reference's behaviour: K = 4 uniform slice sampling with pad-repeat, the
grayscale -> 3-channel 224² 0.5-normalized transform, ImageOnly (ResNet18
+ slice mean + linear) and Multimodal (+ clinical MLP) models, Adam with
coupled L2 weight decay and best-epoch selection by validation accuracy,
a per-fold clinical StandardScaler fit on train, stratified k-fold, and
the same ``results.json`` keys.

The data helpers (``sample_k_slices``, ``encode_clinical``,
``load_patient_images``, ``ClinicalScaler``, ``build_dataset``) give JAX's
arrays byte for byte (``data/images.resize_to`` is JAX's code). The train
and eval steps run eagerly in PyTorch on ``--device`` (default ``cuda``;
the convolutions and BatchNorm are cuDNN's and plain torch ops: JAX runs no
Pallas kernel here either). ``torch.optim.Adam(lr, weight_decay=wd)`` adds
``wd * param`` to the gradient before the adaptive rescaling, which is
exactly JAX's ``optax.chain(add_decayed_weights(wd), adam(lr))``. The
models' random init differs from flax's (``models/resnet.py``); the
folds are the port's numpy copy of sklearn's ``StratifiedKFold``
(``eval/cv.stratified_kfold``) and the fold metrics numpy copies of
sklearn's macro ``precision_recall_fscore_support`` (zero_division 0) and
``confusion_matrix`` with the labels pinned.
"""

from __future__ import annotations

import argparse
import json
import logging
import random
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from emr2a_tpu_torch.data.images import load_image_rgb, resize_to
from emr2a_tpu_torch.data.manifest import load_manifest
from emr2a_tpu_torch.eval.metrics import (
    confusion_matrix_array,
    precision_recall_fscore_macro,
)
from emr2a_tpu_torch.models.resnet import ImageOnlyModel, MultimodalModel

logging.basicConfig(level=logging.INFO,
                    format="%(asctime)s - %(levelname)s - %(message)s")
logger = logging.getLogger(__name__)


def sample_k_slices(slices: List[str], k: int) -> List[str]:
    """K uniform-stride slices, last repeated to pad
    (train_cnn_baseline.py:64-72)."""
    if len(slices) >= k:
        step = len(slices) // k
        idx = list(range(0, len(slices), step))[:k]
    else:
        idx = list(range(len(slices)))
        while len(idx) < k:
            idx.append(idx[-1])
    return [slices[i] for i in idx]


def encode_clinical(meta: Dict) -> np.ndarray:
    """[sex==男, age, fever==有] features (train_cnn_baseline.py:83-91)."""
    sex = 1.0 if meta.get("sex") == "男" else 0.0
    age = float(meta.get("age", 0)) if meta.get("age") else 0.0
    fever = 1.0 if meta.get("fever") == "有" else 0.0
    return np.array([sex, age, fever], dtype=np.float32)


def load_patient_images(record: Dict, k_slices: int,
                        image_size: int = 224) -> Optional[np.ndarray]:
    """(K, H, W, 3) float array: grayscale → 3ch, resize, 0.5-normalize."""
    slices = record.get("slices", [])
    if not slices:
        return None
    imgs = []
    for path in sample_k_slices(slices, k_slices):
        arr = load_image_rgb(path)
        if arr is None:
            return None
        # grayscale conversion then back to 3 channels (the reference's
        # convert("L") + Grayscale(3) round trip).
        gray = (0.299 * arr[..., 0] + 0.587 * arr[..., 1]
                + 0.114 * arr[..., 2]).astype(np.uint8)
        arr = np.stack([gray] * 3, axis=-1)
        arr = resize_to(arr, image_size, shortest_edge=False, method="bilinear")
        imgs.append((arr.astype(np.float32) / 255.0 - 0.5) / 0.5)
    return np.stack(imgs)


class ClinicalScaler:
    """Per-fold StandardScaler on train clinical features."""

    def fit(self, rows: np.ndarray) -> "ClinicalScaler":
        self.mean = rows.mean(axis=0)
        std = rows.std(axis=0)
        self.scale = np.where(std == 0, 1.0, std)
        return self

    def transform(self, rows: np.ndarray) -> np.ndarray:
        return (rows - self.mean) / self.scale


def build_dataset(records: List[Dict], k_slices: int, label_to_idx: Dict,
                  scaler: Optional[ClinicalScaler],
                  image_size: int = 224) -> Dict[str, np.ndarray]:
    images, clinical, labels, pids = [], [], [], []
    for r in records:
        arr = load_patient_images(r, k_slices, image_size=image_size)
        if arr is None:
            continue
        images.append(arr)
        clinical.append(encode_clinical(r.get("meta", {})))
        labels.append(label_to_idx[r.get("label", "Normal")])
        pids.append(r.get("patient_id"))
    clinical_arr = np.stack(clinical) if clinical else np.zeros((0, 3), np.float32)
    if scaler is not None and len(clinical_arr):
        clinical_arr = scaler.transform(clinical_arr).astype(np.float32)
    return {
        "images": (np.stack(images) if images else
                   np.zeros((0, k_slices, image_size, image_size, 3),
                            np.float32)),
        "clinical": clinical_arr,
        "labels": np.asarray(labels, np.int32),
        "patient_ids": pids,
    }


def make_steps(model, optimizer, use_clinical: bool):
    """(train_step, eval_step) over ``model`` and its ``optimizer``, in
    place. Both take host arrays (or tensors) and move them to the model's
    device and dtype. ``train_step(images, clinical, labels) -> (loss, acc)``: the
    mean softmax cross-entropy, its gradient, the optimizer's update and
    the BatchNorm statistics' update (the model in train mode);
    ``eval_step(images, clinical, labels) -> (loss, predictions)`` in eval
    mode. Loss, accuracy and predictions stay on the device."""
    first = next(model.parameters())

    def inputs(images, clinical, labels):
        def put(a, dtype):
            return torch.as_tensor(a).to(device=first.device, dtype=dtype, non_blocking=True)
        return (put(images, first.dtype), put(clinical, first.dtype),
                put(labels, torch.int64))

    def apply(images, clinical):
        return model(images, clinical) if use_clinical else model(images)

    def train_step(images, clinical, labels):
        images, clinical, labels = inputs(images, clinical, labels)
        model.train()
        logits = apply(images, clinical)
        loss = F.cross_entropy(logits, labels)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        return loss.detach(), acc

    @torch.no_grad()
    def eval_step(images, clinical, labels):
        images, clinical, labels = inputs(images, clinical, labels)
        model.eval()
        logits = apply(images, clinical)
        return F.cross_entropy(logits, labels), logits.argmax(-1)

    return train_step, eval_step


def evaluate_fold(eval_step, data, batch_size: int, num_classes: int = 4):
    """(loss, accuracy %, macro precision, recall, F1, confusion matrix,
    predictions, labels) of ``eval_step`` over ``data`` in batches; JAX's
    takes the variables first, here the model behind ``eval_step`` holds
    them."""
    losses, preds, labels = [], [], []
    n = len(data["labels"])
    for i in range(0, n, batch_size):
        sl = slice(i, i + batch_size)
        loss, p = eval_step(data["images"][sl], data["clinical"][sl],
                            data["labels"][sl])
        losses.append(float(loss))
        preds.extend(p.cpu().tolist())
        labels.extend(data["labels"][sl].tolist())
    acc = 100.0 * float(np.mean(np.asarray(preds) == np.asarray(labels)))
    precision, recall, f1 = precision_recall_fscore_macro(labels, preds)
    # pin the label axes: a class absent from one fold's test set would
    # otherwise shrink the matrix and misalign it with compute_cnn_metrics'
    # fixed class order
    cm = confusion_matrix_array(labels, preds, list(range(num_classes)))
    return (float(np.mean(losses)), acc, precision, recall, f1, cm, preds, labels)


def build_model(model_type: str, num_classes: int, device, seed: int = 0,
                pretrained_backbone: Optional[Dict[str, torch.Tensor]] = None):
    """The fold's model on ``device``, random from ``seed``, its backbone
    replaced by ``pretrained_backbone`` (a ``ResNet18`` state dict) where
    given; the heads stay freshly initialized (the reference swaps fc the
    same way, train_cnn_baseline.py:137-141)."""
    cls = MultimodalModel if model_type == "multimodal" else ImageOnlyModel
    model = cls(num_classes=num_classes, seed=seed)
    if pretrained_backbone is not None:
        model.backbone.load_state_dict(pretrained_backbone)
    return model.to(device)


def run_fold(fold_idx, train_records, test_records, model_type, args,
             label_to_idx, scaler, rng_seed: int = 0,
             pretrained_backbone=None):
    logger.info("Training fold %d/%d (train=%d test=%d)", fold_idx + 1,
                args.cv_folds, len(train_records), len(test_records))
    use_clinical = model_type == "multimodal"
    train_data = build_dataset(train_records, args.k_slices, label_to_idx,
                               scaler if use_clinical else None,
                               image_size=args.image_size)
    test_data = build_dataset(test_records, args.k_slices, label_to_idx,
                              scaler if use_clinical else None,
                              image_size=args.image_size)

    num_classes = len(label_to_idx)
    model = build_model(model_type, num_classes, args.device, seed=rng_seed,
                        pretrained_backbone=pretrained_backbone)
    # torch.optim.Adam(weight_decay=...) couples L2 into the gradient before
    # the adaptive rescaling, as the reference (and JAX's chain) does
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr,
                                 weight_decay=args.weight_decay)
    train_step, eval_step = make_steps(model, optimizer, use_clinical)

    rng = np.random.RandomState(args.seed + fold_idx)
    n_train = len(train_data["labels"])
    best_val_acc = -1.0  # first epoch always records (0.0 val acc included)
    best_metrics = None

    for epoch in range(args.epochs):
        order = rng.permutation(n_train)
        ep_losses, ep_accs = [], []
        for i in range(0, n_train, args.batch_size):
            idx = order[i:i + args.batch_size]
            loss, acc = train_step(train_data["images"][idx],
                                   train_data["clinical"][idx],
                                   train_data["labels"][idx])
            ep_losses.append(float(loss))
            ep_accs.append(float(acc))

        val_loss, val_acc, val_prec, val_rec, val_f1, val_cm, _, _ = \
            evaluate_fold(eval_step, test_data, args.batch_size, num_classes)
        logger.info("Epoch %d/%d - Train Loss: %.4f, Acc: %.2f%% | "
                    "Val Loss: %.4f, Acc: %.2f%%, F1: %.4f",
                    epoch + 1, args.epochs, np.mean(ep_losses),
                    100 * np.mean(ep_accs), val_loss, val_acc, val_f1)
        if val_acc > best_val_acc:
            best_val_acc = val_acc
            best_metrics = {
                "loss": val_loss, "accuracy": val_acc,
                "precision": val_prec, "recall": val_rec, "f1": val_f1,
                "confusion_matrix": val_cm.tolist(),
            }
    return best_metrics


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train CNN baseline for direct prediction")
    parser.add_argument("--manifest_path", default="data/processed/manifest.jsonl")
    parser.add_argument("--output_dir", default="outputs/cnn_baselines")
    parser.add_argument("--model_type", default="image_only",
                        choices=["image_only", "multimodal"])
    parser.add_argument("--k_slices", type=int, default=4)
    parser.add_argument("--cv_folds", type=int, default=5)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--epochs", type=int, default=30)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--weight_decay", type=float, default=1e-5)
    parser.add_argument("--pretrained", action="store_true",
                        help="initialize the ResNet18 backbone from "
                             "--pretrained_path (a torchvision state dict)")
    parser.add_argument("--pretrained_path", default=None,
                        help="local torchvision resnet18 checkpoint "
                             "(.pth/.bin state dict)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--image_size", type=int, default=224)
    return parser


def main(argv=None) -> None:
    from emr2a_tpu_torch.eval.cv import stratified_kfold

    args = build_parser().parse_args(argv)
    pretrained_backbone = None
    if args.pretrained:
        # no network: the weights come from a local torch checkpoint file
        # (the reference downloads torchvision's ImageNet resnet18)
        if not args.pretrained_path:
            raise SystemExit(
                "--pretrained needs --pretrained_path pointing at a local "
                "torchvision resnet18 checkpoint (.pth state dict)")
        from emr2a_tpu_torch.models.convert import (
            convert_torch_resnet18,
            load_state_dict,
        )
        pretrained_backbone = convert_torch_resnet18(
            load_state_dict(args.pretrained_path))
        logger.info("Loaded pretrained ResNet18 backbone from %s",
                    args.pretrained_path)
    random.seed(args.seed)
    np.random.seed(args.seed)

    manifest = load_manifest(args.manifest_path)
    logger.info("Loaded %d patient records from manifest", len(manifest))

    labels = [r.get("label") for r in manifest]
    classes = sorted(set(labels))
    label_to_idx = {c: i for i, c in enumerate(classes)}
    logger.info("Classes: %s", classes)

    output_dir = Path(args.output_dir) / f"exp_{args.model_type}"
    output_dir.mkdir(parents=True, exist_ok=True)

    fold_results = []
    for fold_idx, (train_idx, test_idx) in enumerate(
            stratified_kfold(labels, args.cv_folds, args.seed)):
        train_records = [manifest[i] for i in train_idx]
        test_records = [manifest[i] for i in test_idx]

        scaler = ClinicalScaler().fit(np.stack(
            [encode_clinical(r.get("meta", {})) for r in train_records]))
        metrics = run_fold(fold_idx, train_records, test_records,
                           args.model_type, args, label_to_idx, scaler,
                           pretrained_backbone=pretrained_backbone)
        metrics["fold"] = fold_idx + 1
        fold_results.append(metrics)

    summary = {
        "model_type": args.model_type,
        "k_slices": args.k_slices,
        "cv_folds": args.cv_folds,
        "seed": args.seed,
        "fold_results": fold_results,
    }
    for name, key in [("accuracy", "accuracy"), ("precision", "precision"),
                      ("recall", "recall"), ("f1", "f1")]:
        vals = [m[key] for m in fold_results]
        summary[f"mean_{name}"] = float(np.mean(vals))
        summary[f"std_{name}"] = float(np.std(vals))
        if name == "accuracy":
            summary["min_accuracy"] = float(np.min(vals))
            summary["max_accuracy"] = float(np.max(vals))

    with (output_dir / "results.json").open("w") as f:
        json.dump(summary, f, indent=2)

    logger.info("=" * 80)
    logger.info("Summary Statistics (%d-fold CV)", args.cv_folds)
    logger.info("Accuracy:  %.2f%% ± %.2f%% (min: %.2f%%, max: %.2f%%)",
                summary["mean_accuracy"], summary["std_accuracy"],
                summary["min_accuracy"], summary["max_accuracy"])
    logger.info("F1:        %.4f ± %.4f", summary["mean_f1"], summary["std_f1"])
    logger.info("Results saved to: %s", output_dir / "results.json")


if __name__ == "__main__":
    main()
