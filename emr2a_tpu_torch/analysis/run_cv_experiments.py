"""The CV experiment runner, the main experiment CLI.

Port of ``emr2a_tpu/analysis/run_cv_experiments.py`` with the same flags
and behaviour: single experiments, the top-k / PCA / late-fusion-weight
scans, the text-shuffle sanity check, the four predefined experiment
configs, the ``combined_embeddings.npz`` cache ({patient_ids,
image_matrix, text_matrix}), clinical text rendered from the manifest's
meta, and per-patient slice sampling with mean pooling. The CV math runs
in ``eval/cv.py`` on ``--device`` (default ``cuda``; ``--device cpu`` asks
for the CPU). Encoders come from the port's factory, which raises for a
family not ported yet. ``--vlm_review`` runs the G2 goalkeeper review
(``judge/review.py``) on the first 30 CV test patients, each beside its own
neighbours, with the judge at ``--vlm_model_path`` on ``--device`` (``fake``
for canned answers), and writes ``vlm_review_summary.json`` beside the
folds.

    python -m emr2a_tpu_torch.analysis.run_cv_experiments \
        --experiment_id demo --skip_encoding \
        --embeddings_path outputs/features/combined_embeddings.npz
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from emr2a_tpu_torch.config import BaseConfig
from emr2a_tpu_torch.data.manifest import load_manifest
from emr2a_tpu_torch.encoders import create_encoder
from emr2a_tpu_torch.eval.cv import CVRetrievalEvaluator, make_serializable
from emr2a_tpu_torch.judge.review import VLMReviewModule
from emr2a_tpu_torch.ops.preprocess import sample_slice_indices

logger = logging.getLogger(__name__)

IMAGE_ENCODERS = ["qwen3_vl_8b", "qwen3_vl_2b", "clip", "vit", "biomedclip",
                  "dino", "fake"]
TEXT_ENCODERS = ["qwen3_vl_8b", "qwen3_vl_2b", "clip", "biomedclip", "fake"]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Run 5-fold CV experiments for medical image retrieval")
    parser.add_argument("--manifest_path", default="data/processed/manifest.jsonl")
    parser.add_argument("--output_dir", default="outputs/experiments")
    parser.add_argument("--image_encoder", default="biomedclip",
                        choices=IMAGE_ENCODERS)
    parser.add_argument("--text_encoder", default="qwen3_vl_8b",
                        choices=TEXT_ENCODERS)
    parser.add_argument("--fusion", default="concat",
                        choices=["concat", "image_only", "text_only", "late"])
    parser.add_argument("--pca_dim", type=int, default=96)
    parser.add_argument("--cv_folds", type=int, default=5)
    parser.add_argument("--top_k", type=int, default=3)
    parser.add_argument("--w_text", type=float, default=0.5)
    parser.add_argument("--topk_scan", action="store_true")
    parser.add_argument("--topk_list", type=int, nargs="+", default=[1, 3, 5, 10])
    parser.add_argument("--pca_scan", action="store_true")
    parser.add_argument("--pca_list", type=int, nargs="+", default=[64, 96, 128])
    parser.add_argument("--text_shuffle", action="store_true")
    parser.add_argument("--late_fusion_scan", action="store_true")
    parser.add_argument("--w_text_list", type=float, nargs="+",
                        default=[0.0, 0.25, 0.5, 0.75, 1.0])
    parser.add_argument("--vlm_review", action="store_true")
    parser.add_argument("--vlm_model_path", type=str, default=None)
    parser.add_argument("--vlm_prompt", type=str, default=None)
    parser.add_argument("--experiment_id", type=str, default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--sample_n_per_patient", type=int, default=4)
    parser.add_argument("--sampling_strategy", default="uniform",
                        choices=["uniform", "random"])
    parser.add_argument("--fast", nargs="?", const="bf16", default=None,
                        choices=["bf16", "int8"],
                        help="image tower on the hand-written kernels "
                             "(biomedclip): same semantics as step2 --fast")
    parser.add_argument("--skip_encoding", action="store_true")
    parser.add_argument("--embeddings_path", default=None)
    return parser


def render_clinical_text(record: Dict) -> str:
    """Chinese clinical text from the manifest's meta (sex, age, fever,
    symptom), else the record's ``text``."""
    meta = record.get("meta", {})

    def get(*keys):
        # english keys are canonical (step1 normalizes); zh aliases
        # accepted for externally-produced manifests
        for k in keys:
            if meta.get(k):
                return meta[k]
        return None

    parts = []
    if get("sex", "性别"):
        parts.append(f"性别: {get('sex', '性别')}")
    if get("age", "年龄"):
        parts.append(f"年龄: {get('age', '年龄')}")
    if get("fever", "发热", "发烧"):
        parts.append(f"发烧: {get('fever', '发热', '发烧')}")
    if get("symptom", "症状"):
        parts.append(f"症状: {get('symptom', '症状')}")
    return "\n".join(parts) if parts else record.get("text", "")


def load_or_encode_embeddings(
        manifest: List[Dict], config: BaseConfig, image_encoder_type: str,
        text_encoder_type: str, device: str, batch_size: int,
        sample_n_per_patient: Optional[int] = None,
        sampling_strategy: str = "uniform", skip_encoding: bool = False,
        embeddings_path: Optional[str] = None,
        fusion: str = "concat", fast=None) -> Dict[str, Dict[str, np.ndarray]]:
    embeddings_dir = Path(config.features_dir)

    if skip_encoding and embeddings_path:
        logger.info("Loading pre-computed embeddings from %s", embeddings_path)
        data = np.load(embeddings_path, allow_pickle=True)
        # each key read once: an NpzFile decompresses the whole array on
        # every access, which made this loop quadratic in the patients
        image = data["image_matrix"] if "image_matrix" in data else None
        text = data["text_matrix"] if "text_matrix" in data else None
        return {str(pid): {"image": None if image is None else image[i],
                           "text": None if text is None else text[i]}
                for i, pid in enumerate(data["patient_ids"])}

    image_embeddings: Dict[str, np.ndarray] = {}
    text_embeddings: Dict[str, np.ndarray] = {}

    if fusion != "text_only":
        logger.info("Encoding images with %s...", image_encoder_type)
        enc_kwargs = {"fast": fast} if fast else {}
        image_encoder = create_encoder(image_encoder_type, device=device,
                                       **enc_kwargs)
        for record in manifest:
            pid = record.get("patient_id")
            slices = record.get("slices", [])
            if not slices or not pid:
                continue
            try:
                if sample_n_per_patient is not None:
                    idx = sample_slice_indices(len(slices), sample_n_per_patient,
                                               mode=sampling_strategy)
                    slices = [slices[i] for i in idx]
                chunks = []
                for i in range(0, len(slices), batch_size):
                    emb = image_encoder.encode_images(
                        [Path(s) for s in slices[i:i + batch_size]])
                    if isinstance(emb, np.ndarray) and emb.ndim == 2 and emb.size:
                        chunks.append(emb)
                if chunks:
                    image_embeddings[pid] = np.concatenate(chunks, axis=0) \
                        .mean(axis=0).astype(np.float32)
            except Exception as e:
                logger.warning("Failed to encode images for patient %s: %s", pid, e)
        logger.info("Encoded images for %d patients", len(image_embeddings))

    if fusion != "image_only":
        logger.info("Encoding texts with %s...", text_encoder_type)
        text_encoder = create_encoder(text_encoder_type, device=device)
        for record in manifest:
            pid = record.get("patient_id")
            if not pid:
                continue
            text = render_clinical_text(record)
            if not text:
                continue
            try:
                emb = text_encoder.encode_text(text)
                if emb is not None:
                    text_embeddings[pid] = np.asarray(emb, dtype=np.float32)
            except Exception as e:
                logger.warning("Failed to encode text for patient %s: %s", pid, e)
        logger.info("Encoded texts for %d patients", len(text_embeddings))

    embeddings: Dict[str, Dict[str, np.ndarray]] = {}
    if fusion in ("concat", "late"):
        for pid in image_embeddings:
            if pid in text_embeddings:
                embeddings[pid] = {"image": image_embeddings[pid],
                                   "text": text_embeddings[pid]}
    elif fusion == "image_only":
        embeddings = {pid: {"image": e, "text": None}
                      for pid, e in image_embeddings.items()}
    elif fusion == "text_only":
        embeddings = {pid: {"image": None, "text": e}
                      for pid, e in text_embeddings.items()}
    logger.info("Combined embeddings for %d patients (fusion=%s)",
                len(embeddings), fusion)

    # cache as combined_embeddings.npz (the JAX package's keys)
    embeddings_dir.mkdir(parents=True, exist_ok=True)
    pids = list(embeddings.keys())
    save: Dict[str, np.ndarray] = {"patient_ids": np.array(pids, dtype=object)}
    img_dims = [v["image"].shape[-1] for v in embeddings.values()
                if v["image"] is not None]
    txt_dims = [v["text"].shape[-1] for v in embeddings.values()
                if v["text"] is not None]
    if img_dims:
        mat = np.zeros((len(pids), img_dims[-1]), np.float32)
        for i, pid in enumerate(pids):
            if embeddings[pid]["image"] is not None:
                mat[i] = embeddings[pid]["image"]
        save["image_matrix"] = mat
    if txt_dims:
        mat = np.zeros((len(pids), txt_dims[-1]), np.float32)
        for i, pid in enumerate(pids):
            if embeddings[pid]["text"] is not None:
                mat[i] = embeddings[pid]["text"]
        save["text_matrix"] = mat
    np.savez_compressed(embeddings_dir / "combined_embeddings.npz", **save)
    logger.info("Saved combined embeddings to %s",
                embeddings_dir / "combined_embeddings.npz")
    return embeddings


def aggregate_embeddings(embeddings: Dict[str, Dict[str, np.ndarray]]
                         ) -> Dict[str, Dict[str, np.ndarray]]:
    """Per-patient mean over the slice axis for 2-D/3-D image matrices."""
    out = {}
    for pid, data in embeddings.items():
        img = data["image"]
        if img is not None and img.ndim in (2, 3):
            img = img.mean(axis=0)
        out[pid] = {"image": img, "text": data["text"]}
    return out


def run_experiment(args, config: BaseConfig, experiment_id: str,
                   shuffle_text: bool = False,
                   enable_vlm_review: bool = False) -> Dict:
    logger.info("Running experiment: %s", experiment_id)
    manifest = load_manifest(args.manifest_path)
    logger.info("Loaded %d records from manifest", len(manifest))

    embeddings = load_or_encode_embeddings(
        manifest=manifest, config=config,
        image_encoder_type=args.image_encoder,
        text_encoder_type=args.text_encoder, device=args.device,
        batch_size=args.batch_size,
        sample_n_per_patient=args.sample_n_per_patient,
        sampling_strategy=args.sampling_strategy,
        skip_encoding=args.skip_encoding,
        embeddings_path=args.embeddings_path, fusion=args.fusion,
        fast="int8" if args.fast == "int8" else bool(args.fast) or None)

    if shuffle_text:
        logger.info("Shuffling text embeddings across patients (sanity check)")
        pids = list(embeddings.keys())
        texts = [embeddings[p]["text"] for p in pids]
        np.random.shuffle(texts)
        for pid, t in zip(pids, texts):
            embeddings[pid]["text"] = t

    embeddings = aggregate_embeddings(embeddings)

    patient_ids = list(embeddings.keys())
    pid_to_label = {r.get("patient_id"): r.get("label", "unknown")
                    for r in manifest}
    labels = [pid_to_label.get(pid, "unknown") for pid in patient_ids]

    logger.info("Patient count: %d", len(patient_ids))

    evaluator = CVRetrievalEvaluator(cv_folds=args.cv_folds,
                                     pca_dim=args.pca_dim,
                                     top_k=args.top_k, seed=config.seed,
                                     device=args.device)
    results = evaluator.run_cv(
        patient_ids=patient_ids, labels=labels, embeddings=embeddings,
        fusion=args.fusion, top_k_list=[1, 3, 5, args.top_k],
        w_text=args.w_text)

    vlm_review_results = None
    if enable_vlm_review:
        vlm_review_results = _run_vlm_review(args, experiment_id, manifest,
                                             patient_ids, results)

    config_dict = {
        "experiment_id": experiment_id,
        "image_encoder": args.image_encoder,
        "text_encoder": args.text_encoder,
        "fusion": args.fusion,
        "pca_dim": args.pca_dim,
        "top_k": args.top_k,
        "w_text": args.w_text if args.fusion == "late" else None,
        "cv_folds": args.cv_folds,
        "seed": config.seed,
        "device": args.device,
        "num_patients": len(patient_ids),
        "label_distribution": {
            str(label): int(count)
            for label, count in zip(*np.unique(labels, return_counts=True))},
        "text_shuffle": shuffle_text,
        "vlm_review": enable_vlm_review,
    }
    if vlm_review_results:
        results["vlm_review"] = vlm_review_results

    evaluator.save_results(results, Path(args.output_dir), experiment_id,
                           config_dict)
    logger.info("Experiment %s completed", experiment_id)
    logger.info("Summary: Top1=%.4f±%.4f, Vote Acc=%.4f±%.4f",
                results["summary"]["top1"]["mean"],
                results["summary"]["top1"]["std"],
                results["summary"]["vote_acc"]["mean"],
                results["summary"]["vote_acc"]["std"])
    return results


def _run_vlm_review(args, experiment_id, manifest, patient_ids, results,
                    max_vlm_samples: int = 30, backend=None):
    """The G2 goalkeeper review over the first ``max_vlm_samples`` CV test
    patients, each paired with its own fold's predictions and its real
    neighbour ids (``all_top_patient_ids``). ``backend`` (a ``VLMBackend``)
    takes the place of loading ``--vlm_model_path``."""
    from collections import Counter

    vlm_module = VLMReviewModule(model_path=args.vlm_model_path,
                                 device=args.device, backend=backend)
    vlm_output_dir = Path(args.output_dir) / f"exp_{experiment_id}" / "vlm_review"
    pid_to_record = {r.get("patient_id"): r for r in manifest}

    retrieval_predictions, retrieval_similarities = [], []
    retrieval_labels, top_neighbors_list, query_patients = [], [], []
    for fold_result in results["fold_results"]:
        all_top_labels = fold_result.get("all_top_labels", [])
        all_top_scores = fold_result.get("all_top_scores", [])
        top_pids = fold_result.get("all_top_patient_ids", [])
        for i, test_pid in enumerate(fold_result.get("test_patient_ids", [])):
            if len(query_patients) >= max_vlm_samples:
                break
            record = pid_to_record.get(test_pid)
            if i >= len(all_top_labels) or record is None:
                continue
            top_labels, top_scores = all_top_labels[i], all_top_scores[i]
            retrieval_predictions.append(Counter(top_labels).most_common(1)[0][0])
            retrieval_similarities.append(top_scores)
            retrieval_labels.append(top_labels)
            pids_i = (top_pids[i] if i < len(top_pids)
                      else [f"neighbor_{j}" for j in range(len(top_labels))])
            top_neighbors_list.append(
                [(pid, label, float(score))
                 for pid, (label, score) in zip(pids_i, zip(top_labels, top_scores))])
            query_patients.append(record)
        if len(query_patients) >= max_vlm_samples:
            break

    logger.info("Processing %d samples for VLM review", len(query_patients))
    return vlm_module.g2_goalkeeper_review(
        retrieval_predictions=retrieval_predictions,
        retrieval_similarities=retrieval_similarities,
        retrieval_labels=retrieval_labels,
        query_patients=query_patients,
        top_neighbors_list=top_neighbors_list,
        manifest=manifest,
        output_dir=vlm_output_dir,
        prompt_template=args.vlm_prompt)


def run_experiments(args, config: BaseConfig) -> None:
    """The four predefined experiment configs."""
    experiment_configs = [
        {"id": "exp_a_baseline", "fusion": "concat",
         "image_encoder": "biomedclip", "text_encoder": "qwen3_vl_8b"},
        {"id": "exp_b_image_encoders", "fusion": "concat",
         "image_encoder": "biomedclip", "text_encoder": "qwen3_vl_8b"},
        {"id": "exp_c_fusion_strategies", "fusion": "image_only",
         "image_encoder": "biomedclip", "text_encoder": "qwen3_vl_8b"},
        {"id": "exp_d_pca_dimensions", "fusion": "concat",
         "image_encoder": "biomedclip", "text_encoder": "qwen3_vl_8b"},
    ]
    all_results = {}
    for exp in experiment_configs:
        original = vars(args).copy()
        args.image_encoder = exp["image_encoder"]
        args.text_encoder = exp["text_encoder"]
        args.fusion = exp["fusion"]
        if exp["id"] == "exp_d_pca_dimensions":
            for dim in [64, 96, 128]:
                args.pca_dim = dim
                exp_id = f"{exp['id']}_dim{dim}"
                all_results[exp_id] = run_experiment(args, config, exp_id)
        else:
            all_results[exp["id"]] = run_experiment(args, config, exp["id"])
        vars(args).update(original)

    summary_path = Path(args.output_dir) / "all_experiments_summary.json"
    with summary_path.open("w", encoding="utf-8") as f:
        json.dump(make_serializable(all_results), f, ensure_ascii=False, indent=2)
    logger.info("All experiments summary saved to %s", summary_path)


def _scan(args, config, values, attr, tag) -> None:
    all_results = {}
    for v in values:
        setattr(args, attr, v)
        if attr == "w_text":
            exp_id = f"{args.experiment_id}_w{v:.2f}"
        else:
            exp_id = f"{args.experiment_id}_{tag}{v}"
        all_results[exp_id] = run_experiment(args, config, exp_id)
        # top_k/pca_dim/w_text only change the CV math, not the
        # embeddings: later scan values reuse the cache the first run
        # just wrote instead of re-running the whole encoder pass per
        # value
        cache = Path(config.features_dir) / "combined_embeddings.npz"
        if not args.skip_encoding and cache.exists():
            args.skip_encoding = True
            args.embeddings_path = str(cache)
    suffix = {"w_text": "late_fusion", "top_k": "topk_scan",
              "pca_dim": "pca_scan"}[attr]
    summary_path = Path(args.output_dir) / f"{args.experiment_id}_{suffix}_summary.json"
    with summary_path.open("w", encoding="utf-8") as f:
        json.dump(make_serializable(all_results), f, ensure_ascii=False, indent=2)
    logger.info("Scan summary saved to %s", summary_path)


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    args = build_parser().parse_args(argv)
    config = BaseConfig()

    if not args.experiment_id:
        run_experiments(args, config)
        return

    if args.late_fusion_scan:
        _scan(args, config, args.w_text_list, "w_text", "w")
    elif args.topk_scan:
        _scan(args, config, args.topk_list, "top_k", "topk")
    elif args.pca_scan:
        _scan(args, config, args.pca_list, "pca_dim", "pca")
    elif args.text_shuffle:
        results_original = run_experiment(
            args, config, f"{args.experiment_id}_original")
        results_shuffled = run_experiment(
            args, config, f"{args.experiment_id}_shuffled", shuffle_text=True)
        summary_path = (Path(args.output_dir)
                        / f"{args.experiment_id}_text_shuffle_summary.json")
        with summary_path.open("w", encoding="utf-8") as f:
            json.dump(make_serializable({
                "original": results_original,
                "shuffled": results_shuffled,
            }), f, ensure_ascii=False, indent=2)
        logger.info("Text shuffle summary saved to %s", summary_path)
    elif args.vlm_review:
        run_experiment(args, config, args.experiment_id,
                       enable_vlm_review=True)
    else:
        run_experiment(args, config, args.experiment_id)


if __name__ == "__main__":
    main()
