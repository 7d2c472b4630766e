"""Step 4: the VLM audit pipeline runner.

Port of ``emr2a_tpu/pipelines/step4_vlm_review/run.py`` with its flags and
artifacts: it reads the fold ``metrics.json`` files (``all_top_labels`` /
``all_top_scores`` / ``test_patient_ids``), samples up to ``max_samples``
cases with a seeded shuffle, takes the majority vote of the stored top
labels, maps decisions to error scores (reject -> confidence, accept -> 1 -
confidence, abstain -> 0.5) and writes ``vlm_audit_summary.json`` and
``vlm_audit_details.jsonl`` in the JAX package's format.

    python -m emr2a_tpu_torch.pipelines.step4_vlm_review.run \
        --exp_dir outputs/experiments/exp_x --manifest_path manifest.jsonl \
        --model_path /path/to/Qwen3-VL-8B --precision int4

``--device`` defaults to ``cuda``; ``--precision`` is bf16, int8, int4 or
int4_awq (int4 after ``models/awq.py``'s activation-aware fold, calibrated
on the judge's prompts on the card: the same K7 kernels and speed as int4,
less of RTN's error); ``--kv_cache int8`` keeps the judge's
KV cache in s8 with per-(position, head) scales and ``--prefill_chunk C``
runs the prompt through the decoder C tokens at a time (without it the
generator chunks only where the one-shot prefill's attention temps exceed
its budget). ``--vlm_batch_size N`` audits N cases per prefill and decode
(a static batch); ``--serving continuous`` streams every case through
continuous batching with ``--vlm_batch_size`` slots, refilling a slot as
soon as its case finishes. On the card each decode step replays a CUDA
graph. ``--draft_model D`` (a same-vocabulary Qwen3-VL checkpoint, quantized
at ``--precision``) turns on speculative decoding: one-case audits run
draft-k / verify-1 cycles (``models/speculative.py``), each replayed from a
CUDA graph on the card, and with ``--serving continuous`` every slot
advances speculatively; static ``--vlm_batch_size`` batches ignore the
draft, as JAX's do. ``--compile_cache`` (JAX's cache) is gone. ``--tp N``
serves the judge tensor-parallel over N of the visible cards' model axis
(a ``(cards // N, N)`` mesh; Megatron sharding of the target and the
draft, KV caches sharded on their kv heads; each case's greedy stream
equals ``--tp 1``'s or first differs at a near-tie of its logits, where the
bf16 row-parallel sums round differently; decode eager above one card),
and N must divide the card count.

    python -m emr2a_tpu_torch.pipelines.step4_vlm_review.run ... \
        --serving continuous --vlm_batch_size 8
    python -m emr2a_tpu_torch.pipelines.step4_vlm_review.run ... \
        --precision int4_awq --draft_model /path/to/Qwen3-VL-2B
"""

from __future__ import annotations

import argparse
import json
import logging
import random
from collections import Counter
from pathlib import Path
from typing import Dict, Optional

from emr2a_tpu_torch.data.manifest import load_manifest
from emr2a_tpu_torch.eval.audit_metrics import compute_audit_metrics
from emr2a_tpu_torch.judge.audit import VLMAuditModule
from emr2a_tpu_torch.judge.prompts import get_vlm_audit_prompt

logging.basicConfig(level=logging.INFO,
                    format="%(asctime)s - %(levelname)s - %(message)s")
logger = logging.getLogger(__name__)

REQUIRED_KEYS = ("all_top_labels", "all_top_scores", "test_patient_ids")


def load_retrieval_results_from_folds(exp_dir: Path,
                                      max_samples: int = 30) -> Dict:
    all_top_labels, all_top_scores = [], []
    all_top_patient_ids, test_patient_ids = [], []
    missing_detail_folds = []

    for fold_idx in range(1, 6):
        fold_path = exp_dir / f"fold_{fold_idx}" / "metrics.json"
        if not fold_path.exists():
            continue
        with fold_path.open(encoding="utf-8") as f:
            fold_data = json.load(f)
        missing = [k for k in REQUIRED_KEYS if k not in fold_data]
        if missing:
            missing_detail_folds.append({"path": str(fold_path),
                                         "missing_keys": missing})
            logger.warning("Skipping %s: missing keys %s", fold_path, missing)
            continue

        labels = fold_data.get("all_top_labels", [])
        scores = fold_data.get("all_top_scores", [])
        pids = fold_data.get("all_top_patient_ids", [])
        test_ids = fold_data.get("test_patient_ids", [])
        limit = min(len(labels), len(scores), len(test_ids), max_samples)
        for i in range(limit):
            all_top_labels.append(labels[i])
            all_top_scores.append(scores[i])
            # keep pid list index-aligned with the other lists even when
            # a fold lacks per-sample pids (placeholder [] -> the
            # neighbor_{j} fallback below)
            all_top_patient_ids.append(pids[i] if i < len(pids) else [])
            test_patient_ids.append(test_ids[i])

    return {
        "all_top_labels": all_top_labels,
        "all_top_scores": all_top_scores,
        "all_top_patient_ids": all_top_patient_ids,
        "test_patient_ids": test_patient_ids,
        "missing_detail_folds": missing_detail_folds,
    }


def run_vlm_audit_pipeline(exp_dir: Path, manifest_path: Path,
                           output_dir: Path, max_samples: int = 30,
                           model_path: str = None, device: str = "cuda",
                           seed: int = 42, accept_threshold: float = 0.7,
                           reject_threshold: float = 0.7,
                           abstain_threshold: float = 0.5,
                           conservative: bool = False,
                           backend=None, precision: str = "bf16",
                           kv_dtype: str = "bf16",
                           draft_model_path: Optional[str] = None,
                           vlm_batch_size: int = 1,
                           serving: str = "static",
                           vlm_max_new_tokens: int = 1024,
                           prefill_chunk: Optional[int] = None,
                           tp: int = 1) -> Dict:
    logger.info("Loading retrieval results from %s", exp_dir)
    retrieval_data = load_retrieval_results_from_folds(exp_dir, max_samples)

    if not retrieval_data.get("test_patient_ids"):
        missing = retrieval_data.get("missing_detail_folds", [])
        hint = ""
        alt_dir = Path(f"{exp_dir}_v2")
        if alt_dir.exists():
            hint = f" Try --exp_dir {alt_dir}."
        if missing:
            example = missing[0]
            raise ValueError(
                "No per-sample retrieval results found. "
                f"{example.get('path')} missing keys "
                f"{example.get('missing_keys', [])}.{hint}")
        raise ValueError(
            "No retrieval samples loaded from metrics.json. "
            "Check --exp_dir or re-run CV experiments to generate "
            "detailed metrics.")

    manifest = load_manifest(manifest_path)
    pid_to_record = {r.get("patient_id"): r for r in manifest}

    all_top_labels = retrieval_data["all_top_labels"]
    all_top_scores = retrieval_data["all_top_scores"]
    all_top_patient_ids = retrieval_data.get("all_top_patient_ids", [])
    test_patient_ids = retrieval_data["test_patient_ids"]

    total = min(len(test_patient_ids), len(all_top_labels), len(all_top_scores))
    indices = list(range(total))
    rng = random.Random(seed)
    rng.shuffle(indices)
    if max_samples is not None:
        indices = indices[:max_samples]
    logger.info("Sampling %d cases from %d (seed=%d)", len(indices), total, seed)

    retrieval_predictions, retrieval_similarities = [], []
    retrieval_labels, top_neighbors_list = [], []
    query_patients, sample_patient_ids = [], []

    for idx in indices:
        test_pid = test_patient_ids[idx]
        record = pid_to_record.get(test_pid)
        if record is None:
            # skip BEFORE appending anything: the per-sample lists must
            # stay index-aligned (the reference appends predictions
            # first and desynchronizes every later pairing,
            # step4/run.py:166-196 — deliberate fix)
            logger.warning("Patient %s not found in manifest", test_pid)
            continue
        top_labels = all_top_labels[idx]
        top_scores = all_top_scores[idx]
        retrieval_predictions.append(Counter(top_labels).most_common(1)[0][0])
        retrieval_similarities.append(top_scores)
        retrieval_labels.append(top_labels)

        if idx < len(all_top_patient_ids) and all_top_patient_ids[idx]:
            neighbors = [(pid, label, float(score)) for label, score, pid in
                         zip(top_labels, top_scores, all_top_patient_ids[idx])]
        else:
            neighbors = [(f"neighbor_{j}", label, float(score))
                         for j, (label, score) in
                         enumerate(zip(top_labels, top_scores))]
        top_neighbors_list.append(neighbors)
        query_patients.append(record)
        sample_patient_ids.append(test_pid)

    logger.info("Processing %d samples for VLM audit", len(query_patients))

    audit_module = VLMAuditModule(
        model_path=model_path, device=device, precision=precision,
        kv_dtype=kv_dtype, draft_model_path=draft_model_path,
        prefill_chunk=prefill_chunk, tp=tp,
        accept_threshold=accept_threshold, reject_threshold=reject_threshold,
        abstain_threshold=abstain_threshold, backend=backend)

    prompt_template = get_vlm_audit_prompt(conservative=conservative)

    audit_output_dir = Path(output_dir) / "vlm_audit"
    audit_output_dir.mkdir(parents=True, exist_ok=True)

    audit_results = audit_module.audit_batch(
        retrieval_predictions=retrieval_predictions,
        retrieval_similarities=retrieval_similarities,
        retrieval_labels=retrieval_labels,
        query_patients=query_patients,
        top_neighbors_list=top_neighbors_list,
        manifest=manifest, output_dir=audit_output_dir,
        base_dir=Path("."), prompt_template=prompt_template,
        vlm_batch_size=vlm_batch_size, serving=serving,
        max_new_tokens=vlm_max_new_tokens)

    ground_truth = [p.get("label") for p in query_patients]
    final_results = audit_module.compute_final_predictions(
        retrieval_predictions=retrieval_predictions,
        audit_results=audit_results["audit_results"],
        ground_truth=ground_truth)

    audit_decisions = [r["final_decision"] for r in audit_results["audit_results"]]
    audit_confidences = [r["vlm_confidence"] for r in audit_results["audit_results"]]
    audit_error_scores = []
    for decision, conf in zip(audit_decisions, audit_confidences):
        if decision == "reject":
            audit_error_scores.append(conf)
        elif decision == "accept":
            audit_error_scores.append(1.0 - conf)
        else:
            audit_error_scores.append(0.5)

    metrics = compute_audit_metrics(
        main_predictions=retrieval_predictions, ground_truth=ground_truth,
        audit_decisions=audit_decisions, audit_confidences=audit_confidences,
        audit_error_scores=audit_error_scores)

    results = {
        "sample_patient_ids": sample_patient_ids,
        "retrieval_predictions": retrieval_predictions,
        "ground_truth": ground_truth,
        "audit_results": audit_results["audit_results"],
        "audit_summary": {k: audit_results[k] for k in (
            "accept_count", "reject_count", "abstain_count",
            "accept_ratio", "reject_ratio", "abstain_ratio")},
        "final_predictions": final_results["final_predictions"],
        "needs_human_review": final_results["needs_human_review"],
        "coverage": final_results["coverage"],
        "human_review_ratio": final_results["human_review_ratio"],
        "metrics": metrics,
    }
    if "accuracy_on_accepted" in final_results:
        results["accuracy_on_accepted"] = final_results["accuracy_on_accepted"]
        results["n_accepted"] = final_results["n_accepted"]

    logger.info("=" * 60)
    logger.info("VLM Audit Results Summary")
    logger.info("Total Samples: %d", len(retrieval_predictions))
    logger.info("Accept: %d (%.1f%%)", audit_results["accept_count"],
                audit_results["accept_ratio"] * 100)
    logger.info("Reject: %d (%.1f%%)", audit_results["reject_count"],
                audit_results["reject_ratio"] * 100)
    logger.info("Abstain: %d (%.1f%%)", audit_results["abstain_count"],
                audit_results["abstain_ratio"] * 100)
    logger.info("Coverage (Auto): %.1f%%", final_results["coverage"] * 100)
    if "accuracy_on_accepted" in final_results:
        logger.info("Accuracy on Accepted: %.1f%%",
                    final_results["accuracy_on_accepted"] * 100)
    logger.info("AUROC (Error Detection): %.4f",
                metrics["error_detection"]["auroc"])
    logger.info("AURC: %.4f", metrics["selective_prediction"]["aurc"])
    logger.info("=" * 60)

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    with (output_dir / "vlm_audit_summary.json").open("w", encoding="utf-8") as f:
        json.dump(results, f, indent=2, ensure_ascii=False)
    logger.info("Audit summary saved to %s", output_dir / "vlm_audit_summary.json")

    with (output_dir / "vlm_audit_details.jsonl").open("w", encoding="utf-8") as f:
        for i, (pid, pred, gt, audit) in enumerate(zip(
                sample_patient_ids, retrieval_predictions, ground_truth,
                audit_results["audit_results"])):
            f.write(json.dumps({
                "patient_id": pid,
                "retrieval_prediction": pred,
                "ground_truth": gt,
                "retrieval_correct": pred == gt,
                "audit_decision": audit["final_decision"],
                "audit_confidence": audit["vlm_confidence"],
                "cited_neighbors": audit.get("cited_neighbors", []),
                "rationale": audit.get("rationale", ""),
                "needs_human_review": final_results["needs_human_review"][i],
            }, ensure_ascii=False) + "\n")
    logger.info("Detailed results saved to %s",
                output_dir / "vlm_audit_details.jsonl")
    return results


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Run VLM Audit Pipeline for Retrieval Results")
    parser.add_argument("--exp_dir", type=str,
                        default="outputs/experiments/example_exp")
    parser.add_argument("--manifest_path", type=str,
                        default="data/processed/manifest.jsonl")
    parser.add_argument("--output_dir", type=str, default="outputs/vlm_audit")
    parser.add_argument("--max_samples", type=int, default=30)
    parser.add_argument("--model_path", type=str, default=None)
    parser.add_argument("--precision", default="bf16",
                        choices=["bf16", "int8", "int4", "int4_awq"],
                        help="judge decoder precision: bf16; int8 (W8A8 "
                             "decoder projections); int4 (group-128 W4A8, "
                             "EXPERIMENTAL: 4-bit RTN carries a real "
                             "accuracy cost, validate on your cohort); "
                             "int4_awq (int4 plus activation-aware scale "
                             "folding calibrated on the judge's prompts, "
                             "models/awq.py: int4's kernels and speed, most "
                             "of RTN's error recovered)")
    parser.add_argument("--kv_cache", default="bf16", choices=["bf16", "int8"],
                        help="judge KV-cache precision; int8 keeps s8 "
                             "values with per-(position, head) scales folded "
                             "into the attention math")
    parser.add_argument("--prefill_chunk", type=int, default=None,
                        help="sequence-chunked prompt prefill (C tokens per "
                             "pass, the one-shot prefill's output); C must "
                             "divide the prompt bucket")
    parser.add_argument("--draft_model", default=None,
                        help="a small same-vocabulary draft checkpoint for "
                             "speculative decoding: one-case audits run "
                             "draft-k/verify-1 cycles (greedy: the judge's own "
                             "tokens) and with --serving continuous every slot "
                             "does; static --vlm_batch_size batches ignore it")
    parser.add_argument("--serving", default="static",
                        choices=["static", "continuous"],
                        help="batched audit scheduling: 'static' = fixed "
                             "batches of --vlm_batch_size cases through "
                             "generate_batch; 'continuous' = a slot server "
                             "(--vlm_batch_size slots) that refills a finished "
                             "slot between decode chunks, so mixed output "
                             "lengths don't wait on the slowest case")
    parser.add_argument("--vlm_max_new_tokens", type=int, default=1024,
                        help="judge generation budget per audit case")
    parser.add_argument("--vlm_batch_size", type=int, default=1,
                        help="audit cases served per prefill+decode (the "
                             "slot count with --serving continuous); decode "
                             "streams the weights once a step for every row")
    parser.add_argument("--tp", type=int, default=1,
                        help="serve the judge tensor-parallel over N "
                             "cards (Megatron param sharding + kv-head-"
                             "sharded caches; each token stream equals "
                             "tp=1's, or first differs at a near-tie of "
                             "its logits in bf16); N must divide the "
                             "visible cards")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--accept_threshold", type=float, default=0.7)
    parser.add_argument("--reject_threshold", type=float, default=0.7)
    parser.add_argument("--abstain_threshold", type=float, default=0.5)
    parser.add_argument("--conservative", action="store_true")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    config_path = Path(args.exp_dir) / "config.json"
    if config_path.exists():
        with config_path.open(encoding="utf-8") as f:
            logger.info("Experiment config: %s", json.load(f))
    else:
        logger.warning("Config file not found at %s", config_path)

    run_vlm_audit_pipeline(
        exp_dir=Path(args.exp_dir), manifest_path=Path(args.manifest_path),
        output_dir=Path(args.output_dir), max_samples=args.max_samples,
        model_path=args.model_path, device=args.device, seed=args.seed,
        precision=args.precision, kv_dtype=args.kv_cache,
        draft_model_path=args.draft_model,
        prefill_chunk=args.prefill_chunk, tp=args.tp,
        vlm_batch_size=args.vlm_batch_size, serving=args.serving,
        vlm_max_new_tokens=args.vlm_max_new_tokens,
        accept_threshold=args.accept_threshold,
        reject_threshold=args.reject_threshold,
        abstain_threshold=args.abstain_threshold,
        conservative=args.conservative)


if __name__ == "__main__":
    main()
