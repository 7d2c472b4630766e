"""VLM direct-judging baseline: diagnosis without retrieval.

Port of ``emr2a_tpu/baselines/vlm_direct/run_vlm_direct_judging.py``, with
the reference's behaviour: the strict-JSON 4-class prompt (its prompt and
system strings byte-identical) over 4 even slices and the clinical text,
the thinking-robust parser family with the valid-label filter and the 0.6
extracted-confidence fallback, two protocols (one run over the whole
cohort, or one fold's test patients from an experiment directory),
multi-temperature runs with inter-run agreement, and the same
``vlm_direct_judging_results.json`` / ``summary.json``, which equal JAX's
byte for byte on the same backend outputs. Generation runs through the
port's judge backends (``judge/backends.load_backend``); on the Qwen3-VL
judge its 4 slices run K8 in the vision tower and, in int4, K7 on every
decoder projection.

Divergences:
- JAX's ``predict`` catches every exception and ``predict_grid`` turns a
  failed ``generate_stream`` into empty results, so a failed kernel
  launch would read as "Failed to predict". Here a patient abstains only
  as JAX's does on its slices (``build_request`` returns None: one of
  them is undecodable, or all are missing; a missing slice is skipped) or
  when its answer cannot be parsed; a failed ``generate`` or
  ``generate_stream`` raises. This is the rule of ``judge/review.py``.
- sklearn's metrics are numpy copies (``accuracy_score``, macro and
  per-class ``precision_recall_fscore_support`` at zero_division 0,
  ``confusion_matrix`` over ``VALID_LABELS``), equal to sklearn's numbers.
- ``--compile_cache`` (JAX's compilation cache) is dropped; ``--device``
  defaults to ``cuda``.
"""

from __future__ import annotations

import argparse
import json
import logging
import random
import re
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from emr2a_tpu_torch.data.manifest import load_manifest
from emr2a_tpu_torch.eval.metrics import (
    confusion_matrix_array,
    precision_recall_fscore,
    precision_recall_fscore_macro,
)
from emr2a_tpu_torch.judge.audit import select_even_slices
from emr2a_tpu_torch.judge.backends import VLMBackend, load_backend
from emr2a_tpu_torch.judge.parsers import extract_json_payload, strip_thinking

logging.basicConfig(level=logging.INFO,
                    format="%(asctime)s - %(levelname)s - %(message)s")
logger = logging.getLogger(__name__)

VALID_LABELS = ["PJP", "Bacterial", "Viral", "Normal"]

VLM_DIRECT_JUDGING_PROMPT = """You are a chest-CT diagnostic AI for 4-class \
pneumonia subtyping.

## Patient Information
{patient_info}

## Task
From the 4 chest CT slices, pick exactly one diagnosis: PJP, Bacterial, \
Viral, or Normal.

## Output (STRICT JSON, nothing else)
{{
  "pred_label": "<PJP|Bacterial|Viral|Normal>",
  "confidence": <0.0-1.0>,
  "rationale": "<one short sentence>"
}}

Rules: no reasoning text, no markdown fences, only the JSON object.

JSON:"""

VLM_DIRECT_JUDGING_SYSTEM = """You are a chest-CT diagnostic AI. Output ONLY \
valid JSON with keys "pred_label", "confidence", "rationale" — no thinking, \
no analysis."""


class VLMDirectJudgingBaseline:

    def __init__(self, model_path: Optional[str] = None, device: str = "cuda",
                 backend: Optional[VLMBackend] = None):
        self.model_path = model_path
        self.device = device
        self.backend = backend if backend is not None \
            else load_backend(model_path, device)

    @staticmethod
    def _format_patient_info(patient: Dict) -> str:
        meta = patient.get("meta", {})
        parts = []
        if meta.get("sex"):
            parts.append(f"- Sex: {meta['sex']}")
        if meta.get("age"):
            parts.append(f"- Age: {meta['age']}")
        if meta.get("fever"):
            parts.append(f"- Fever: {meta['fever']}")
        if meta.get("symptom"):
            parts.append(f"- Symptoms: {meta['symptom']}")
        return "\n".join(parts) if parts else "No clinical information available"

    def _parse_vlm_output(self, output_text: str) -> Optional[Dict]:
        text = output_text.strip()
        after = strip_thinking(text)
        if after is not None:
            payload = extract_json_payload(after)
            if payload:
                result = self._validate_and_format_result(payload, text)
                if result:
                    return result
        payload = extract_json_payload(text)
        if payload:
            result = self._validate_and_format_result(payload, text)
            if result:
                return result
        return self._parse_thinking_output(text)

    def _validate_and_format_result(self, result: Dict,
                                    raw_output: str) -> Optional[Dict]:
        pred_label = result.get("pred_label", "")
        if pred_label not in VALID_LABELS:
            logger.warning("Invalid label: %s", pred_label)
            return None
        try:
            confidence = float(result.get("confidence", 0.0))
            if not 0.0 <= confidence <= 1.0:
                confidence = 0.5
        except (ValueError, TypeError):
            confidence = 0.5
        return {"pred_label": pred_label, "confidence": confidence,
                "rationale": result.get("rationale", ""),
                "raw_output": raw_output}

    def _parse_thinking_output(self, text: str) -> Optional[Dict]:
        """Mine 'diagnosis is X' phrases out of thinking prose; fixed
        0.6 confidence for extracted predictions (:273-311)."""
        lower = text.lower()
        for label in VALID_LABELS:
            ll = label.lower()
            patterns = [
                rf"diagnosis\s*(?:is|would be|should be|appears to be)\s*[\"']?{ll}",
                rf"most likely\s*[\"']?{ll}",
                rf"(?:suggests?|indicates?)\s*[\"']?{ll}",
                rf"consistent with\s*[\"']?{ll}",
            ]
            if any(re.search(p, lower) for p in patterns):
                return {"pred_label": label, "confidence": 0.6,
                        "rationale": "Extracted from thinking process",
                        "raw_output": text}
        return None

    def build_request(self, patient: Dict, temperature: float = 0.0,
                      prompt_template: Optional[str] = None,
                      system_message: Optional[str] = None,
                      seed: Optional[int] = None) -> Optional[Dict]:
        """Prompt + loaded slice images for one patient, as a request
        dict the backend's generate/generate_batch/generate_stream all
        accept.  None when no slice image exists (skip-and-continue,
        reference :153-158) or one cannot be decoded (JAX's ``predict``
        abstains on that patient); a missing slice is skipped."""
        prompt_template = prompt_template or VLM_DIRECT_JUDGING_PROMPT
        system_message = system_message or VLM_DIRECT_JUDGING_SYSTEM
        prompt = prompt_template.format(
            patient_info=self._format_patient_info(patient))
        images = []
        for path in select_even_slices(patient.get("slices", []), 4):
            p = Path(path)
            if not p.exists():
                logger.warning("Image not found: %s", path)
                continue
            try:
                with Image.open(p) as img:
                    images.append(img.convert("RGB"))
            except OSError as e:
                logger.error("Unreadable image %s for %s: %s", path,
                             patient.get("patient_id"), e)
                return None
        if not images:
            logger.error("No valid images found for %s",
                         patient.get("patient_id"))
            return None
        req = {"images": images, "prompt": prompt, "system": system_message,
               "temperature": float(temperature)}
        if seed is not None:
            req["seed"] = int(seed)
        return req

    def _finish(self, output_text: str, patient: Dict,
                temperature: float) -> Optional[Dict]:
        result = self._parse_vlm_output(output_text)
        if result:
            result["patient_id"] = patient.get("patient_id")
            result["true_label"] = patient.get("label")
            result["temperature"] = temperature
        return result

    def predict(self, patient: Dict, temperature: float = 0.0,
                prompt_template: Optional[str] = None,
                system_message: Optional[str] = None) -> Optional[Dict]:
        if self.backend is None:
            logger.warning("VLM backend not loaded, returning None")
            return None
        req = self.build_request(patient, temperature, prompt_template,
                                 system_message)
        if req is None:
            return None
        output_text = self.backend.generate(
            req["images"], req["prompt"], system=req["system"],
            max_new_tokens=2048, temperature=temperature)
        return self._finish(output_text, patient, temperature)

    def predict_grid(self, patients: List[Dict],
                     temperatures: List[float],
                     prompt_template: Optional[str] = None,
                     system_message: Optional[str] = None,
                     n_slots: int = 8,
                     seed_base: int = 42) -> Dict[float, List[Dict]]:
        """Serve the full (temperature x patient) grid as ONE
        continuous mixed-sampling stream.

        The reference's multi-temperature agreement protocol
        (run_vlm_direct_judging.py:482-527) re-runs the whole cohort
        once per temperature, each query paying the full decoder weight
        stream alone.  With per-slot sampling in the ContinuousBatcher
        (models/serving.py), greedy and sampled requests share decode
        chunks, so the grid streams through ``n_slots`` slots in one
        pass.  Sampled requests get deterministic per-request seeds
        derived from ``seed_base`` and their grid position.  Falls back
        to sequential ``predict`` for backends without
        ``generate_stream``. A patient without a readable slice is
        skipped; a failed ``generate_stream`` raises.
        """
        if self.backend is None or not hasattr(self.backend,
                                               "generate_stream"):
            return {t: [r for p in patients
                        for r in [self.predict(p, t, prompt_template,
                                               system_message)] if r]
                    for t in temperatures}
        entries = []  # (temperature, patient, request)
        for ti, temp in enumerate(temperatures):
            for pi, patient in enumerate(patients):
                req = self.build_request(
                    patient, temp, prompt_template, system_message,
                    seed=seed_base + ti * len(patients) + pi)
                if req is not None:
                    entries.append((temp, patient, req))
        outputs = self.backend.generate_stream(
            [e[2] for e in entries], max_new_tokens=2048, n_slots=n_slots)
        results: Dict[float, List[Dict]] = {t: [] for t in temperatures}
        for (temp, patient, _), text in zip(entries, outputs):
            result = self._finish(text, patient, temp)
            if result:
                results[temp].append(result)
            else:
                logger.warning("  %s: Failed to predict",
                               patient.get("patient_id"))
        return results


def load_fold_splits_from_experiments(experiment_dir: Path) -> Dict:
    splits = {}
    for fold_num in range(1, 6):
        metrics_file = experiment_dir / f"fold_{fold_num}" / "metrics.json"
        if metrics_file.exists():
            with metrics_file.open(encoding="utf-8") as f:
                metrics = json.load(f)
            splits[f"fold_{fold_num - 1}"] = {
                "test": metrics.get("test_patient_ids", [])}
    return splits


def sample_test_cases(test_patient_ids: List[str], manifest: List[Dict],
                      n_samples: int = 0, random_seed: int = 42) -> List[Dict]:
    if n_samples <= 0:
        ids = set(test_patient_ids)
        return [r for r in manifest if r.get("patient_id") in ids]
    random.seed(random_seed)
    sampled = set(random.sample(test_patient_ids,
                                min(n_samples, len(test_patient_ids))))
    return [r for r in manifest if r.get("patient_id") in sampled]


def evaluate_predictions(predictions: List[Dict]) -> Dict:
    """sklearn's accuracy, macro precision / recall / F1 (over the labels
    that occur), per-class metrics and confusion matrix over
    ``VALID_LABELS``, as numpy copies."""
    if not predictions:
        return {}
    y_true = [p["true_label"] for p in predictions if p.get("pred_label")]
    y_pred = [p["pred_label"] for p in predictions if p.get("pred_label")]
    if not y_true:
        return {}
    t, p = np.asarray(y_true), np.asarray(y_pred)
    accuracy = float(np.mean(t == p))
    precision, recall, f1 = precision_recall_fscore_macro(t, p)
    pc_p, pc_r, pc_f, pc_s = precision_recall_fscore(t, p, VALID_LABELS)
    cm = confusion_matrix_array(y_true, y_pred, VALID_LABELS)
    return {
        "accuracy": float(accuracy),
        "macro_precision": float(precision),
        "macro_recall": float(recall),
        "macro_f1": float(f1),
        "per_class": {
            label: {"precision": float(p), "recall": float(r),
                    "f1": float(f), "support": int(s)}
            for label, p, r, f, s in zip(VALID_LABELS, pc_p, pc_r, pc_f, pc_s)},
        "confusion_matrix": cm.tolist(),
        "num_samples": len(y_true),
    }


def calculate_agreement(predictions_list: List[List[Dict]]) -> Dict:
    if not predictions_list or len(predictions_list) < 2:
        return {}
    # Align runs by patient_id, not list index: failed predictions are
    # dropped per run, so positional pairing compares different
    # patients (reference bug, run_vlm_direct_judging.py:498-516 —
    # deliberate fix).
    by_pid = [
        {p["patient_id"]: p for p in run if p.get("pred_label")}
        for run in predictions_list]
    pids = [pid for pid in by_pid[0] ]
    if not pids:
        return {}
    total_agreements = total_comparisons = 0
    per_sample = []
    for pid in pids:
        entries = [run[pid] for run in by_pid if pid in run]
        preds = [e["pred_label"] for e in entries]
        if len(preds) < 2:
            continue
        most_common = Counter(preds).most_common(1)[0][0]
        agree = sum(1 for p in preds if p == most_common)
        per_sample.append({
            "patient_id": pid,
            "true_label": entries[0].get("true_label"),
            "predictions": preds,
            "agreement_rate": float(agree / len(preds)),
            "most_common": most_common,
        })
        total_agreements += agree
        total_comparisons += len(preds)
    return {
        "overall_agreement": (total_agreements / total_comparisons
                              if total_comparisons else 0.0),
        "mean_agreement": (float(np.mean([s["agreement_rate"]
                                          for s in per_sample]))
                           if per_sample else 0.0),
        "n_runs": len(predictions_list),
        "n_samples": len(per_sample),
        "per_sample_details": per_sample,
    }


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="VLM Direct Judging Baseline")
    parser.add_argument("--manifest", type=str,
                        default="data/processed/manifest.jsonl")
    parser.add_argument("--experiment_dir", type=str, default=None)
    parser.add_argument("--output_dir", type=str,
                        default="outputs/vlm_direct_judging")
    parser.add_argument("--n_samples_per_fold", type=int, default=0)
    parser.add_argument("--random_seed", type=int, default=42)
    parser.add_argument("--temperatures", type=float, nargs="+", default=[0.0])
    parser.add_argument("--model_path", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--fold", type=int, default=None)
    parser.add_argument("--serving", default="sequential",
                        choices=["sequential", "continuous"],
                        help="'continuous' streams the whole "
                             "(temperature x patient) grid through "
                             "slot-based continuous batching in one "
                             "pass (mixed greedy + sampled slots); "
                             "'sequential' queries one case at a time "
                             "like the reference")
    parser.add_argument("--n_slots", type=int, default=8,
                        help="decode slots for --serving continuous")
    return parser


def main(argv=None, backend: Optional[VLMBackend] = None) -> None:
    args = build_parser().parse_args(argv)
    output_dir = Path(args.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    manifest = load_manifest(Path(args.manifest))
    vlm_baseline = VLMDirectJudgingBaseline(
        model_path=args.model_path, device=args.device, backend=backend)

    all_results = {
        "config": {
            "n_samples_per_fold": args.n_samples_per_fold,
            "random_seed": args.random_seed,
            "temperatures": args.temperatures,
            "protocol": ("single_run_full_cohort" if args.fold is None
                         else "fold_based"),
            "serving": args.serving,
            "prompt_template": VLM_DIRECT_JUDGING_PROMPT,
            "system_message": VLM_DIRECT_JUDGING_SYSTEM,
        },
        "folds": {},
    }

    eval_sets: Dict[str, List[Dict]] = {}
    if args.fold is None:
        if args.n_samples_per_fold > 0:
            random.seed(args.random_seed)
            sampled = random.sample(
                manifest, min(args.n_samples_per_fold, len(manifest)))
        else:
            sampled = manifest
        eval_sets["all_patients"] = sampled
        logger.info("Running paper protocol: single run on %d patients",
                    len(sampled))
    else:
        if not args.experiment_dir:
            raise ValueError("--experiment_dir is required when --fold is set")
        splits = load_fold_splits_from_experiments(Path(args.experiment_dir))
        fold_key = f"fold_{args.fold}"
        test_ids = splits.get(fold_key, {}).get("test", [])
        if not test_ids:
            raise ValueError(
                f"No test samples found for {fold_key} in {args.experiment_dir}")
        eval_sets[fold_key] = sample_test_cases(
            test_ids, manifest, args.n_samples_per_fold, args.random_seed)

    for fold_key, sampled_patients in eval_sets.items():
        logger.info("Processing %s (%d patients)", fold_key,
                    len(sampled_patients))
        fold_results = {
            "sampled_patient_ids": [p.get("patient_id")
                                    for p in sampled_patients],
            "predictions": {},
            "metrics": {},
        }
        grid_results = None
        if args.serving == "continuous":
            grid_results = vlm_baseline.predict_grid(
                sampled_patients, args.temperatures, n_slots=args.n_slots,
                seed_base=args.random_seed)
        for temp in args.temperatures:
            temp_key = f"temp_{temp}"
            logger.info("Running with temperature=%s", temp)
            if grid_results is not None:
                predictions = grid_results[temp]
            else:
                predictions = []
                for patient in sampled_patients:
                    result = vlm_baseline.predict(patient, temperature=temp)
                    if result:
                        predictions.append(result)
                    else:
                        logger.warning("  %s: Failed to predict",
                                       patient.get("patient_id"))
            fold_results["predictions"][temp_key] = predictions
            metrics = evaluate_predictions(predictions)
            logger.info("  Metrics: Acc=%.3f, F1=%.3f",
                        metrics.get("accuracy", 0), metrics.get("macro_f1", 0))
            fold_results["metrics"][temp_key] = metrics

        if len(args.temperatures) >= 2:
            fold_results["agreement"] = calculate_agreement(
                [fold_results["predictions"][f"temp_{t}"]
                 for t in args.temperatures])
        all_results["folds"][fold_key] = fold_results

    with (output_dir / "vlm_direct_judging_results.json").open(
            "w", encoding="utf-8") as f:
        json.dump(all_results, f, indent=2, ensure_ascii=False)

    summary = {
        "total_samples": sum(len(f.get("sampled_patient_ids", []))
                             for f in all_results["folds"].values()),
        "temperatures": args.temperatures,
        "average_metrics": {},
    }
    for temp in args.temperatures:
        temp_key = f"temp_{temp}"
        accs = [f["metrics"][temp_key]["accuracy"]
                for f in all_results["folds"].values()
                if temp_key in f.get("metrics", {}) and f["metrics"][temp_key]]
        f1s = [f["metrics"][temp_key]["macro_f1"]
               for f in all_results["folds"].values()
               if temp_key in f.get("metrics", {}) and f["metrics"][temp_key]]
        summary["average_metrics"][temp_key] = {
            "accuracy_mean": float(np.mean(accs)) if accs else 0.0,
            "accuracy_std": float(np.std(accs)) if accs else 0.0,
            "f1_mean": float(np.mean(f1s)) if f1s else 0.0,
            "f1_std": float(np.std(f1s)) if f1s else 0.0,
        }
    agreements = [f.get("agreement", {}).get("overall_agreement", 0)
                  for f in all_results["folds"].values()
                  if f.get("agreement")]
    if agreements:
        summary["average_metrics"]["agreement"] = {
            "mean": float(np.mean(agreements)),
            "std": float(np.std(agreements)),
        }
    with (output_dir / "summary.json").open("w", encoding="utf-8") as f:
        json.dump(summary, f, indent=2, ensure_ascii=False)
    logger.info("Results saved to %s", output_dir)


if __name__ == "__main__":
    main()
