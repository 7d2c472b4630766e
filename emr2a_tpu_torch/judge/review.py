"""G2 goalkeeper review: the in-CV VLM check that the CV runner's
``--vlm_review`` runs.

Port of ``emr2a_tpu/judge/review.py`` (``VLMReviewModule``) with its dict
keys and files: montage evidence under ``evidence_{idx}/`` (2x2 grids with a
label overlay, ``judge.audit.create_montage``), the G2 diagnosis prompt with
its one-line contract, JSON-or-text parsing with the valid-class filter, and
the agreement / needs-review aggregation. The final prediction stays the
retrieval vote; a disagreement only flags the case for review.

Divergence (ROADMAP.md, Queue 3): ``query_vlm`` returns None (an
abstention) only where the JAX package's reasons for it are: no backend, a
missing montage, an unreadable montage, or an output the parser cannot
read. The JAX package catches every exception there; here every other one
propagates, so a failed kernel launch stops the run instead of turning
every review into an abstention. The default ``device`` is ``cuda``.
"""

from __future__ import annotations

import logging
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from emr2a_tpu_torch.judge.audit import create_montage
from emr2a_tpu_torch.judge.backends import VLMBackend, load_backend
from emr2a_tpu_torch.judge.parsers import extract_json_payload
from emr2a_tpu_torch.judge.prompts import G2_REVIEW_PROMPT, G2_REVIEW_SYSTEM_MESSAGE

logger = logging.getLogger(__name__)

VALID_CLASSES = ["PJP", "Bacterial", "Viral", "Normal"]


class VLMReviewModule:

    def __init__(self, model_path: Optional[str] = None, device: str = "cuda",
                 max_retries: int = 3,
                 backend: Optional[VLMBackend] = None):
        self.model_path = model_path
        self.device = device
        self.max_retries = max_retries
        self.backend = backend if backend is not None \
            else load_backend(model_path, device)

    create_montage = staticmethod(create_montage)

    def construct_evidence_package(self, query_patient: Dict,
                                   top_neighbors: List[Tuple[str, str, float]],
                                   manifest: List[Dict], output_dir: Path,
                                   base_dir: Optional[Path] = None) -> Dict:
        """The query's montage and up to 5 neighbours' under ``output_dir``,
        and the query text: the patient's meta and the neighbours' labels
        and similarities."""
        query_id = query_patient.get("patient_id")
        query_meta = query_patient.get("meta", {})
        output_dir = Path(output_dir)
        query_montage_path = output_dir / f"query_{query_id}_montage.png"
        create_montage(query_patient.get("slices", [])[:4], query_montage_path,
                       (2, 2), "Query Patient", base_dir)

        pid_to_record = {r.get("patient_id"): r for r in manifest}
        neighbor_montages = []
        for nid, nlabel, sim in top_neighbors[:5]:
            record = pid_to_record.get(nid)
            if not record:
                continue
            montage_path = output_dir / f"neighbor_{nid}_montage.png"
            create_montage(record.get("slices", [])[:4], montage_path, (2, 2),
                           f"Similar Case (sim: {sim:.3f})", base_dir)
            neighbor_montages.append({"id": nid, "label": nlabel, "similarity": sim,
                                      "montage_path": str(montage_path)})

        parts = ["Query Patient Information:"]
        for key, name in (("sex", "Sex"), ("age", "Age"), ("fever", "Fever"),
                          ("symptom", "Symptoms")):
            if query_meta.get(key):
                parts.append(f"- {name}: {query_meta[key]}")
        parts.append("\nTop 5 Similar Cases (for reference):")
        for i, n in enumerate(neighbor_montages, 1):
            parts.append(f"{i}. Label: {n.get('label', 'Unknown')}, "
                         f"Similarity: {n['similarity']:.3f}")

        return {
            "query_id": query_id,
            "query_montage_path": str(query_montage_path),
            "query_text": "\n".join(parts),
            "query_meta": query_meta,
            "neighbors": neighbor_montages,
        }

    def query_vlm(self, evidence_package: Dict,
                  prompt_template: Optional[str] = None) -> Optional[Dict]:
        """The backend's diagnosis of the query montage (512 new tokens,
        greedy), parsed; None for no backend, a missing or unreadable
        montage, or an unparseable output. Other errors propagate."""
        if self.backend is None:
            logger.warning("VLM backend not loaded, returning None")
            return None
        prompt = (prompt_template or G2_REVIEW_PROMPT).format(
            query_text=evidence_package["query_text"])
        montage_path = evidence_package["query_montage_path"]
        if not Path(montage_path).exists():
            logger.error("Montage image not found: %s", montage_path)
            return None
        try:
            with Image.open(montage_path) as img:
                image = img.convert("RGB")
        except OSError as e:
            logger.error("Unreadable montage %s: %s", montage_path, e)
            return None
        output_text = self.backend.generate(
            [image], prompt, system=G2_REVIEW_SYSTEM_MESSAGE,
            max_new_tokens=512, temperature=0.0)
        return self._parse_vlm_output(output_text)

    def _parse_vlm_output(self, output_text: str) -> Optional[Dict]:
        """JSON {diagnosis, confidence, coverage} -> 'Diagnosis:' lines ->
        the one-line 'PJP,0.85,covered' contract, each filtered to the
        valid classes; None where none of them reads, or where a matched
        confidence is no number (``1.2.3``)."""
        try:
            return self._parse(output_text)
        except ValueError as e:
            logger.error("Error parsing VLM output: %s", e)
            return None

    def _parse(self, output_text: str) -> Optional[Dict]:
        text = output_text.strip()
        payload = extract_json_payload(text)
        if payload and "diagnosis" in payload:
            result = self._normalize(str(payload.get("diagnosis", "")).strip(),
                                     payload.get("confidence", 0.5),
                                     payload.get("coverage", "unknown"), "JSON")
            if result is not None:
                return result
            # an invalid class in the JSON falls through to the text formats

        m_diag = re.search(r"Diagnosis:\s*(\w+)", text, re.IGNORECASE)
        if m_diag:
            m_conf = re.search(r"Confidence:\s*([0-9.]+)", text, re.IGNORECASE)
            m_cov = re.search(r"Coverage:\s*(\w+)", text, re.IGNORECASE)
            result = self._normalize(
                m_diag.group(1).strip(), float(m_conf.group(1)) if m_conf else 0.5,
                m_cov.group(1).strip() if m_cov else "unknown", "text format")
            if result is not None:
                return result

        m_line = re.match(r"\s*([A-Za-z]+)\s*[,，]\s*([0-9.]+)\s*(?:[,，]\s*(\w+))?", text)
        if m_line:
            return self._normalize(m_line.group(1).strip(), float(m_line.group(2)),
                                   m_line.group(3) or "unknown", "one-line format")

        logger.warning("Failed to extract prediction from VLM output: %s...",
                       output_text[:500])
        return None

    def _normalize(self, diagnosis: str, confidence, coverage,
                   source: str) -> Optional[Dict]:
        if diagnosis.lower() == "uncertain":
            return {"pred": "uncertain", "confidence": 0.0,
                    "rationale": ["VLM marked as uncertain"]}
        if diagnosis not in VALID_CLASSES:
            return None
        try:
            confidence = float(confidence)
        except (TypeError, ValueError):
            confidence = 0.5
        if confidence > 1.0:
            confidence = confidence / 100.0
        return {"pred": diagnosis, "confidence": confidence,
                "rationale": [f"Extracted from {source}, Coverage={coverage}"]}

    def g2_goalkeeper_review(self, retrieval_predictions: List[str],
                             retrieval_similarities: List[List[float]],
                             retrieval_labels: List[List[str]],
                             query_patients: List[Dict],
                             top_neighbors_list: List[List[Tuple[str, str, float]]],
                             manifest: List[Dict], output_dir: Path,
                             prompt_template: Optional[str] = None,
                             base_dir: Optional[Path] = None) -> Dict:
        """One review per query (evidence under ``output_dir/evidence_{idx}``):
        the VLM's predictions and confidences, agreement with the retrieval
        vote, the needs-review flags and their rates."""
        logger.info("Starting G2 goalkeeper review")
        vlm_predictions, vlm_confidences = [], []
        agreements, needs_review_flags, final_predictions = [], [], []

        for idx, (query_patient, top_neighbors, pred_vote) in enumerate(zip(
                query_patients, top_neighbors_list, retrieval_predictions)):
            evidence = self.construct_evidence_package(
                query_patient, top_neighbors, manifest,
                Path(output_dir) / f"evidence_{idx}", base_dir)
            vlm_result = self.query_vlm(evidence, prompt_template)
            if vlm_result:
                vlm_predictions.append(vlm_result["pred"])
                vlm_confidences.append(vlm_result["confidence"])
                agree = int(vlm_result["pred"] == pred_vote)
                agreements.append(agree)
                needs_review_flags.append(1 - agree)
            else:
                vlm_predictions.append(None)
                vlm_confidences.append(0.0)
                agreements.append(0)
                needs_review_flags.append(1)
            final_predictions.append(pred_vote)

        agreement_rate = float(np.mean(agreements)) if agreements else 0.0
        needs_review_ratio = (float(np.mean(needs_review_flags))
                              if needs_review_flags else 0.0)
        logger.info("G2 review completed: agreement_rate=%.4f, "
                    "needs_review_ratio=%.4f", agreement_rate, needs_review_ratio)
        return {
            "vlm_predictions": vlm_predictions,
            "vlm_confidences": vlm_confidences,
            "agreements": agreements,
            "needs_review_flags": needs_review_flags,
            "final_predictions": final_predictions,
            "agreement_rate": agreement_rate,
            "needs_review_ratio": needs_review_ratio,
        }

