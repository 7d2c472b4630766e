"""VLM audit module: the step4 quality-control gatekeeper.

Port of ``emr2a_tpu/judge/audit.py``: evidence packaging (4 even-spaced
query slices + 2 per neighbour x 5 neighbours + meta text), the request of
query images + the first image of the top-3 neighbours, the parse
waterfall (``judge/parsers.py``), threshold gating (accept / reject at or
above their thresholds, else abstain), batch aggregation and NEEDS_REVIEW
routing.

``audit_batch`` serves one case at a time, or ``vlm_batch_size`` cases per
prefill and decode (the backend's ``generate_batch``), or every case
through continuous batching (``serving="continuous"``: its
``generate_stream``), as the JAX package does.

Divergences (ROADMAP.md, Queue 3):
- ``query_vlm_audit`` degrades to abstain only where the JAX package's
  reasons for it are: no backend, no usable image, an unreadable image
  file, or an output the parser cannot read (the parser itself never
  raises). Every other exception propagates: a CUDA error stops the run
  instead of turning every case into an abstain. The batched and
  continuous paths keep the same rule: a case with no usable or readable
  evidence image abstains alone, and a failed ``generate_batch`` /
  ``generate_stream`` raises where the JAX package retries the cases in
  smaller batches and abstains on what still fails.
- The one-case loop passes ``max_new_tokens`` (step4's
  ``--vlm_max_new_tokens``) to the backend; the JAX package's one-case loop
  drops it and generates its default 1024 tokens.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageDraw, ImageFont

from emr2a_tpu_torch.judge.backends import VLMBackend, load_backend
from emr2a_tpu_torch.judge.parsers import parse_audit_output
from emr2a_tpu_torch.judge.prompts import get_vlm_audit_prompt, split_audit_prompt

logger = logging.getLogger(__name__)


def select_even_slices(slice_paths: Sequence[str], num_slices: int = 4
                       ) -> List[str]:
    """Evenly spaced slice subset, order-preserving and de-duplicated.

    Capability parity with the reference's even-spacing selection
    (vlm_audit_module.py:157-172): ``num_slices`` indices spread over
    [0, n-1] inclusive of both ends.
    """
    n = len(slice_paths)
    if n == 0 or num_slices <= 0:
        return []
    if n <= num_slices:
        return list(slice_paths)
    step = (n - 1) / max(num_slices - 1, 1)  # num_slices==1 -> first slice
    picks = (slice_paths[int(i * step)] for i in range(num_slices))
    return list(dict.fromkeys(picks))


def create_montage(slice_paths: Sequence[str],
                   output_path: Optional[Path] = None,
                   grid_size: Tuple[int, int] = (2, 2),
                   label: Optional[str] = None,
                   base_dir: Optional[Path] = None) -> Optional[Image.Image]:
    """Tile slices into a cols x rows evidence grid, optionally labeled.

    Same artifact role as the reference's montage builder
    (vlm_audit_module.py:93-155); assembled as one numpy block instead
    of sequential pastes, and mismatched slice sizes are resized to the
    first slice's size (the reference pastes them unresized, silently
    corrupting the grid — deliberate fix, vlm_audit_module.py:130-137).
    """
    tiles: List[np.ndarray] = []
    for p in slice_paths:
        full = _resolve(str(p), base_dir)
        try:
            with Image.open(full) as img:
                tiles.append(np.asarray(img.convert("RGB")))
        except OSError as e:
            logger.warning("Skipping unreadable slice %s: %s", full, e)
    if not tiles:
        return None
    try:
        cols, rows = grid_size
        h, w = tiles[0].shape[:2]
        cells = [t if t.shape[:2] == (h, w)
                 else np.asarray(Image.fromarray(t).resize((w, h)))
                 for t in tiles[:cols * rows]]
        blank = np.full((h, w, 3), 255, np.uint8)
        cells += [blank] * (cols * rows - len(cells))
        grid = np.asarray(cells).reshape(rows, cols, h, w, 3)
        montage = Image.fromarray(
            grid.transpose(0, 2, 1, 3, 4).reshape(rows * h, cols * w, 3))

        if label:
            # margin scales with the grid so the tag stays legible on
            # any slice resolution
            margin = max(8, h // 48)
            ImageDraw.Draw(montage).text(
                (margin, margin), label, fill=(255, 0, 0),
                font=_montage_font(max(16, h // 24)))

        if output_path:
            output_path = Path(output_path)
            output_path.parent.mkdir(parents=True, exist_ok=True)
            montage.save(output_path)
        return montage
    except Exception as e:
        logger.error("Failed to create montage: %s", e)
        return None


def _montage_font(size: int):
    try:
        return ImageFont.load_default(size=size)
    except Exception:
        return ImageFont.load_default()


def _resolve(path: str, base_dir: Optional[Path]) -> Path:
    p = Path(path)
    if not p.is_absolute() and base_dir:
        p = base_dir / path
    return p


def render_query_text(meta: Dict) -> str:
    parts = ["Query Patient Information:"]
    if meta.get("sex"):
        parts.append(f"- Sex: {meta['sex']}")
    if meta.get("age"):
        parts.append(f"- Age: {meta['age']}")
    if meta.get("fever"):
        parts.append(f"- Fever: {meta['fever']}")
    if meta.get("symptom"):
        parts.append(f"- Symptoms: {meta['symptom']}")
    return "\n".join(parts)


class VLMAuditModule:

    def __init__(self, model_path: Optional[str] = None, device: str = "cuda",
                 max_retries: int = 3, accept_threshold: float = 0.7,
                 reject_threshold: float = 0.7,
                 abstain_threshold: float = 0.5,
                 backend: Optional[VLMBackend] = None,
                 precision: str = "bf16", kv_dtype: str = "bf16",
                 draft_model_path: Optional[str] = None,
                 prefill_chunk: Optional[int] = None, tp: int = 1):
        self.model_path = model_path
        self.device = device
        self.max_retries = max_retries
        self.accept_threshold = accept_threshold
        self.reject_threshold = reject_threshold
        self.abstain_threshold = abstain_threshold
        self.backend = backend if backend is not None \
            else load_backend(model_path, device, precision=precision,
                              kv_dtype=kv_dtype,
                              draft_model_path=draft_model_path,
                              prefill_chunk=prefill_chunk, tp=tp)

    # -- evidence --

    def construct_evidence_package(self, query_patient: Dict,
                                   top_neighbors: List[Tuple[str, str, float]],
                                   manifest: List[Dict], output_dir: Path,
                                   base_dir: Optional[Path] = None) -> Dict:
        query_meta = query_patient.get("meta", {})
        query_images = [
            str(p) for p in
            (_resolve(s, base_dir)
             for s in select_even_slices(query_patient.get("slices", []), 4))
            if p.exists()]

        pid_to_record = {r.get("patient_id"): r for r in manifest}
        neighbor_data = []
        for rank, (nid, nlabel, sim) in enumerate(top_neighbors[:5], 1):
            record = pid_to_record.get(nid)
            if not record:
                continue
            images = [
                str(p) for p in
                (_resolve(s, base_dir)
                 for s in select_even_slices(record.get("slices", []), 2))
                if p.exists()]
            neighbor_data.append({
                "rank": rank,
                "id": nid,
                "label": nlabel,
                "similarity": sim,
                "images": images,
                "meta": record.get("meta", {}),
            })

        return {
            "query_id": query_patient.get("patient_id"),
            "query_images": query_images,
            "query_text": render_query_text(query_meta),
            "query_meta": query_meta,
            "neighbors": neighbor_data,
        }

    # -- querying --

    def _build_audit_request(self, evidence_package: Dict,
                             predicted_label: str,
                             prompt_template: Optional[str] = None
                             ) -> Optional[Dict]:
        """Assemble the generation request for one audit case: query
        images + first image of the top-3 neighbors + formatted prompt
        (vlm_audit_module.py:249-330).  Returns ``{images, prompt,
        system, cited_neighbors}`` or None if no usable images exist.

        The template's constant instruction block rides as the SYSTEM
        message (judge/prompts.split_audit_prompt): in token order it
        precedes the per-case images, so a batch of audit cases shares
        it as a literal token prefix and continuous serving prefills it
        once per wave instead of once per case."""
        if prompt_template is None:
            prompt_template = get_vlm_audit_prompt()
        system, prompt_template = split_audit_prompt(prompt_template)

        query_images = evidence_package.get("query_images", [])
        if not query_images:
            logger.error("No query images found")
            return None

        images = [Image.open(p).convert("RGB") for p in query_images
                  if Path(p).exists()]

        neighbors = evidence_package.get("neighbors", [])
        cited_neighbors = []
        for neighbor in neighbors[:3]:
            imgs = neighbor.get("images", [])
            if imgs and Path(imgs[0]).exists():
                images.append(Image.open(imgs[0]).convert("RGB"))
                cited_neighbors.append(neighbor["rank"])

        if not images:
            logger.error("No valid images found")
            return None

        neighbor_text = "\n".join(
            f"  [{n['rank']}] ID: {n['id']}, Label: {n['label']}, "
            f"Similarity: {n['similarity']:.3f}"
            for n in neighbors[:3])

        prompt = prompt_template.format(
            query_text=evidence_package["query_text"],
            predicted_label=predicted_label,
            neighbor_info=neighbor_text)
        return {"images": images, "prompt": prompt,
                "system": system or None,
                "cited_neighbors": cited_neighbors}

    def query_vlm_audit(self, evidence_package: Dict, predicted_label: str,
                        prompt_template: Optional[str] = None,
                        temperature: float = 0.0,
                        max_new_tokens: int = 1024) -> Optional[Dict]:
        if self.backend is None:
            logger.warning("VLM backend not loaded")
            return None
        try:
            request = self._build_audit_request(
                evidence_package, predicted_label, prompt_template)
        except OSError as e:
            logger.error("Unreadable evidence image: %s", e)
            return None
        if request is None:
            return None
        output_text = self.backend.generate(
            request["images"], request["prompt"],
            system=request.get("system"),
            max_new_tokens=max_new_tokens, temperature=temperature)
        result = parse_audit_output(output_text)
        if result and request["cited_neighbors"]:
            result["cited_neighbors"] = request["cited_neighbors"]
        return result

    # -- decision logic --

    def _apply_decision_thresholds(self, vlm_decision: str,
                                   vlm_confidence: float) -> str:
        """accept/reject stand only above their thresholds; everything
        else abstains (vlm_audit_module.py:736-761)."""
        if vlm_decision == "accept":
            return "accept" if vlm_confidence >= self.accept_threshold else "abstain"
        if vlm_decision == "reject":
            return "reject" if vlm_confidence >= self.reject_threshold else "abstain"
        return "abstain"

    def audit_batch(self, retrieval_predictions: List[str],
                    retrieval_similarities: List[List[float]],
                    retrieval_labels: List[List[str]],
                    query_patients: List[Dict],
                    top_neighbors_list: List[List[Tuple[str, str, float]]],
                    manifest: List[Dict], output_dir: Path,
                    base_dir: Optional[Path] = None,
                    prompt_template: Optional[str] = None,
                    vlm_batch_size: int = 1,
                    serving: str = "static",
                    max_new_tokens: int = 1024) -> Dict:
        """``vlm_batch_size > 1`` serves that many cases per prefill and
        decode through the backend's ``generate_batch``;
        ``serving="continuous"`` (``vlm_batch_size`` slots, batched even at
        1) streams every case through its ``generate_stream``. Default: one
        case at a time, as the reference's loop does. A case whose evidence
        has no usable or readable image abstains on its own; a failed
        generation raises (the JAX package falls back to smaller batches,
        then to abstains)."""
        logger.info("Starting VLM audit on %d samples", len(query_patients))
        samples = list(zip(query_patients, top_neighbors_list,
                           retrieval_predictions))
        vlm_results: List[Optional[Dict]] = []
        batched = ((vlm_batch_size > 1 or serving == "continuous")
                   and self.backend is not None
                   and hasattr(self.backend, "generate_batch"))
        if batched:
            requests: List[Optional[Dict]] = []
            for query_patient, top_neighbors, pred_label in samples:
                evidence = self.construct_evidence_package(
                    query_patient, top_neighbors, manifest, output_dir, base_dir)
                try:
                    requests.append(self._build_audit_request(
                        evidence, pred_label, prompt_template))
                except OSError as e:
                    logger.error("Unreadable evidence image: %s", e)
                    requests.append(None)
            vlm_results = [None] * len(samples)
            live = [i for i, r in enumerate(requests) if r is not None]
            if serving == "continuous" and hasattr(self.backend, "generate_stream"):
                logger.info("Streaming %d audit cases through %d slots",
                            len(live), vlm_batch_size)
                groups = [(live, self.backend.generate_stream(
                    [requests[i] for i in live], max_new_tokens=max_new_tokens,
                    n_slots=vlm_batch_size))]
            else:
                groups = []
                for lo in range(0, len(live), vlm_batch_size):
                    chunk = live[lo:lo + vlm_batch_size]
                    logger.info("Auditing batch of %d (samples %s)", len(chunk),
                                [i + 1 for i in chunk])
                    groups.append((chunk, self.backend.generate_batch(
                        [requests[i] for i in chunk], max_new_tokens=max_new_tokens)))
            for chunk, outputs in groups:
                for i, output_text in zip(chunk, outputs):
                    result = parse_audit_output(output_text)
                    if result and requests[i]["cited_neighbors"]:
                        result["cited_neighbors"] = requests[i]["cited_neighbors"]
                    vlm_results[i] = result
        else:
            for idx, (query_patient, top_neighbors, pred_label) in enumerate(samples):
                logger.info("Auditing sample %d/%d: %s", idx + 1, len(samples),
                            query_patient.get("patient_id", "unknown"))
                evidence = self.construct_evidence_package(
                    query_patient, top_neighbors, manifest, output_dir, base_dir)
                vlm_results.append(self.query_vlm_audit(
                    evidence, pred_label, prompt_template=prompt_template,
                    max_new_tokens=max_new_tokens))

        audit_results = []
        for (query_patient, top_neighbors, pred_label), vlm_result in zip(
                samples, vlm_results):
            if vlm_result is None:
                vlm_result = {"decision": "abstain", "confidence": 0.0,
                              "cited_neighbors": [],
                              "rationale": "VLM query failed"}

            final_decision = self._apply_decision_thresholds(
                vlm_result["decision"], vlm_result["confidence"])
            audit_results.append({
                "patient_id": query_patient.get("patient_id"),
                "predicted_label": pred_label,
                "vlm_decision": vlm_result["decision"],
                "vlm_confidence": vlm_result["confidence"],
                "final_decision": final_decision,
                "cited_neighbors": vlm_result.get("cited_neighbors", []),
                "rationale": vlm_result.get("rationale", ""),
            })

        decisions = [r["final_decision"] for r in audit_results]
        n = len(decisions) or 1
        counts = {d: decisions.count(d) for d in ("accept", "reject", "abstain")}
        logger.info("Audit completed: accept=%d reject=%d abstain=%d",
                    counts["accept"], counts["reject"], counts["abstain"])
        return {
            "audit_results": audit_results,
            "accept_count": counts["accept"],
            "reject_count": counts["reject"],
            "abstain_count": counts["abstain"],
            "accept_ratio": counts["accept"] / n if decisions else 0.0,
            "reject_ratio": counts["reject"] / n if decisions else 0.0,
            "abstain_ratio": counts["abstain"] / n if decisions else 0.0,
        }

    def compute_final_predictions(self, retrieval_predictions: List[str],
                                  audit_results: List[Dict],
                                  ground_truth: Optional[List[str]] = None
                                  ) -> Dict:
        """accept → keep; reject/abstain → NEEDS_REVIEW; coverage +
        accuracy-on-accepted (vlm_audit_module.py:763-822)."""
        final_predictions = []
        needs_human_review = []
        for pred, audit in zip(retrieval_predictions, audit_results):
            if audit["final_decision"] == "accept":
                final_predictions.append(pred)
                needs_human_review.append(False)
            else:
                final_predictions.append("NEEDS_REVIEW")
                needs_human_review.append(True)

        # Empty batches (e.g. every sampled case missing from the
        # manifest) must degrade, not crash — skip-and-continue
        # semantics (SURVEY §5 failure detection).
        review_ratio = (sum(needs_human_review) / len(needs_human_review)
                        if needs_human_review else 0.0)
        result = {
            "final_predictions": final_predictions,
            "needs_human_review": needs_human_review,
            "coverage": 1.0 - review_ratio,
            "human_review_ratio": review_ratio,
        }
        if ground_truth:
            accepted = [i for i, needs in enumerate(needs_human_review)
                        if not needs]
            if accepted:
                correct = sum(
                    1 for i in accepted
                    if retrieval_predictions[i] == ground_truth[i])
                result["accuracy_on_accepted"] = correct / len(accepted)
                result["n_accepted"] = len(accepted)
            else:
                result["accuracy_on_accepted"] = 0.0
                result["n_accepted"] = 0
        return result
