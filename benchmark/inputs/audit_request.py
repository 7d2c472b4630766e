"""A frozen copy of step4's audit request (``emr2a_tpu_torch/judge/audit.py``
``VLMAuditModule._build_audit_request`` with ``judge/prompts.py``'s
``VLM_AUDIT_PROMPT`` and ``split_audit_prompt``) over images in memory,
the synthetic cohort's patient records, and the Qwen chat text that the
backend renders for a tokenizer without a chat template."""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional

LABELS = ("Bacterial", "Viral", "PJP", "Normal")
SYMPTOMS = ("咳嗽", "气促", "胸痛", "乏力", "咳痰")

VLM_AUDIT_PROMPT = """You are an auditing AI for a medical image retrieval system. \
Your job is to verify a prediction against CT evidence, not to diagnose.

The images are: first 4 = query patient's CT slices, remaining = one slice \
from each cited similar case.

Decide whether the prediction is supported by the imaging evidence.

Respond with ONLY a JSON object:
{{
  "decision": "accept" | "reject" | "abstain",
  "confidence": 0.0-1.0,
  "cited_neighbors": [1, 2],
  "rationale": "one short sentence"
}}

Case under audit:
{query_text}

Prediction under audit: {predicted_label}

Retrieved similar cases:
{neighbor_info}

JSON:"""

AUDIT_CASE_MARKER = "Case under audit:"


def split_audit_prompt(template: str):
    """(system block, case template): the constant instruction block rides
    as the system message, a prefix every audit request shares."""
    marker = "\n\n" + AUDIT_CASE_MARKER + "\n"
    head, sep, tail = template.partition(marker)
    if not sep or "{" in head.replace("{{", "").replace("}}", ""):
        return "", template
    return head.format(), AUDIT_CASE_MARKER + "\n" + tail


def patient(p: int) -> Dict:
    """Patient ``p`` of the synthetic cohort: id, label and the clinical
    fields step1 reads from the cohort's CSVs."""
    return {"patient_id": f"P{p:03d}", "label": LABELS[p % 4],
            "meta": {"sex": "男" if p % 2 else "女", "age": str(25 + (3 * p) % 60),
                     "fever": "是" if p % 3 else "否", "symptom": SYMPTOMS[p % len(SYMPTOMS)]}}


def render_query_text(meta: Dict) -> str:
    parts = ["Query Patient Information:"]
    for key, title in (("sex", "Sex"), ("age", "Age"), ("fever", "Fever"),
                       ("symptom", "Symptoms")):
        if meta.get(key):
            parts.append(f"- {title}: {meta[key]}")
    return "\n".join(parts)


def select_even(n: int, k: int) -> List[int]:
    """``select_even_slices``' indices: ``k`` evenly spaced over [0, n - 1]."""
    if n <= k:
        return list(range(n))
    step = (n - 1) / max(k - 1, 1)
    return list(dict.fromkeys(int(i * step) for i in range(k)))


def build_audit_request(query: Dict, query_images: list, neighbors: List[Dict]) -> Dict:
    """``neighbors``: dicts of rank, id, label, similarity and image (the
    first of its even slices), best first. The prediction under audit is
    the neighbours' majority label, as step4's retrieval gives it."""
    system, template = split_audit_prompt(VLM_AUDIT_PROMPT)
    images = list(query_images) + [n["image"] for n in neighbors[:3]]
    neighbor_text = "\n".join(
        f"  [{n['rank']}] ID: {n['id']}, Label: {n['label']}, "
        f"Similarity: {n['similarity']:.3f}" for n in neighbors[:3])
    predicted = Counter(n["label"] for n in neighbors).most_common(1)[0][0]
    prompt = template.format(query_text=render_query_text(query["meta"]),
                             predicted_label=predicted, neighbor_info=neighbor_text)
    return {"images": images, "prompt": prompt, "system": system or None,
            "cited_neighbors": [n["rank"] for n in neighbors[:3]]}


def render_chat(n_images: int, prompt: str, system: Optional[str]) -> str:
    sys_part = f"<|im_start|>system\n{system}<|im_end|>\n" if system else ""
    img_part = "<|vision_start|><|image_pad|><|vision_end|>" * n_images
    return (f"{sys_part}<|im_start|>user\n{img_part}{prompt}<|im_end|>\n"
            f"<|im_start|>assistant\n")
