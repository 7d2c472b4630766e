"""Audit / review prompt templates.

A plain Python copy of ``emr2a_tpu/judge/prompts.py`` (the port imports
nothing of the JAX package); ``tests/test_torch_judge.py`` holds the two
equal. What follows is the original's description.

Same placeholder + output contract as the reference's
``pipelines/step4_vlm_review/prompt_templates.py`` (format slots
``query_text`` / ``predicted_label`` / ``neighbor_info``; the JSON
output schema {decision, confidence, cited_neighbors, rationale}) —
text authored for this build.

Layout note: unlike the reference's templates (which interleave the
per-case fields into the instruction body), the audit templates here
put the CONSTANT instruction block first and every per-case field
last.  Combined with the backend's ``prompt_layout="text_first"``
(judge/qwen_backend.py), that makes the instruction block a literal
token prefix shared by every case in a batch, so continuous serving
prefills it once per wave (models/serving.py shared-prefix KV)
instead of once per case.
"""

from __future__ import annotations

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


VLM_AUDIT_CONSERVATIVE_PROMPT = """You are a conservative auditing AI for a \
medical image retrieval system. Your priority is catching wrong predictions; \
when in doubt, abstain.

The images are: first 4 = query patient's CT slices, remaining = one slice \
from each cited similar case.

Review procedure:
1. Inspect the query CT slices for findings consistent with the predicted label.
2. Judge whether the cited similar cases genuinely resemble the query.
3. Actively search for imaging evidence that contradicts the prediction.

Decision rules:
- "accept" only with strong supporting evidence (be more than 80% sure)
- "reject" only with clear contradicting evidence
- "abstain" whenever the evidence is weak, mixed, or unclear

Respond with ONLY a single-line JSON object:
{{
  "decision": "accept" | "reject" | "abstain",
  "confidence": 0.0-1.0,
  "cited_neighbors": [1, 2],
  "rationale": "one short sentence citing the decisive evidence"
}}

Case under audit:
{query_text}

Prediction under audit: {predicted_label}

Retrieved similar cases:
{neighbor_info}

JSON:"""


VLM_AUDIT_EVIDENCE_CITATION_PROMPT = """You are an evidence-grounded audit AI. \
Every decision must cite the specific retrieved cases that justify it.

For each cited neighbor, state whether it supports or contradicts the \
prediction, then decide.

Respond with ONLY a JSON object:
{{
  "decision": "accept" | "reject" | "abstain",
  "confidence": 0.0-1.0,
  "cited_neighbors": [ranks of the cases your decision relies on],
  "rationale": "which neighbors support/contradict and why"
}}

Case under audit:
{query_text}

Prediction under audit: {predicted_label}

Retrieved evidence, ranked by similarity:
{neighbor_info}

JSON:"""


# Legacy direct-diagnosis prompts (capability parity with the
# reference's VLM_DIAGNOSIS_* / VLM_REVIEW_DECISION_* family).

VLM_DIAGNOSIS_REVIEW_PROMPT = """You are a chest-CT diagnostic AI for \
4-class pneumonia subtyping (PJP / Bacterial / Viral / Normal).

{query_text}

Based on the CT images and clinical context, output ONLY a JSON object:
{{"diagnosis": "PJP" | "Bacterial" | "Viral" | "Normal", "confidence": 0.0-1.0}}"""

VLM_DIAGNOSIS_LABEL_ONLY_PROMPT = """Output EXACTLY one label from: \
PJP, Bacterial, Viral, Normal. No other text."""

VLM_REVIEW_DECISION_PROMPT = """You are a chest-CT review AI. A retrieval \
system predicted: {predicted_label}

{query_text}

Output EXACTLY one word: agree, disagree, or uncertain."""


# The audit templates above open with a constant instruction block and
# end with the per-case fields, separated by this marker line.
AUDIT_CASE_MARKER = "Case under audit:"


def split_audit_prompt(template: str):
    """Split an audit template into ``(system_block, case_template)``.

    The constant instruction block becomes the chat SYSTEM message,
    which precedes the per-case images in token order — so across a
    batch of audit cases it is a literal shared token prefix that
    continuous serving prefills once per wave (models/serving.py
    shared-prefix KV) instead of once per case.  Templates without the
    marker, or whose head carries format fields (custom templates),
    return ``("", template)`` — unsplit, one user message, exactly the
    pre-split behavior.
    """
    marker = "\n\n" + AUDIT_CASE_MARKER + "\n"
    head, sep, tail = template.partition(marker)
    if not sep or "{" in head.replace("{{", "").replace("}}", ""):
        return "", template
    # the head is field-free; .format() just unescapes {{ }} -> { }
    return head.format(), AUDIT_CASE_MARKER + "\n" + tail


def get_vlm_audit_prompt(conservative: bool = False) -> str:
    return VLM_AUDIT_CONSERVATIVE_PROMPT if conservative else VLM_AUDIT_PROMPT


def get_vlm_audit_evidence_prompt() -> str:
    return VLM_AUDIT_EVIDENCE_CITATION_PROMPT


def get_vlm_diagnosis_review_prompt() -> str:
    return VLM_DIAGNOSIS_REVIEW_PROMPT


def get_vlm_diagnosis_label_only_prompt() -> str:
    return VLM_DIAGNOSIS_LABEL_ONLY_PROMPT


def get_vlm_review_decision_prompt() -> str:
    return VLM_REVIEW_DECISION_PROMPT


# G2 goalkeeper (legacy in-CV review): Chinese diagnosis prompt with the
# one-line "诊断,置信度,覆盖状态" output contract (utils/vlm_review.py:174-195).
G2_REVIEW_PROMPT = """你是一位胸部CT影像诊断AI，负责肺部感染性疾病的四分类鉴别。

【标签集合】PJP / Bacterial / Viral / Normal

【病例信息】
{query_text}

【要求】
- 结合CT影像特征与临床信息（年龄、性别、发烧、症状）作出判断
- 参考相似病例的标签与相似度
- 输出四分类诊断与置信度（0.00-1.00）

【输出格式】只输出一行：诊断,置信度,覆盖状态
例如：PJP,0.85,covered
不要输出推理过程或其他内容。
"""

G2_REVIEW_SYSTEM_MESSAGE = (
    "你是医疗诊断助手。只输出一行，格式为：诊断,置信度,覆盖状态"
    "（例如：PJP,0.85,covered）。不要输出推理过程或解释。")
