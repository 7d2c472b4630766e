"""The reference's import location for the audit prompts."""

from emr2a_tpu_torch.judge.prompts import (  # noqa: F401
    VLM_AUDIT_CONSERVATIVE_PROMPT,
    VLM_AUDIT_EVIDENCE_CITATION_PROMPT,
    VLM_AUDIT_PROMPT,
    get_vlm_audit_evidence_prompt,
    get_vlm_audit_prompt,
    get_vlm_diagnosis_label_only_prompt,
    get_vlm_diagnosis_review_prompt,
    get_vlm_review_decision_prompt,
)
