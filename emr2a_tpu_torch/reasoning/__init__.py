from emr2a_tpu_torch.reasoning.evaluator import ReasoningEvaluator
from emr2a_tpu_torch.reasoning.prompt_templates import (
    build_diagnosis_prompt,
    build_review_prompt,
    build_treatment_prompt,
)

__all__ = [
    "ReasoningEvaluator",
    "build_diagnosis_prompt",
    "build_review_prompt",
    "build_treatment_prompt",
]
