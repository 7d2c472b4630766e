"""LLM reasoning evaluator: diagnose / review / suggest_treatment.

Port of ``emr2a_tpu/reasoning/evaluator.py`` on the port's
``judge/parsers``: brace-matching JSON extraction, typed fallback dicts
with raw_response attached, zh label normalization, and diagnosis-accuracy
scoring.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from emr2a_tpu_torch.judge.parsers import extract_json_payload
from emr2a_tpu_torch.reasoning.prompt_templates import (
    build_diagnosis_prompt,
    build_review_prompt,
    build_treatment_prompt,
)

# substring -> canonical zh label (reasoning/evaluator.py:182-225 map)
_LABEL_MAP = {
    "病毒性肺炎": "病毒性肺炎", "病毒性": "病毒性肺炎", "病毒": "病毒性肺炎",
    "viral": "病毒性肺炎",
    "细菌性肺炎": "细菌性肺炎", "细菌性": "细菌性肺炎", "细菌": "细菌性肺炎",
    "bacterial": "细菌性肺炎",
    "pjp肺炎": "pjp肺炎", "pjp": "pjp肺炎", "肺孢子菌肺炎": "pjp肺炎",
    "正常": "正常", "正常胸部": "正常", "normal": "正常",
}


class ReasoningEvaluator:

    def __init__(self, llm):
        self.llm = llm

    def extract_json_payload(self, raw_output: str) -> Optional[Dict]:
        # one shared parser: judge/parsers.extract_json_payload already
        # whole-string-parses before its fenced/embedded-object scans
        return extract_json_payload(raw_output)

    def _call_llm(self, prompt: str, images, max_new_tokens: int,
                  temperature: float) -> str:
        kwargs = dict(max_new_tokens=max_new_tokens, temperature=temperature)
        if images:
            return self.llm.generate(prompt=prompt, images=images, **kwargs)
        return self.llm.generate(prompt=prompt, **kwargs)

    def diagnose(self, patient_info: Dict, images: Optional[List] = None,
                 retrieved_cases: Optional[List[Dict]] = None,
                 max_new_tokens: int = 512, temperature: float = 0.2) -> Dict:
        prompt = build_diagnosis_prompt(patient_info, retrieved_cases,
                                        include_image=bool(images))
        response = self._call_llm(prompt, images, max_new_tokens, temperature)
        result = self.extract_json_payload(response)
        if result is None:
            result = {"diagnosis": "未知", "confidence": "低",
                      "reasoning": response, "key_findings": []}
        result["raw_response"] = response
        return result

    def review(self, patient_info: Dict, retrieval_result: Dict,
               images: Optional[List] = None, max_new_tokens: int = 512,
               temperature: float = 0.2) -> Dict:
        prompt = build_review_prompt(patient_info, retrieval_result,
                                     include_image=bool(images))
        response = self._call_llm(prompt, images, max_new_tokens, temperature)
        result = self.extract_json_payload(response)
        if result is None:
            result = {"final_diagnosis": "未知", "confidence": "低",
                      "agreement_with_retrieval": "否", "reasoning": response}
        result["raw_response"] = response
        return result

    def suggest_treatment(self, patient_info: Dict, diagnosis: str,
                          images: Optional[List] = None,
                          max_new_tokens: int = 512,
                          temperature: float = 0.2) -> Dict:
        prompt = build_treatment_prompt(patient_info, diagnosis,
                                        include_image=bool(images))
        response = self._call_llm(prompt, images, max_new_tokens, temperature)
        result = self.extract_json_payload(response)
        if result is None:
            result = {"diagnosis_confirmation": diagnosis,
                      "treatment_plan": "未知", "medications": [],
                      "recommendations": [], "follow_up": ""}
        result["raw_response"] = response
        return result

    def evaluate_accuracy(self, predictions: List[Dict],
                          ground_truth: List[str]) -> Dict[str, float]:
        if len(predictions) != len(ground_truth):
            raise ValueError(
                "Predictions and ground truth must have the same length")
        if not ground_truth:
            # the reference divides by zero here
            # (reasoning/evaluator.py:193) — reference bug, fixed
            return {"accuracy": 0.0, "correct": 0, "total": 0}
        correct = sum(
            1 for pred, gt in zip(predictions, ground_truth)
            if self._normalize_label(
                pred.get("diagnosis", pred.get("final_diagnosis", "")))
            == self._normalize_label(gt))
        return {"accuracy": correct / len(ground_truth),
                "correct": correct, "total": len(ground_truth)}

    def _normalize_label(self, label: str) -> str:
        label = str(label).strip().lower()
        for key, value in _LABEL_MAP.items():
            if key in label:
                return value
        return label
