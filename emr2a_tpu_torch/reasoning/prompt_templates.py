"""Chinese radiologist prompts for diagnose / review / treatment.

A copy of ``emr2a_tpu/reasoning/prompt_templates.py`` (the port imports
nothing of the JAX package): the same prompt functions, texts and JSON output
contracts.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def _patient_block(patient_info: Dict) -> str:
    sex = patient_info.get("sex", patient_info.get("gender", "未知"))
    age = patient_info.get("age", "未知")
    fever = patient_info.get("fever", "未知")
    cough = patient_info.get("cough", "未知")
    symptom = patient_info.get("symptom", "未知")
    return ("\n## 患者信息\n"
            f"- 性别: {sex}\n- 年龄: {age}\n- 发热: {fever}\n"
            f"- 咳嗽: {cough}\n- 症状: {symptom}\n")


def build_diagnosis_prompt(patient_info: Dict,
                           retrieved_cases: Optional[List[Dict]] = None,
                           include_image: bool = True) -> str:
    parts = ["你是一位专业的放射科医生，请结合以下信息给出患者的诊断。\n",
             _patient_block(patient_info)]
    if retrieved_cases:
        parts.append("\n## 相似病例参考\n")
        for i, case in enumerate(retrieved_cases[:5], 1):
            parts.append(f"### 病例 {i}\n")
            parts.append(f"- 诊断结果: {case.get('label', '未知')}\n")
            if "score" in case:
                parts.append(f"- 相似度: {case['score']:.4f}\n")
            if "text" in case:
                parts.append(f"- 文本信息: {case['text']}\n")
            parts.append("\n")
    parts.append(
        "\n## 任务\n"
        "请结合患者信息、CT图像与相似病例，以JSON格式返回诊断：\n"
        "```json\n{\n"
        '  "diagnosis": "诊断结果（病毒性肺炎/细菌性肺炎/PJP肺炎/正常）",\n'
        '  "confidence": "置信度（高/中/低）",\n'
        '  "reasoning": "诊断依据和推理过程",\n'
        '  "key_findings": ["关键发现1", "关键发现2"]\n'
        "}\n```\n")
    return "".join(parts)


def build_review_prompt(patient_info: Dict, retrieval_result: Dict,
                        include_image: bool = True) -> str:
    parts = ["你是一位专业的放射科医生，请复核以下检索诊断结果。\n",
             _patient_block(patient_info), "\n## 检索结果\n"]
    for i, case in enumerate(retrieval_result.get("top_k", [])[:5], 1):
        parts.append(f"### Top {i}\n")
        parts.append(f"- 诊断: {case.get('label', '未知')}\n")
        parts.append(f"- 相似度: {case.get('score', 0):.4f}\n")
        if "text" in case:
            parts.append(f"- 文本: {case['text']}\n")
        parts.append("\n")
    parts.append(
        "\n## 任务\n"
        "请复核检索结果并以JSON格式返回最终诊断：\n"
        "```json\n{\n"
        '  "final_diagnosis": "最终诊断结果",\n'
        '  "confidence": "置信度（高/中/低）",\n'
        '  "agreement_with_retrieval": "是否与检索结果一致（是/否）",\n'
        '  "reasoning": "诊断依据和推理过程"\n'
        "}\n```\n")
    return "".join(parts)


def build_treatment_prompt(patient_info: Dict, diagnosis: str,
                           include_image: bool = True) -> str:
    parts = ["你是一位专业的放射科医生，请针对诊断结果给出治疗建议。\n",
             _patient_block(patient_info),
             f"\n## 诊断结果\n{diagnosis}\n"]
    parts.append(
        "\n## 任务\n"
        "请以JSON格式返回治疗建议：\n"
        "```json\n{\n"
        '  "diagnosis_confirmation": "确认诊断结果",\n'
        '  "treatment_plan": "治疗计划概述",\n'
        '  "medications": ["药物1", "药物2"],\n'
        '  "recommendations": ["建议1", "建议2"],\n'
        '  "follow_up": "随访建议"\n'
        "}\n```\n")
    return "".join(parts)
