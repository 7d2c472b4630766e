"""The port's ``llms/`` and ``reasoning/`` against the JAX package's, on
JAX's ``tests/test_llms_reasoning.py`` cases: the factory and its aliases,
the diagnosis / review / treatment prompts (equal to JAX's text for text),
the evaluator's JSON parsing, fallbacks, label normalization and accuracy,
``Qwen3LLM.generate_stream``'s routing to the backend's continuous
serving, and the OpenAI payload through a stub client (no ``openai``
package, no network). Where both packages run a case, the outputs are
compared."""

import base64
import importlib.util
import io

import pytest
from PIL import Image

import emr2a_tpu.llms as jax_llms
import emr2a_tpu.reasoning as jax_reasoning
from emr2a_tpu.judge.backends import FakeVLMBackend as JaxFakeBackend
from emr2a_tpu_torch.judge.backends import FakeVLMBackend
from emr2a_tpu_torch.llms import FakeLLM, OpenAILLM, Qwen3LLM, create_llm
from emr2a_tpu_torch.reasoning import (
    ReasoningEvaluator,
    build_diagnosis_prompt,
    build_review_prompt,
    build_treatment_prompt,
)

PATIENT = {"sex": "男", "age": "42", "fever": "有", "symptom": "咳嗽"}
CASES = [{"label": "PJP肺炎", "score": 0.91}]


def test_factory_and_aliases():
    assert isinstance(create_llm("fake"), FakeLLM)
    assert create_llm("fake").device == "cuda" and jax_llms.create_llm("fake").device == "tpu"
    with pytest.raises(ValueError, match="Unsupported LLM type"):
        create_llm("mystery")
    backend = FakeVLMBackend()
    for alias in ("qwen3", "qwen3_vl", "qwen3_vl_8b_thinking", "qwen3_vl_2b_thinking"):
        llm = create_llm(alias, backend=backend)
        assert isinstance(llm, Qwen3LLM) and llm.backend is backend
    assert isinstance(create_llm("gpt4", api_key="k", client=object()), OpenAILLM)


def test_prompts_equal_jax():
    for include_image in (False, True):
        assert build_diagnosis_prompt(PATIENT, CASES, include_image) == \
            jax_reasoning.build_diagnosis_prompt(PATIENT, CASES, include_image)
        result = {"top_k": [{"label": "正常", "score": 0.8}]}
        assert build_review_prompt(PATIENT, result, include_image) == \
            jax_reasoning.build_review_prompt(PATIENT, result, include_image)
        assert build_treatment_prompt(PATIENT, "正常", include_image) == \
            jax_reasoning.build_treatment_prompt(PATIENT, "正常", include_image)
    prompt = build_diagnosis_prompt(PATIENT, retrieved_cases=CASES)
    assert "性别: 男" in prompt and "PJP肺炎" in prompt and "0.9100" in prompt
    assert '"diagnosis"' in prompt


@pytest.mark.parametrize("script", [
    ['前置说明```json\n{"diagnosis": "细菌性肺炎", "confidence": "高", '
     '"reasoning": "实变影", "key_findings": ["实变"]}\n```'],
    ["no json here"]])
def test_diagnose_equals_jax(script):
    got = ReasoningEvaluator(FakeLLM(script=script)).diagnose({"sex": "女", "age": "30"})
    want = jax_reasoning.ReasoningEvaluator(jax_llms.FakeLLM(script=script)).diagnose(
        {"sex": "女", "age": "30"})
    assert got == want and "raw_response" in got
    assert got["diagnosis"] in ("细菌性肺炎", "未知")


def test_review_and_treatment_equal_jax():
    script = ['{"final_diagnosis": "正常", "agreement_with_retrieval": "是"}',
              '{"diagnosis_confirmation": "正常", "treatment_plan": "随访"}', "garbage"]
    out = []
    for llms, reasoning in ((jax_llms, jax_reasoning), (None, None)):
        ev = (reasoning.ReasoningEvaluator(llms.FakeLLM(script=script)) if llms
              else ReasoningEvaluator(FakeLLM(script=script)))
        retrieval = {"top_k": [{"label": "正常", "score": 0.8}]}
        out.append([ev.review({"sex": "男"}, retrieval),
                    ev.suggest_treatment({"sex": "男"}, "正常"),
                    ev.review({"sex": "男"}, retrieval)])
    assert out[1] == out[0]
    assert out[1][0]["final_diagnosis"] == "正常" and out[1][1]["treatment_plan"] == "随访"
    assert out[1][2]["final_diagnosis"] == "未知"


@pytest.mark.parametrize("raw,expected", [
    ("病毒性肺炎", "病毒性肺炎"), ("Viral pneumonia", "病毒性肺炎"),
    ("细菌", "细菌性肺炎"), ("PJP", "pjp肺炎"),
    ("肺孢子菌肺炎", "pjp肺炎"), ("Normal chest", "正常"),
    ("别的", "别的"),
])
def test_label_normalization(raw, expected):
    assert ReasoningEvaluator(FakeLLM())._normalize_label(raw) == expected


def test_evaluate_accuracy():
    ev = ReasoningEvaluator(FakeLLM())
    preds = [{"diagnosis": "viral"}, {"final_diagnosis": "正常"}, {"diagnosis": "PJP"}]
    gts = ["病毒性肺炎", "正常", "细菌性肺炎"]
    assert ev.evaluate_accuracy(preds, gts) == {
        "accuracy": pytest.approx(2 / 3), "correct": 2, "total": 3}
    assert ev.evaluate_accuracy(preds, gts) == \
        jax_reasoning.ReasoningEvaluator(jax_llms.FakeLLM()).evaluate_accuracy(preds, gts)
    assert ev.evaluate_accuracy([], []) == {"accuracy": 0.0, "correct": 0, "total": 0}


def test_qwen3_llm_routes_to_the_backend_as_jax_does():
    out = {}
    for name, llm_cls, backend in (
            ("port", Qwen3LLM, FakeVLMBackend(script=["A", "B", "C"])),
            ("jax", jax_llms.Qwen3LLM, JaxFakeBackend(script=["A", "B", "C"]))):
        llm = llm_cls("fake", backend=backend)
        stream = llm.generate_stream(["p1", "p2", "p3"], temperature=0.0, n_slots=2,
                                     seeds=[10, 11, 12])
        batch = llm.generate_batch(["p1", "p2"], temperature=0.0)
        chat = llm.chat([{"role": "system", "content": "be brief"},
                         {"role": "user", "content": [{"type": "text", "text": "hi"}]}])
        out[name] = (stream, batch, chat, backend.stream_calls, backend.batch_calls)
    assert out["port"] == out["jax"]
    assert out["port"][0] == ["A", "B", "C"]
    assert out["port"][3] == [{"n": 3, "n_slots": 2, "temperatures": [0.0] * 3}]


def test_openai_llm_payload_structure():
    captured = {}

    class _Completions:
        def create(self, **kwargs):
            captured.update(kwargs)

            class _Msg:
                content = "ok"

            class _Choice:
                message = _Msg()

            class _Resp:
                choices = [_Choice()]

            return _Resp()

    class _Client:
        class chat:
            completions = _Completions()

    imgs = [Image.new("RGB", (8, 8), (255, 0, 0)), Image.new("RGB", (8, 8), (0, 255, 0))]
    llm = OpenAILLM(api_key="k", model="gpt-4o", client=_Client())
    assert llm.generate("describe", images=imgs, max_new_tokens=77, temperature=0.3,
                        top_p=0.5) == "ok"
    port = dict(captured)
    captured.clear()
    jax_llms.OpenAILLM(api_key="k", model="gpt-4o", client=_Client()).generate(
        "describe", images=imgs, max_new_tokens=77, temperature=0.3, top_p=0.5)
    assert port == captured
    assert (port["model"], port["max_tokens"], port["temperature"], port["top_p"]) == \
        ("gpt-4o", 77, 0.3, 0.5)
    (msg,) = port["messages"]
    content = msg["content"]
    assert msg["role"] == "user" and content[0] == {"type": "text", "text": "describe"}
    assert len(content) == 3
    for part in content[1:]:
        url = part["image_url"]["url"]
        assert part["type"] == "image_url" and url.startswith("data:image/png;base64,")
        png = base64.b64decode(url.split(",", 1)[1])
        assert Image.open(io.BytesIO(png)).size == (8, 8)
    if importlib.util.find_spec("openai") is None:      # imported lazily, only then
        with pytest.raises(ImportError, match="openai"):
            OpenAILLM(api_key="k")
