"""LLM factory (port of ``emr2a_tpu/llms/factory.py``), with its alias
surface: the Qwen3-VL names, ``openai`` / ``gpt4`` and ``fake``."""

from __future__ import annotations

from typing import Optional

from emr2a_tpu_torch.llms.base import BaseLLM
from emr2a_tpu_torch.llms.fake import FakeLLM
from emr2a_tpu_torch.llms.openai_llm import OpenAILLM
from emr2a_tpu_torch.llms.qwen3_llm import Qwen3LLM

_QWEN_ALIASES = ("qwen3", "qwen3_vl", "qwen3_vl_8b_thinking",
                 "qwen3_vl_2b_thinking")


def create_llm(llm_type: str, device: str = "cuda",
               model_path: Optional[str] = None,
               api_key: Optional[str] = None,
               model_name: Optional[str] = None, **kwargs) -> BaseLLM:
    lt = llm_type.lower()

    if lt == "fake":
        return FakeLLM(script=kwargs.get("script"), device=device)

    if lt in _QWEN_ALIASES:
        if lt == "qwen3_vl_8b_thinking":
            default = kwargs.get("qwen3_vl_8b_thinking_config", {}).get("model_path")
        elif lt == "qwen3_vl_2b_thinking":
            default = kwargs.get("qwen3_vl_2b_thinking_config", {}).get("model_path")
        else:
            default = kwargs.get("qwen3_config", {}).get("model_path")
        return Qwen3LLM(model_path=model_path or default, device=device,
                        dtype=kwargs.get("dtype", "bfloat16"),
                        backend=kwargs.get("backend"),
                        precision=kwargs.get("precision", "bf16"),
                        kv_dtype=kwargs.get("kv_dtype", "bf16"),
                        draft_model_path=kwargs.get("draft_model_path"))

    if lt in ("openai", "gpt4"):
        return OpenAILLM(
            api_key=api_key or kwargs.get("openai_config", {}).get("api_key"),
            model=model_name or kwargs.get("openai_config", {}).get(
                "model", "gpt-4-vision-preview"),
            device=device, client=kwargs.get("client"))

    raise ValueError(
        f"Unsupported LLM type: {llm_type}. "
        f"Supported types: {list(_QWEN_ALIASES) + ['openai', 'gpt4', 'fake']}")
