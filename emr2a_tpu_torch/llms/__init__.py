from emr2a_tpu_torch.llms.base import BaseLLM
from emr2a_tpu_torch.llms.fake import FakeLLM
from emr2a_tpu_torch.llms.factory import create_llm
from emr2a_tpu_torch.llms.openai_llm import OpenAILLM
from emr2a_tpu_torch.llms.qwen3_llm import Qwen3LLM

__all__ = ["BaseLLM", "FakeLLM", "create_llm", "OpenAILLM", "Qwen3LLM"]
