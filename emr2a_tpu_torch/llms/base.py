"""LLM interface (port of ``emr2a_tpu/llms/base.py``): generate /
generate_batch / chat; ``device`` defaults to ``cuda``."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List, Optional, Union


class BaseLLM(ABC):

    def __init__(self, device: str = "cuda"):
        self.device = device

    @abstractmethod
    def generate(self, prompt: str, images: Optional[List] = None,
                 max_new_tokens: int = 512, temperature: float = 0.2,
                 top_p: float = 0.9, **kwargs) -> str:
        ...

    def generate_batch(self, prompts: List[str],
                       images_list: Optional[List[List]] = None,
                       max_new_tokens: int = 512, temperature: float = 0.2,
                       top_p: float = 0.9, **kwargs) -> List[str]:
        """Default sequential batch (the reference's batch paths loop
        singles too, qwen3_llm.py:60-81)."""
        return [self.generate(
                    p, images_list[i] if images_list else None,
                    max_new_tokens, temperature, top_p, **kwargs)
                for i, p in enumerate(prompts)]

    @abstractmethod
    def chat(self, messages: List[Dict[str, Union[str, List[Dict]]]],
             max_new_tokens: int = 512, temperature: float = 0.2,
             top_p: float = 0.9, **kwargs) -> str:
        ...

    def to(self, device: str):
        self.device = device
        return self
