"""Deterministic scripted LLM for tests (port of ``emr2a_tpu/llms/fake.py``)."""

from __future__ import annotations

from typing import Dict, List, Optional, Union

from emr2a_tpu_torch.llms.base import BaseLLM


class FakeLLM(BaseLLM):

    def __init__(self, script: Optional[List[str]] = None, device: str = "cpu"):
        super().__init__(device)
        self.script = script or ['{"diagnosis": "正常", "confidence": "高"}']
        self.calls: List[dict] = []
        self._i = 0

    def _next(self) -> str:
        out = self.script[self._i % len(self.script)]
        self._i += 1
        return out

    def generate(self, prompt, images=None, max_new_tokens=512,
                 temperature=0.2, top_p=0.9, **kwargs) -> str:
        self.calls.append({"prompt": prompt,
                           "n_images": len(images) if images else 0})
        return self._next()

    def chat(self, messages: List[Dict[str, Union[str, List[Dict]]]],
             max_new_tokens=512, temperature=0.2, top_p=0.9, **kwargs) -> str:
        self.calls.append({"messages": messages})
        return self._next()
