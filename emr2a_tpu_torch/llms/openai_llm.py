"""OpenAI chat LLM, a host client (port of ``emr2a_tpu/llms/openai_llm.py``):
base64-PNG image payloads, sequential batch. ``openai`` is imported only
when no ``client`` is given."""

from __future__ import annotations

import base64
import io
from typing import Dict, List, Union

from emr2a_tpu_torch.llms.base import BaseLLM


def _image_to_data_url(img) -> str:
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


class OpenAILLM(BaseLLM):

    def __init__(self, api_key: str, model: str = "gpt-4-vision-preview",
                 device: str = "cpu", client=None):
        super().__init__(device)
        self.api_key = api_key
        self.model = model
        if client is not None:
            self.client = client
        else:
            try:
                import openai
                self.client = openai.OpenAI(api_key=api_key)
            except ImportError as e:
                raise ImportError(
                    "openai is required for OpenAI LLM. "
                    "Install with: pip install openai") from e

    def generate(self, prompt, images=None, max_new_tokens=512,
                 temperature=0.2, top_p=0.9, **kwargs) -> str:
        content: List[Dict] = [{"type": "text", "text": prompt}]
        for img in images or []:
            content.append({"type": "image_url",
                            "image_url": {"url": _image_to_data_url(img)}})
        return self.chat([{"role": "user", "content": content}],
                         max_new_tokens, temperature, top_p, **kwargs)

    def chat(self, messages: List[Dict[str, Union[str, List[Dict]]]],
             max_new_tokens=512, temperature=0.2, top_p=0.9, **kwargs) -> str:
        response = self.client.chat.completions.create(
            model=self.model, messages=messages,
            max_tokens=max_new_tokens, temperature=temperature, top_p=top_p)
        return response.choices[0].message.content
