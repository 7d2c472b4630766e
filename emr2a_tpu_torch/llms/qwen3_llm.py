"""Qwen3-VL chat LLM on the port's judge backend.

Port of ``emr2a_tpu/llms/qwen3_llm.py``: chat-template messages with
inline images, temperature > 0 toggles sampling, the generate /
generate_batch / generate_stream / chat surface. Generation runs through
the port's ``judge/qwen_backend.QwenVLBackend`` (``judge/backends.
load_backend``), to which ``precision`` (int4_awq included),
``kv_dtype``, ``draft_model_path`` and ``prefill_chunk`` pass straight.
``device`` defaults to ``cuda``.
"""

from __future__ import annotations

from typing import Dict, List, Union

from emr2a_tpu_torch.llms.base import BaseLLM


class Qwen3LLM(BaseLLM):

    def __init__(self, model_path: str, device: str = "cuda",
                 dtype: str = "bfloat16", backend=None,
                 precision: str = "bf16", kv_dtype: str = "bf16",
                 draft_model_path: str = None,
                 prefill_chunk: int = None):
        """The serving knobs mirror the judge backend's: ``precision``
        (bf16/int8/int4 decoder weights), ``kv_dtype`` (int8 halves KV
        residency/stream), ``draft_model_path`` (lossless greedy
        speculative decoding), ``prefill_chunk`` (sequence-chunked
        prompt prefill for long buckets / large batches — see
        judge/qwen_backend.py)."""
        super().__init__(device)
        self.model_path = model_path
        self.dtype = dtype
        if backend is None:
            from emr2a_tpu_torch.judge.backends import load_backend
            backend = load_backend(model_path, device, precision=precision,
                                   kv_dtype=kv_dtype,
                                   draft_model_path=draft_model_path,
                                   prefill_chunk=prefill_chunk)
        if backend is None:
            raise RuntimeError(f"Failed to load Qwen3-VL from {model_path}")
        self.backend = backend

    def _gen_kwargs(self, max_new_tokens, temperature, top_p):
        kwargs = dict(max_new_tokens=max_new_tokens, temperature=temperature)
        try:  # backends without nucleus sampling (e.g. the fake) omit it
            import inspect
            if "top_p" in inspect.signature(self.backend.generate).parameters:
                kwargs["top_p"] = top_p
        except (TypeError, ValueError):
            pass
        return kwargs

    def generate(self, prompt, images=None, max_new_tokens=512,
                 temperature=0.2, top_p=0.9, **kwargs) -> str:
        return self.backend.generate(
            images or [], prompt,
            **self._gen_kwargs(max_new_tokens, temperature, top_p))

    def generate_batch(self, prompts, images_list=None, max_new_tokens=512,
                       temperature=0.2, top_p=0.9, **kwargs):
        """One prefill+decode for the whole batch when the backend
        supports it (qwen_backend.generate_batch — decode is weight-
        bandwidth-bound, so N prompts cost ~1x decode wall time); the
        reference loops singles (llms/qwen3_llm.py:60-81)."""
        if hasattr(self.backend, "generate_batch") and prompts:
            requests = [
                {"images": images_list[i] if images_list else [],
                 "prompt": p}
                for i, p in enumerate(prompts)]
            return self.backend.generate_batch(
                requests, max_new_tokens=max_new_tokens,
                temperature=temperature, top_p=top_p)
        return super().generate_batch(prompts, images_list, max_new_tokens,
                                      temperature, top_p, **kwargs)

    def generate_stream(self, prompts, images_list=None, max_new_tokens=512,
                        temperature=0.2, top_p=0.9, n_slots=8, seeds=None):
        """Continuous-batching variant of ``generate_batch``: prompts
        stream through decode slots (finished slots refill from the
        queue), so a batch of mixed output lengths is never held
        hostage by its slowest row.  ``seeds`` optionally gives each
        sampled prompt a deterministic per-request seed.  Falls back to
        ``generate_batch`` for backends without ``generate_stream``."""
        if hasattr(self.backend, "generate_stream") and prompts:
            requests = [
                {"images": images_list[i] if images_list else [],
                 "prompt": p,
                 **({"seed": seeds[i]} if seeds else {})}
                for i, p in enumerate(prompts)]
            return self.backend.generate_stream(
                requests, max_new_tokens=max_new_tokens, n_slots=n_slots,
                temperature=temperature, top_p=top_p)
        return self.generate_batch(prompts, images_list, max_new_tokens,
                                   temperature, top_p)

    @staticmethod
    def _text_of(content) -> str:
        if isinstance(content, str):
            return content
        return " ".join(item.get("text", "") for item in content or []
                        if isinstance(item, dict) and item.get("type") == "text")

    def chat(self, messages: List[Dict[str, Union[str, List[Dict]]]],
             max_new_tokens=512, temperature=0.2, top_p=0.9, **kwargs) -> str:
        """Flatten chat messages into (images, prompt, system) for the
        backend, preserving role structure for multi-turn histories;
        the backend applies the model's chat template for the final
        user turn."""
        system = None
        images: List = []
        turns: List[str] = []
        for msg in messages:
            role = msg.get("role")
            content = msg.get("content")
            if role == "system":
                system = self._text_of(content)
                continue
            if not isinstance(content, str):
                for item in content or []:
                    if isinstance(item, dict) and item.get("type") == "image":
                        images.append(item.get("image"))
            text = self._text_of(content)
            if role == "assistant":
                turns.append(f"Assistant: {text}")
            elif turns:  # later user turns keep their role marker
                turns.append(f"User: {text}")
            else:
                turns.append(text)
        return self.backend.generate(
            images, "\n".join(turns), system=system,
            **self._gen_kwargs(max_new_tokens, temperature, top_p))
