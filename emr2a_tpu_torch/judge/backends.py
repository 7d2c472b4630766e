"""VLM generation backends for the judge layer.

Port of ``emr2a_tpu/judge/backends.py``: the ``VLMBackend`` protocol, the
canned-output ``FakeVLMBackend`` for tests and dry runs (with the batched
and continuous protocols of the production backend, recording their
calls), and ``load_backend``.

One divergence: a Qwen backend that fails to load **raises** here. The JAX
package logs the error and returns None, after which every audit case
quietly abstains; on the card that would hide a kernel that failed to
build.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Protocol, Sequence

logger = logging.getLogger(__name__)


class VLMBackend(Protocol):
    def generate(self, images: Sequence, prompt: str,
                 system: Optional[str] = None, max_new_tokens: int = 1024,
                 temperature: float = 0.0) -> str:
        """images: PIL images (query slices + neighbour evidence); returns
        the raw decoded model output."""
        ...


class FakeVLMBackend:
    """Deterministic canned-output backend for tests and dry runs.

    ``script`` is a list of raw output strings returned in order (cycled);
    ``fn`` may instead compute the output from the prompt."""

    def __init__(self, script: Optional[List[str]] = None, fn=None):
        self.script = script or [
            '{"decision": "accept", "confidence": 0.9,'
            ' "cited_neighbors": [1], "rationale": "consistent"}']
        self.fn = fn
        self.calls: List[dict] = []
        self._i = 0

    def generate(self, images, prompt, system=None, max_new_tokens=1024,
                 temperature=0.0) -> str:
        self.calls.append({"n_images": len(list(images)), "prompt": prompt,
                           "system": system, "temperature": temperature})
        if self.fn is not None:
            return self.fn(images, prompt)
        out = self.script[self._i % len(self.script)]
        self._i += 1
        return out

    def generate_batch(self, requests, max_new_tokens=1024, temperature=0.0,
                       top_p=0.9):
        """The production backend's batched protocol; records each batch's
        size in ``batch_calls``."""
        self.batch_calls = getattr(self, "batch_calls", [])
        self.batch_calls.append(len(requests))
        return [self.generate(r["images"], r["prompt"], r.get("system"),
                              max_new_tokens, temperature)
                for r in requests]

    def generate_stream(self, requests, max_new_tokens=1024, n_slots=8,
                        temperature=0.0, top_p=0.9):
        """The production backend's continuous-serving protocol; records
        each call's request count, slot count and per-request temperatures
        in ``stream_calls``."""
        self.stream_calls = getattr(self, "stream_calls", [])
        self.stream_calls.append({
            "n": len(requests), "n_slots": n_slots,
            "temperatures": [float(r.get("temperature", temperature) or 0.0)
                             for r in requests]})
        return [self.generate(r["images"], r["prompt"], r.get("system"),
                              max_new_tokens, r.get("temperature", temperature))
                for r in requests]


def load_backend(model_path: Optional[str], device: str = "cuda",
                 precision: str = "bf16", kv_dtype: str = "bf16",
                 draft_model_path: Optional[str] = None, spec_k: int = 4,
                 prefill_chunk: Optional[int] = None,
                 tp: int = 1) -> Optional[VLMBackend]:
    """A generation backend for a model path: ``fake`` / ``fake:...`` ->
    ``FakeVLMBackend``; a Qwen3-VL checkpoint directory -> ``QwenVLBackend``
    (errors propagate); None -> None (callers abstain, with a warning)."""
    if model_path is None:
        logger.warning("No VLM model path provided")
        return None
    mp = str(model_path)
    if mp == "fake" or mp.startswith("fake:"):
        return FakeVLMBackend()
    from emr2a_tpu_torch.judge.qwen_backend import QwenVLBackend
    return QwenVLBackend(mp, device=device, precision=precision,
                         kv_dtype=kv_dtype, draft_model_path=draft_model_path,
                         spec_k=spec_k, prefill_chunk=prefill_chunk, tp=tp)
