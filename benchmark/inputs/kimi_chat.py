"""A frozen copy of the Kimi-VL judge's chat text for a tokenizer without a
chat template (``emr2a_tpu_torch/judge/kimi_backend.py``) and of the word
tokenizer with Kimi-VL's special ids (``emr2a_tpu_torch/tools/
stub_tokenizer.py``'s ``KimiWordTokenizer``), so that a change to the
program cannot move what the benchmark feeds it or how it reads it back."""

from __future__ import annotations

import zlib
from typing import Optional

from benchmark.inputs.word_tokenizer import WordTokenizer

KIMI_SPECIAL = {"<|im_end|>": 163586, "<|im_user|>": 163587, "<|im_assistant|>": 163588,
                "<|im_system|>": 163594, "<|im_middle|>": 163601,
                "<|media_start|>": 163602, "<|media_content|>": 163603,
                "<|media_end|>": 163604, "<|media_pad|>": 163605}


class KimiWordTokenizer(WordTokenizer):
    eos_token_id = 163586

    def __call__(self, text, add_special_tokens=False, return_tensors=None, **kw):
        ids = [KIMI_SPECIAL.get(t) or 1000 + zlib.crc32(t.encode()) % 150000
               for t in self._split.findall(text)]
        if return_tensors == "np":
            import numpy as np
            return {"input_ids": np.asarray([ids], np.int64)}
        return {"input_ids": ids}

    def decode(self, ids, skip_special_tokens=True):
        special = set(KIMI_SPECIAL.values())
        return " ".join(f"w{i}" for i in ids if not (skip_special_tokens and i in special))


def render_chat(n_images: int, prompt: str, system: Optional[str]) -> str:
    sys_part = f"<|im_system|>system<|im_middle|>{system}<|im_end|>" if system else ""
    img = "<|media_start|>image<|media_content|><|media_pad|><|media_end|>" * n_images
    return (f"{sys_part}<|im_user|>user<|im_middle|>{img}{prompt}<|im_end|>"
            f"<|im_assistant|>assistant<|im_middle|>")
