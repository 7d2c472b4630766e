"""Stub tokenizers for runs without ``transformers`` or a checkpoint's
tokenizer files (the card's machine has neither): the model's special
tokens map to their ids (Qwen's for ``WordTokenizer``, Kimi-VL's for
``KimiWordTokenizer``); every other word, digit or punctuation mark to an
id in [1000, 151000) by CRC32, so a prompt gets about as many tokens as a
BPE gives it; ``return_tensors="np"`` gives a (1, n) int64 array, as HF's
tokenizers do. Nothing is downloaded."""

from __future__ import annotations

import re
import zlib

QWEN_SPECIAL = {"<|im_start|>": 151644, "<|im_end|>": 151645,
                "<|vision_start|>": 151652, "<|vision_end|>": 151653,
                "<|image_pad|>": 151655}
# Kimi-VL's chat and media markers (its tokenizer's ids; ``<|media_pad|>``
# is the config's ``media_placeholder_token_id``)
KIMI_SPECIAL = {"<|im_end|>": 163586, "<|im_user|>": 163587, "<|im_assistant|>": 163588,
                "<|im_system|>": 163594, "<|im_middle|>": 163601,
                "<|media_start|>": 163602, "<|media_content|>": 163603,
                "<|media_end|>": 163604, "<|media_pad|>": 163605}


class WordTokenizer:
    eos_token_id = 151645
    special = QWEN_SPECIAL
    _split = re.compile(r"<\|[a-z_]+\|>|[A-Za-z]+|\d|[^\sA-Za-z\d]")

    def __call__(self, text, add_special_tokens=False, return_tensors=None, **kw):
        ids = [self.special.get(t) or 1000 + zlib.crc32(t.encode()) % 150000
               for t in self._split.findall(text)]
        if return_tensors == "np":
            import numpy as np
            return {"input_ids": np.asarray([ids], np.int64)}
        return {"input_ids": ids}

    def decode(self, ids, skip_special_tokens=True):
        special = set(self.special.values())
        return " ".join(f"w{i}" for i in ids if not (skip_special_tokens and i in special))


class KimiWordTokenizer(WordTokenizer):
    eos_token_id = 163586
    special = KIMI_SPECIAL
