"""A frozen copy of ``emr2a_tpu_torch/tools/stub_tokenizer.py``: a stub Qwen
tokenizer for runs without ``transformers`` or a checkpoint's tokenizer
files: Qwen's special tokens map
to their ids; every other word, digit or punctuation mark to an id in
[1000, 151000) by CRC32, so a prompt gets about as many tokens as Qwen's BPE
gives it; ``return_tensors="np"`` gives a (1, n) int64 array, as HF's
tokenizers do. Nothing is downloaded."""

from __future__ import annotations

import re
import zlib

QWEN_SPECIAL = {"<|im_start|>": 151644, "<|im_end|>": 151645,
                "<|vision_start|>": 151652, "<|vision_end|>": 151653,
                "<|image_pad|>": 151655}


class WordTokenizer:
    eos_token_id = 151645
    _split = re.compile(r"<\|[a-z_]+\|>|[A-Za-z]+|\d|[^\sA-Za-z\d]")

    def __call__(self, text, add_special_tokens=False, return_tensors=None, **kw):
        ids = [QWEN_SPECIAL.get(t) or 1000 + zlib.crc32(t.encode()) % 150000
               for t in self._split.findall(text)]
        if return_tensors == "np":
            import numpy as np
            return {"input_ids": np.asarray([ids], np.int64)}
        return {"input_ids": ids}

    def decode(self, ids, skip_special_tokens=True):
        special = set(QWEN_SPECIAL.values())
        return " ".join(f"w{i}" for i in ids if not (skip_special_tokens and i in special))
