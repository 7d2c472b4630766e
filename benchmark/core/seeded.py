"""Everything a run makes from ``--seed``: independent streams by tag, and
weights drawn on the device in a few large calls.

A weight plan is a list of ``(name, shape, init)``; ``init`` is
``("normal", std)``, ``("around_one", std)`` (1 + N(0, std), for norm
scales) or ``("zeros",)``. ``draw`` puts every entry of one init into one
flat buffer drawn in chunks, in plan order, and returns views of it, so
the same plan, seed and device give the same tensors to the program and
to the reference.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

_CHUNK = 1 << 30   # elements a call


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for ``tag`` (any whole ``seed``)."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(derive(seed, tag))


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, tag))


def draw(plan: Sequence[Tuple[str, Tuple[int, ...], tuple]], seed: int, device,
         dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    groups: Dict[tuple, list] = {}
    for name, shape, init in plan:
        groups.setdefault(tuple(init), []).append((name, tuple(shape)))
    out: Dict[str, torch.Tensor] = {}
    for init, entries in groups.items():
        total = sum(int(np.prod(s)) for _, s in entries)
        flat = torch.empty(total, dtype=dtype, device=device)
        if init[0] == "zeros":
            flat.zero_()
        else:
            gen = generator(seed, f"weights:{init}", device)
            mean = 1.0 if init[0] == "around_one" else 0.0
            for lo in range(0, total, _CHUNK):
                flat[lo:lo + _CHUNK].normal_(mean, init[1], generator=gen)
        at = 0
        for name, shape in entries:
            n = int(np.prod(shape))
            out[name] = flat[at:at + n].view(shape)
            at += n
    return out

