"""The one traffic generator: a mix is a JSON file of parameters
(``traffic/<mix>.json``) and ``Schedule(mix, seed).unit(i)`` is unit i of
the closed loop, the same for the same seed. Every seed gives every block
of units the same multiset of sizes, in another order, so that a seed
changes which inputs come when and not how much work a run does.

Kinds (``mix["kind"]``):

- ``batches``: a pool of ``patients`` x ``slices_per_patient`` slices;
  unit i is the next ``batch`` indices of a run of seeded permutations of
  the pool. -> ``{"indices": [...]}``
- ``cases``: one retrieval case a unit: ``slices`` = [lo, hi] gives the
  block of sizes lo..hi, permuted per block; the case is that many
  consecutive slices of a seeded patient from a seeded start.
  -> ``{"patient": p, "start": s, "n": n}``
- ``audit``: a stream of audit cases in blocks of ``wave``: each block is
  a seeded permutation's next ``wave`` query patients of the pool of
  ``patients``, each with ``neighbors`` other patients (best first, with
  seeded similarities in [0.8, 0.99)) and an output budget from the block's
  ``wave`` budgets spaced evenly over ``budgets`` = [lo, hi], in an order
  that is the same for every seed (how a wave's budgets fall on its slots
  sets how long the wave takes); a unit is ``cases_per_unit`` cases.
  -> ``{"cases": [...]}``
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from benchmark.core.seeded import rng


class Schedule:
    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.seed = seed
        self._blocks: Dict[int, object] = {}

    def _block(self, tag: str, b: int, make):
        key = (tag, b)
        if key not in self._blocks:
            self._blocks[key] = make(rng(self.seed, f"{tag}:{b}"))
        return self._blocks[key]

    def unit(self, i: int) -> dict:
        kind = self.mix["kind"]
        if kind == "batches":
            return {"indices": self._batch(i)}
        if kind == "cases":
            return self._case(i)
        if kind == "audit":
            per = int(self.mix["cases_per_unit"])
            return {"cases": [self.audit_case(c) for c in range(i * per, (i + 1) * per)]}
        raise ValueError(f"unknown traffic kind {kind!r}")

    def _batch(self, i: int) -> List[int]:
        pool = int(self.mix["patients"]) * int(self.mix["slices_per_patient"])
        batch = int(self.mix["batch"])
        out = []
        for pos in range(i * batch, (i + 1) * batch):
            perm = self._block("batches", pos // pool, lambda r: r.permutation(pool))
            out.append(int(perm[pos % pool]))
        return out

    def _case(self, i: int) -> dict:
        lo, hi = (int(x) for x in self.mix["slices"])
        width = hi - lo + 1
        sizes = self._block("sizes", i // width, lambda r: lo + r.permutation(width))
        n = int(sizes[i % width])
        r = rng(self.seed, f"case:{i}")
        per = int(self.mix["slices_per_patient"])
        return {"patient": int(r.integers(int(self.mix["patients"]))),
                "start": int(r.integers(per - n + 1)), "n": n}

    def audit_case(self, c: int) -> dict:
        wave = int(self.mix["wave"])
        pool = int(self.mix["patients"])
        lo, hi = (int(x) for x in self.mix["budgets"])
        b, j = divmod(c, wave)

        patients = self._block("wave", b, lambda r: r.permutation(pool))
        budgets = np.rint(lo + (hi - lo) * np.arange(wave) / max(wave - 1, 1)).astype(int)
        budgets = rng(0, f"budgets:{b}").permutation(budgets)
        query = int(patients[j % pool])
        r = rng(self.seed, f"neighbors:{c}")
        others = [p for p in r.permutation(pool).tolist() if p != query]
        k = int(self.mix["neighbors"])
        sims = np.sort(r.uniform(0.8, 0.99, size=k))[::-1]
        return {"query": query, "neighbors": others[:k],
                "similarities": [float(s) for s in sims], "budget": int(budgets[j])}
