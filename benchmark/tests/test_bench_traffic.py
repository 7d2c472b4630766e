"""The traffic generator: the same seed gives the same units; another seed
the same sizes in another order."""

from collections import Counter

from benchmark.core import registry
from benchmark.core.traffic import Schedule


def _units(mix, seed, n):
    s = Schedule(mix, seed)
    return [s.unit(i) for i in range(n)]


def test_deterministic_by_seed():
    for name in ("embed", "query", "audit", "audit-solo"):
        mix = registry.traffic(name)
        assert _units(mix, 2**31 + 3, 5) == _units(mix, 2**31 + 3, 5)
        assert _units(mix, 2**31 + 3, 5) != _units(mix, 2**31 + 4, 5)


def test_same_sizes_every_seed():
    query = registry.traffic("query")
    lo, hi = query["slices"]
    width = hi - lo + 1
    for seed in (1, 2**31 + 9):
        sizes = [u["n"] for u in _units(query, seed, width)]
        assert sorted(sizes) == list(range(lo, hi + 1))
    audit = registry.traffic("audit")
    budgets = [Counter(c["budget"] for c in _units(audit, seed, 1)[0]["cases"])
               for seed in (1, 7)]
    assert budgets[0] == budgets[1] and min(budgets[0]) == 32 and max(budgets[0]) == 160
    solo = registry.traffic("audit-solo")
    blocks = [Counter(u["cases"][0]["budget"] for u in _units(solo, seed, solo["wave"]))
              for seed in (1, 7)]
    assert blocks[0] == blocks[1] and min(blocks[0]) == 32 and max(blocks[0]) == 160
    assert solo["close_every"] == solo["wave"]


def test_batches_cover_the_pool():
    embed = registry.traffic("embed")
    pool = embed["patients"] * embed["slices_per_patient"]
    seen = [j for u in _units(embed, 5, pool // embed["batch"]) for j in u["indices"]]
    assert sorted(seen) == list(range(pool))


def test_audit_cases_are_well_formed():
    mix = registry.traffic("audit")
    for case in _units(mix, 11, 2)[1]["cases"]:
        assert case["query"] not in case["neighbors"]
        assert len(set(case["neighbors"])) == mix["neighbors"]
        assert case["similarities"] == sorted(case["similarities"], reverse=True)
