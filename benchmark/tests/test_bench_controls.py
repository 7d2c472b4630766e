"""The controls on the card, at each cell's own size: the program with the
configuration's ``control`` keys (its int8 path, and a bf16 database) must
come out not correct on three seeds; a sound run of the same seeds must
come out correct. Each run is its own process, as the benchmark's are.

    python -m pytest benchmark/tests -q -m card
"""

import json
import subprocess
import sys

import pytest

from bench_sizes import CELLS, REPO

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


def _run(module, workload, seed, seconds):
    proc = subprocess.run([sys.executable, "-m", module, "--workload", workload, "--seed",
                           str(seed), "--seconds", str(seconds), "--trace", "0"],
                          cwd=REPO, capture_output=True, text=True, timeout=1500)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(card, workload):
    for seed in SEEDS:
        out = _run("benchmark.tools.control", workload, seed, 5)
        assert out["correct"] is False, out["checks"]
