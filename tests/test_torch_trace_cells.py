"""Each benchmark cell at its rehearsal size (``benchmark/tests/
bench_sizes.py``) with ``--trace 1``, on the CPU, reading the program's
own spans and counters:

- the per-layer metrics that read the program's host spans and counters
  come back as floats, and those that read device events are left out;
- with the CPU's operations standing in for the device's (the device
  trace's activity kinds widened to ``cpu_op``), the host's gaps between
  them are named by the program's spans, not by the benchmark's own spans
  around its calls (``serve``, ``prepare``, ``encode_batch_images``,
  ``search``);
- a program without the tracer (``snapshot`` taken away, as at a commit
  from before it) runs each cell to a correct line without those metrics.
"""

import importlib.util
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

HOST_READ = {
    "qwen3-vl-8b.audit": ("prepare_ms.audit", "decode_use_pct.audit"),
    "qwen3-vl-8b.audit-solo": ("prepare_ms.audit", "decode_use_pct.audit"),
    "biomedclip.embed": ("encode_host_ms.embed",),
    "biomedclip.query": ("encode_host_ms.query", "search_host_ms.query"),
}
DEVICE_READ = ("prefill_mfu.audit", "decode_step_ms.audit", "tower_ms.query")
NEW = {name for names in HOST_READ.values() for name in names} | set(DEVICE_READ) | {
    "serving_idle_pct.audit"}
BENCHMARK_SPANS = ("serve", "prepare", "encode_batch_images", "search")
# the benchmark's numpy case mean, the harness's loop and gaps too short to name
UNNAMED = ("case_mean", "outside any span", "between launches (gaps under 20 us)")


def bench_sizes():
    spec = importlib.util.spec_from_file_location(
        "bench_sizes", REPO / "benchmark" / "tests" / "bench_sizes.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("workload", sorted(HOST_READ))
def test_traced_cell_reads_the_program(workload, monkeypatch):
    from benchmark.core import trace

    monkeypatch.setattr(trace, "_DEVICE_KINDS", trace._DEVICE_KINDS + ("cpu_op",))
    out = bench_sizes().run(workload, trace=1)
    assert out["correct"], out["checks"]
    metrics = out["metrics"]
    for name in HOST_READ[workload]:
        assert isinstance(metrics[name]["value"], float), name
    assert not set(DEVICE_READ) & set(metrics)
    idle = dict(out["breakdown"]["idle_gaps"])
    named = {n: s for n, s in idle.items() if n not in UNNAMED}
    ours = sum(s for n, s in named.items() if n in BENCHMARK_SPANS)
    assert named and ours < 0.1 * sum(named.values()), idle


@pytest.mark.parametrize("workload", sorted(HOST_READ))
def test_traced_cell_without_the_tracer(workload, monkeypatch):
    from emr2a_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "snapshot")
    out = bench_sizes().run(workload, trace=1)
    assert out["correct"], out["checks"]
    assert not NEW & set(out["metrics"])
    assert out["metrics"]
