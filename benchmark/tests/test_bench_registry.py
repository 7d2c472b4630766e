"""A cell, a configuration and a metric added as files and entries alone,
with no edit to a file that is there, are found and run."""

import json
import shutil
import time

from bench_sizes import BIOMEDCLIP, MIX, REPO


def test_added_cell_config_and_metric(tmp_path):
    from benchmark.core import registry
    from benchmark.core.harness import build_context, run_cell

    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    b = tmp_path / "benchmark"
    # a configuration: its file and its reference
    cfg = json.loads((b / "configs" / "biomedclip.json").read_text())
    cfg["database"]["cases"] = 3000
    (b / "configs" / "biomedclip-small-db.json").write_text(json.dumps(cfg))
    shutil.copy(b / "reference" / "biomedclip.py", b / "reference" / "biomedclip-small-db.py")
    bench["configs"].append({"name": "biomedclip-small-db", "source": "https://example.org/x",
                             "file": "benchmark/configs/biomedclip-small-db.json",
                             "reduced": [], "why": "a test's configuration"})
    # a cell on an existing traffic mix, with its limits
    bench["workloads"].append({"name": "biomedclip-small-db.query", "config": "biomedclip-small-db",
                               "traffic": "query", "chips": 1, "why": "a test's cell"})
    (b / "cells" / "biomedclip-small-db.query.json").write_text(
        (b / "cells" / "biomedclip.query.json").read_text())
    # a per-layer metric, with its own reader
    bench["per_layer"].append({"name": "case_mean_ms.query", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "encode engine",
                               "moves": "query_p95_ms",
                               "workloads": ["biomedclip.query", "biomedclip-small-db.query"]})
    (b / "metrics" / "case_mean_ms.query.py").write_text(
        "from benchmark.core.readers import span_median_ms\n\n\n"
        "def read(run):\n    return span_median_ms(run, 'case_mean')\n")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    loaded = registry.load_benchmark(tmp_path)
    assert registry.config(loaded, "biomedclip-small-db", tmp_path)["database"]["cases"] == 3000
    assert registry.cell("biomedclip-small-db.query", tmp_path)["limits"]
    names = [m["name"] for m in registry.metrics_of(loaded, "biomedclip-small-db.query",
                                                    "per_layer")]
    assert "case_mean_ms.query" in names
    assert registry.metric("case_mean_ms.query", tmp_path).read is not None

    from types import SimpleNamespace
    args = SimpleNamespace(workload="biomedclip-small-db.query", seed=3, seconds=0.3, trace=1)
    small = dict(BIOMEDCLIP, database=dict(BIOMEDCLIP["database"], cases=3000))
    ctx = build_context(args, tmp_path, "cpu", small, MIX["biomedclip.query"])
    out = run_cell(ctx, 0.3, time.perf_counter())
    assert out["correct"] and "case_mean_ms.query" in out["metrics"]
