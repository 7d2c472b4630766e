"""Each cell's whole harness path at test sizes on the CPU: set-up, the
window, the metrics' readers, the reference's judgement and the last
line; and after it, no JAX or JAX package module loaded."""

import json

import pytest

from bench_sizes import CELLS, run


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_rehearsal(workload, trace):
    from benchmark.core import registry
    from benchmark.core.harness import forbidden_modules, result_line

    out = run(workload, trace=trace)
    line = result_line(out)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    bench = registry.load_benchmark()
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
    else:
        want = {m["name"] for m in registry.metrics_of(bench, workload, "end_to_end")}
        assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    json.loads(json.dumps(line))
    assert forbidden_modules() == []


def test_forbidden_names_are_whole():
    import sys
    import types

    from benchmark.core.harness import forbidden_modules

    sys.modules["emr2a_tpu_torch_probe"] = types.ModuleType("emr2a_tpu_torch_probe")
    sys.modules["jaxlib_probe.x"] = types.ModuleType("jaxlib_probe.x")
    try:
        assert forbidden_modules() == []
        sys.modules["emr2a_tpu.probe"] = types.ModuleType("emr2a_tpu.probe")
        assert forbidden_modules() == ["emr2a_tpu.probe"]
    finally:
        for name in ("emr2a_tpu_torch_probe", "jaxlib_probe.x", "emr2a_tpu.probe"):
            sys.modules.pop(name, None)
