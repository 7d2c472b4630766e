"""The port's ``utils/profiling`` against JAX's ``emr2a_tpu/utils/
profiling.py``: ``StageTimer``'s accounting, ``ThroughputMeter``'s rate and
a CPU ``trace_to`` whose Chrome trace names the annotated stage; and the
``utils`` package's re-exports."""

import json
import time

import numpy as np
import torch

from emr2a_tpu.utils.profiling import StageTimer as JaxStageTimer
from emr2a_tpu_torch.utils import (
    StageTimer,
    ThroughputMeter,
    annotate,
    compute_accuracy,
    concat_embeddings,
    l2_normalize,
    trace_to,
)


def test_stage_timer_matches_jax_accounting():
    timers = (StageTimer(), JaxStageTimer())
    for timer in timers:
        for name in ("decode", "encode", "decode"):
            with timer.stage(name):
                time.sleep(0.002)
        timer.log_summary()
    port, jax_ = (t.summary() for t in timers)
    assert sorted(port) == sorted(jax_) == ["decode", "encode"]
    for name in port:
        assert port[name]["calls"] == jax_[name]["calls"]
        assert set(port[name]) == set(jax_[name]) == {"total_s", "calls", "mean_s"}
        assert port[name]["total_s"] >= 0.002 * port[name]["calls"]
        np.testing.assert_allclose(port[name]["mean_s"],
                                   port[name]["total_s"] / port[name]["calls"], rtol=1e-12)


def test_stage_timer_counts_a_failing_stage():
    timer = StageTimer()
    try:
        with timer.stage("boom"):
            raise RuntimeError("x")
    except RuntimeError:
        pass
    assert timer.summary()["boom"]["calls"] == 1


def test_throughput_meter():
    meter = ThroughputMeter(unit="slices")
    assert meter.rate == 0.0
    meter.add(4, torch.ones(3))
    time.sleep(0.01)
    meter.add(6, torch.ones(3))
    meter.add(2)
    assert meter.n == 12 and meter.elapsed >= 0.01
    assert 0 < meter.rate <= 12 / 0.01
    meter.log()


def test_trace_to_writes_the_annotated_stage(tmp_path):
    timer = StageTimer()
    with trace_to(str(tmp_path / "trace")):
        with timer.stage("cnn_train_step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
        with annotate("extra_span"):
            torch.ones(8).sum()
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1, files
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert {"cnn_train_step", "extra_span"} <= names


def test_utils_reexports():
    assert compute_accuracy(["a", "b"], ["a", "c"]) == 0.5
    out = l2_normalize(torch.tensor([3.0, 4.0]))
    np.testing.assert_allclose(out.numpy(), [0.6, 0.8], rtol=1e-6)
    assert concat_embeddings(torch.ones(3), torch.ones(4)).shape == (7,)
