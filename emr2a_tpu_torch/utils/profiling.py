"""Tracing and per-stage timing.

Port of ``emr2a_tpu/utils/profiling.py``:

- ``annotate``: a ``torch.profiler.record_function`` range around a
  pipeline stage (a named span in a ``trace_to`` capture; JAX's is a
  ``jax.profiler.TraceAnnotation``).
- ``trace_to``: context manager capturing a ``torch.profiler`` trace of the
  enclosed block (host activity, and the card's where CUDA is available)
  into ``log_dir`` as a Chrome trace (``<worker>.<ms>.pt.trace.json``,
  which TensorBoard's profiler plugin reads).
- ``StageTimer``: wall-clock per-stage accounting with a log summary.
- ``ThroughputMeter``: items/sec counter that waits for the device work
  behind a result, so the asynchronous launch queue cannot inflate the
  rate: ``add(n, tensor)`` synchronizes the tensor's CUDA device (JAX's
  calls ``block_until_ready``).
"""

from __future__ import annotations

import contextlib
import logging
import time
from pathlib import Path
from typing import Dict, Optional

import torch

logger = logging.getLogger(__name__)


def annotate(name: str):
    """A named span in the profiler's trace (no cost when no profiler is
    recording beyond the range's host bookkeeping)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Capture a profiler trace for the enclosed block into ``log_dir``;
    yields the ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    Path(log_dir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
        yield prof


class StageTimer:

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        with annotate(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                self.totals[name] = self.totals.get(name, 0.0) + dt
                self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {name: {"total_s": total,
                       "calls": self.counts[name],
                       "mean_s": total / self.counts[name]}
                for name, total in self.totals.items()}

    def log_summary(self, heading: str = "stage timing") -> None:
        logger.info("%s:", heading)
        for name, s in sorted(self.summary().items(),
                              key=lambda kv: -kv[1]["total_s"]):
            logger.info("  %-24s %8.3f s  (%d calls, %.4f s/call)",
                        name, s["total_s"], s["calls"], s["mean_s"])


class ThroughputMeter:
    """items/sec over device work; ``add`` waits for the result's device so
    the asynchronous launch queue can't inflate the rate."""

    def __init__(self, unit: str = "items"):
        self.unit = unit
        self.n = 0
        self.t0: Optional[float] = None
        self.elapsed = 0.0

    def add(self, n_items: int, device_result=None) -> None:
        if self.t0 is None:
            self.t0 = time.perf_counter()
        if isinstance(device_result, torch.Tensor) and device_result.is_cuda:
            torch.cuda.synchronize(device_result.device)
        self.n += n_items
        self.elapsed = time.perf_counter() - self.t0

    @property
    def rate(self) -> float:
        return self.n / self.elapsed if self.elapsed > 0 else 0.0

    def log(self) -> None:
        logger.info("throughput: %.1f %s/sec (%d %s in %.2f s)",
                    self.rate, self.unit, self.n, self.unit, self.elapsed)
