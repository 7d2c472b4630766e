"""Spans, probes and the device trace of a run.

- ``span(name)``: a host-clock span around a call into the program, kept
  for the whole window (``spans[name]``, seconds); while the profiler runs
  it is also a ``record_function`` range, so an idle gap on the device can
  be named by what the host was doing.
- Probes: a metric file may declare ``PROBE = (module, attribute,
  label)`` and ``shape(args, kwargs)``; while the profiler runs, the
  program's function is wrapped so that each call records its shape under
  ``calls[label]`` and runs inside a ``kernel:<label>`` range, which ties
  the kernels it launches to it (by the launch's correlation id).
- The device trace (``DeviceTrace``): every kernel, copy and set of the
  traced window, read from the profiler's raw events (no per-event
  Python objects of the profiler's own): busy seconds (the union of device
  intervals), device seconds by probe label and by kernel name, and the
  idle gaps named by the innermost host span around them.
"""

from __future__ import annotations

import bisect
import importlib
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch

WINDOW = "bench:window"
KERNEL_PREFIX = "kernel:"
_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
_SHORT_GAP_NS = 20_000


class Tracer:
    def __init__(self, probes=(), cuda: bool = True):
        self.cuda = cuda
        self.spans: Dict[str, List[float]] = defaultdict(list)
        self.calls: Dict[str, list] = defaultdict(list)
        self.probes = list(probes)       # (module, attribute, label, shape_fn)
        self.active = False
        self.device: Optional[DeviceTrace] = None
        self._prof = None
        self._window = None
        self._saved = []

    @contextmanager
    def span(self, name: str):
        rf = torch.profiler.record_function(name) if self.active else None
        if rf is not None:
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name].append(time.perf_counter() - t0)
            if rf is not None:
                rf.__exit__(None, None, None)

    def _install(self) -> None:
        for module_name, attr, label, shape_fn in self.probes:
            module = importlib.import_module(module_name)
            original = getattr(module, attr)

            def wrapped(*args, _f=original, _label=label, _shape=shape_fn, **kwargs):
                self.calls[_label].append(_shape(args, kwargs))
                with torch.profiler.record_function(KERNEL_PREFIX + _label):
                    return _f(*args, **kwargs)

            setattr(module, attr, wrapped)
            self._saved.append((module, attr, original))

    def _remove(self) -> None:
        for module, attr, original in reversed(self._saved):
            setattr(module, attr, original)
        self._saved = []

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.cuda:
            torch.cuda.synchronize()
            activities.append(ProfilerActivity.CUDA)
        self._install()
        self._prof = profile(activities=activities)
        self._prof.start()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()
        self.active = True

    def stop(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self._prof.stop()
        self.active = False
        self._remove()
        names = set(self.spans) | {KERNEL_PREFIX + p[2] for p in self.probes} | {WINDOW}
        self.device = DeviceTrace(self._prof.profiler.kineto_results.events(), names)
        self._prof = None


def _merge(intervals: list) -> list:
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _kind(e, annotations: set) -> str:
    """The profiler's activity type of a raw event; older PyTorch lacks
    ``activity_type``, so it is worked out from the device, the name (the
    runtime's and driver's calls start with ``cu``) and the tracer's own
    range names."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    cuda = "CUDA" in str(e.device_type())
    if name in annotations or (hasattr(e, "is_user_annotation") and e.is_user_annotation()):
        return "gpu_user_annotation" if cuda else "user_annotation"
    if cuda:
        return ("gpu_memcpy" if name.startswith("Memcpy") else
                "gpu_memset" if name.startswith("Memset") else "kernel")
    return "cuda_runtime" if name.startswith("cu") else "cpu_op"


def _span_ns(e) -> tuple:
    if hasattr(e, "start_ns"):
        s = e.start_ns()
        return s, s + e.duration_ns()
    s = int(e.start_us() * 1000)
    return s, s + int(e.duration_us() * 1000)


class DeviceTrace:
    """The traced window's device activity (times in ns, the profiler's
    clock). ``annotations`` names the tracer's own ranges."""

    def __init__(self, events, annotations: set = frozenset()):
        window = None
        ranges = []          # (start, end, name) of host ranges
        launches = []        # (start, correlation)
        device = []          # (start, end, kind, name, correlation)
        self.kinds: Dict[str, int] = defaultdict(int)
        for e in events:
            kind = _kind(e, annotations)
            self.kinds[kind] += 1
            if kind == "user_annotation":
                s, end = _span_ns(e)
                if e.name() == WINDOW:
                    window = (s, end)
                else:
                    ranges.append((s, end, e.name()))
            elif kind in _LAUNCH_KINDS:
                launches.append((_span_ns(e)[0], e.correlation_id()))
            elif kind in _DEVICE_KINDS:
                s, end = _span_ns(e)
                device.append((s, end, kind, e.name(), e.correlation_id()))
        annotations = ranges
        if window is None:
            raise RuntimeError("the trace holds no window range")
        lo, hi = window
        self.window_s = (hi - lo) / 1e9
        self.device = [d for d in device if d[1] > lo and d[0] < hi]
        busy = _merge([(max(s, lo), min(e, hi)) for s, e, *_ in self.device])
        self.busy_s = sum(e - s for s, e in busy) / 1e9

        # launches inside a kernel:<label> range -> that label, by correlation
        probes = sorted((s, e, n[len(KERNEL_PREFIX):]) for s, e, n in annotations
                        if n.startswith(KERNEL_PREFIX))
        starts = [p[0] for p in probes]
        label_of = {}
        for t, corr in launches:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and probes[i][0] <= t <= probes[i][1]:
                label_of[corr] = probes[i][2]
        self.by_label: Dict[str, float] = defaultdict(float)
        self.by_name: Dict[str, float] = defaultdict(float)
        self.copies: Dict[str, list] = defaultdict(list)
        for s, e, kind, name, corr in self.device:
            dur = (e - s) / 1e9
            self.by_name[name] += dur
            if corr in label_of:
                self.by_label[label_of[corr]] += dur
            if kind == "gpu_memcpy":
                self.copies[name].append(dur)

        # idle gaps, each named by the innermost host span over its middle
        spans = sorted((s, e, n) for s, e, n in annotations
                       if not n.startswith(KERNEL_PREFIX))
        self.idle: Dict[str, float] = defaultdict(float)
        edges = [lo] + [t for iv in busy for t in iv] + [hi]
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            if e - s < _SHORT_GAP_NS:
                self.idle["between launches (gaps under 20 us)"] += (e - s) / 1e9
                continue
            mid = (s + e) // 2
            inner = [sp for sp in spans if sp[0] <= mid <= sp[1]]
            name = min(inner, key=lambda sp: sp[1] - sp[0])[2] if inner else "outside any span"
            self.idle[name] += (e - s) / 1e9

    def kernel_seconds(self, label: str) -> float:
        return self.by_label.get(label, 0.0)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}
