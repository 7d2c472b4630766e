"""Tracing and per-stage timing.

Port of ``emr2a_tpu/utils/profiling.py``, with the port's own tracer:

- ``annotate(name, request=None, device=None)``: the program's span. While
  no ``torch.profiler`` session records (the profiler's own flag,
  ``torch.autograd.profiler._is_profiler_enabled``), it reads that flag and
  returns one shared no-op context: no profiler range, no clock, no
  allocation. While one records, a span opens a ``record_function`` range
  of its name (so the profiler's trace, and an idle gap on the device,
  carry the program's stage; JAX's is a ``jax.profiler.TraceAnnotation``)
  and keeps, in memory, its name, its start and end on the profiler's clock
  (Unix-epoch ns, ``time.time_ns``), the span open around it on the same
  thread (its parent) and ``request`` (a request's id, or a tuple of them,
  shared by the spans of one request). ``device`` (the ``torch.device``
  the span's work runs on) also records a pair of timing CUDA events on
  that device's current stream, where it is a CUDA device (an encoder or
  database on a mesh runs on several); ``snapshot`` resolves them to
  ``device_ms``, the stream's time between them, which counts the stream's
  own idle time inside the span too (None on the CPU). The hot path is
  never synchronised.
- ``count(name, n=1)``: adds ``n`` to a counter while a profiler records
  (and returns at once while none does).
- ``register_tally(tally, read)``: counters that the device keeps itself
  in the tensor ``tally`` (a kernel adds to it, also inside a replayed
  CUDA graph, where no Python runs). It is zeroed when a session's store
  starts and copied when the profiler stops, both enqueued on the device
  without a wait, and ``read(copy)``'s ``{name: int}`` is added to the
  counters when ``snapshot`` reads the session: no step waits on it, and
  work after the session does not count.
- ``snapshot()``: the spans and counters of the latest profiler session.
  The store keeps one session: the first span or count of a new session
  clears what an earlier one left, so a profiled window holds exactly its
  own work. ``snapshot`` waits for the device events it resolves, so call
  it after the work it reads.
- ``trace_to``: context manager capturing a ``torch.profiler`` trace of the
  enclosed block (host activity, and the card's where CUDA is available)
  into ``log_dir`` as a Chrome trace (``<worker>.<ms>.pt.trace.json``,
  which TensorBoard's profiler plugin reads), and beside it ``spans.json``:
  ``snapshot()`` plus ``launches``, the increments of the kernel wrappers'
  ``*LAUNCHES`` counters and of ``cuda_graph.CAPTURES`` over the capture.
- ``StageTimer``: wall-clock per-stage accounting with a log summary; each
  stage is also a span.
- ``ThroughputMeter``: items/sec counter that waits for the device work
  behind a result, so the asynchronous launch queue cannot inflate the
  rate: ``add(n, tensor)`` synchronizes the tensor's CUDA device (JAX's
  calls ``block_until_ready``).

The store is the process's, as the profiler is: spans from any thread go
into it, each thread with its own parents.
"""

from __future__ import annotations

import contextlib
import json
import logging
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch
import torch.autograd.profiler as _profiler

logger = logging.getLogger(__name__)

_OFF = contextlib.nullcontext()


def _session_hook():
    """The profiler's start hook, wrapped once per process to count the
    sessions started (the profiler exposes no session of its own); None
    where this PyTorch has no such hook, and then the store is never
    cleared."""
    start = getattr(_profiler, "_run_on_profiler_start", None)
    if start is None or hasattr(start, "sessions"):
        return start

    def counted():
        counted.sessions += 1
        start()

    counted.sessions = 0
    _profiler._run_on_profiler_start = counted
    return counted


def _stop_hook() -> None:
    """The profiler's stop hook, wrapped once per process to copy the
    device-side tallies as the session ends."""
    stop = getattr(_profiler, "_run_on_profiler_stop", None)
    if stop is None or hasattr(stop, "tallies"):
        return

    def frozen():
        for t in _tallies:
            t[2] = t[0].clone()
        stop()

    frozen.tallies = True
    _profiler._run_on_profiler_stop = frozen


_HOOK = _session_hook()


class _Store:
    """One profiler session's spans (in the order they opened) and
    counters."""

    def __init__(self, session: int):
        self.session = session
        self.spans: list = []
        self.counters: Dict[str, int] = {}


_store = _Store(-1)
_lock = threading.Lock()
_local = threading.local()
_tallies: list = []     # [tally, read, its copy at the session's end]


def register_tally(tally: torch.Tensor, read) -> None:
    """Device-side counters (see the module docstring)."""
    _stop_hook()
    _tallies.append([tally, read, None])


def _current() -> _Store:
    """The store of the latest session, emptied at its first use (the
    device-side tallies are reset then too)."""
    global _store
    session = _HOOK.sessions if _HOOK is not None else 0
    with _lock:
        if _store.session == session:
            return _store
        _store = _Store(session)
        store = _store
    for t in list(_tallies):
        t[0].zero_()
        t[2] = None
    return store


def _stream(device):
    """The current CUDA stream of ``device``, or None where it is no CUDA
    device."""
    device = torch.device(device)
    return torch.cuda.current_stream(device) if device.type == "cuda" else None


class _Record:
    __slots__ = ("name", "start_ns", "end_ns", "parent", "request", "events",
                 "device_ms", "session", "index")


class _Span:
    __slots__ = ("name", "request", "device", "record", "range", "stream")

    def __init__(self, name: str, request, device):
        self.name, self.request, self.device = name, request, device

    def __enter__(self):
        store = _current()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        r = self.record = _Record()
        top = stack[-1] if stack else None
        r.name, r.request, r.session = self.name, self.request, store.session
        r.parent = top.index if top is not None and top.session == store.session else None
        r.end_ns = r.events = r.device_ms = None
        with _lock:
            r.index = len(store.spans)
            store.spans.append(r)
        r.start_ns = time.time_ns()
        self.range = _profiler.record_function(self.name)
        self.range.__enter__()
        self.stream = None if self.device is None else _stream(self.device)
        if self.stream is not None:
            r.events = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            r.events[0].record(self.stream)
        stack.append(r)
        return self

    def __exit__(self, *exc):
        r = self.record
        if r.events is not None:
            r.events[1].record(self.stream)
        _local.stack.pop()
        self.range.__exit__(*exc)
        r.end_ns = time.time_ns()
        return False


def annotate(name: str, request=None, device=None):
    """The program's span named ``name`` (see the module docstring): a
    shared no-op while no profiler records."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, request, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a profiler records."""
    if not _profiler._is_profiler_enabled:
        return
    store = _current()
    with _lock:
        store.counters[name] = store.counters.get(name, 0) + n


def snapshot() -> dict:
    """The latest session's ``{"spans": [...], "counters": {...}}``; a span
    is ``{"name", "start_ns", "end_ns", "parent", "request", "device_ms"}``,
    ``parent`` the index of its parent in the list (None at the top),
    ``end_ns`` None while it is open. Waits for the device events of the
    spans it resolves."""
    store = _current()
    with _lock:
        records, counters = list(store.spans), dict(store.counters)
    for tally, read, copy in list(_tallies):
        for name, n in read(tally if copy is None else copy).items():
            counters[name] = counters.get(name, 0) + n
    out = []
    for r in records:
        if r.events is not None and r.end_ns is not None:
            start, end = r.events
            end.synchronize()
            r.device_ms, r.events = start.elapsed_time(end), None
        out.append({"name": r.name, "start_ns": r.start_ns, "end_ns": r.end_ns,
                    "parent": r.parent, "request": r.request, "device_ms": r.device_ms})
    return {"spans": out, "counters": counters}


def _launch_counts() -> Dict[str, int]:
    """The kernel wrappers' ``*LAUNCHES`` counters and
    ``cuda_graph.CAPTURES``, by ``<module>.<name>``."""
    from emr2a_tpu_torch.models import cuda_graph
    out = {f"{m.__name__.rsplit('.', 1)[-1]}.{name}": getattr(m, name)
           for m, name in cuda_graph.launch_counters()}
    out["cuda_graph.CAPTURES"] = cuda_graph.CAPTURES
    return out


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Capture a profiler trace for the enclosed block into ``log_dir``,
    with ``spans.json`` beside it; yields the ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    Path(log_dir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    before = _launch_counts()
    try:
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
            yield prof
    finally:
        out = snapshot()
        out["launches"] = {k: v - before[k] for k, v in _launch_counts().items()}
        (Path(log_dir) / "spans.json").write_text(json.dumps(out, indent=1))


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
