"""What the per-layer metrics read of the program's own tracer
(``emr2a_tpu_torch.utils.profiling``): the spans and counters of the
traced window, which the program keeps for its latest profiler session.
A program without that tracer gives None, and the metrics that read it
are left out of the line."""

from __future__ import annotations

import statistics
from typing import Optional


def snapshot() -> Optional[dict]:
    try:
        from emr2a_tpu_torch.utils.profiling import snapshot as program_snapshot
    except ImportError:
        return None
    return program_snapshot()


def spans(name: str) -> list:
    """The traced window's spans named ``name`` (none without the tracer)."""
    snap = snapshot()
    return [s for s in snap["spans"] if s["name"] == name] if snap else []


def counters() -> dict:
    snap = snapshot()
    return snap["counters"] if snap else {}


def host_ms(span: dict) -> float:
    return (span["end_ns"] - span["start_ns"]) / 1e6


def median_host_ms(name: str) -> Optional[float]:
    """Median host ms of the spans named ``name``."""
    times = [host_ms(s) for s in spans(name)]
    return statistics.median(times) if times else None


def device_ms(names) -> Optional[float]:
    """Total device ms of the spans named in ``names``; None where they
    have none (on the CPU, or without the tracer)."""
    snap = snapshot()
    times = [s["device_ms"] for s in (snap["spans"] if snap else [])
             if s["name"] in names and s["device_ms"] is not None]
    return sum(times) if times else None


def median_of_children(parent: str, children, device: bool = False) -> Optional[float]:
    """Median over the spans named ``parent`` of the total ms (host, or
    device with ``device``) of their direct children named in
    ``children``."""
    snap = snapshot()
    if not snap:
        return None
    all_spans = snap["spans"]
    totals = {i: 0.0 for i, s in enumerate(all_spans) if s["name"] == parent}
    for s in all_spans:
        if s["parent"] in totals and s["name"] in children:
            if device:
                if s["device_ms"] is None:
                    return None
                totals[s["parent"]] += s["device_ms"]
            else:
                totals[s["parent"]] += host_ms(s)
    return statistics.median(totals.values()) if totals else None
