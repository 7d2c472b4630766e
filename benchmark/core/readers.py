"""Small reductions that several metric files share."""

from __future__ import annotations

import statistics
from typing import Optional


def idle_pct(run) -> Optional[float]:
    """The share of the traced window in which no kernel, copy or set ran
    on the device."""
    if run.device is None or run.device.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.device.busy_s / run.device.window_s)


def span_median_ms(run, name: str) -> Optional[float]:
    times = run.spans.get(name)
    return 1e3 * statistics.median(times) if times else None


def units_per_s(run) -> Optional[float]:
    """Items completed (attempted less failed) over the whole window."""
    done = sum(r["items"] - r["failed"] for r in run.records)
    return done / run.window_s if run.window_s > 0 else None
