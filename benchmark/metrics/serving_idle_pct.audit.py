"""The share of the traced window in which the device was idle while the
host was inside the batcher or the generator: the idle gaps (of 20 us or
more) that the device trace names after a program span ``batcher.*`` or
``generator.*``, over the window."""

from benchmark.metrics import _program

PREFIXES = ("batcher.", "generator.")


def read(run):
    if run.device is None or run.device.window_s <= 0 or run.device.busy_s <= 0:
        return None
    snap = _program.snapshot()
    if not snap or not any(s["name"].startswith(PREFIXES) for s in snap["spans"]):
        return None
    idle = sum(s for name, s in run.device.idle.items() if name.startswith(PREFIXES))
    return 100.0 * idle / run.device.window_s
