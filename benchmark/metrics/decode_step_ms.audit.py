"""Device time, in ms, of one decode step of the judge: the device time
of the program's decode spans (each ``batcher.dispatch`` of a chunk, each
``generator.decode`` run of steps) over the steps they ran
(``decode.steps``)."""

from benchmark.metrics import _program


def read(run):
    ms = _program.device_ms(("batcher.dispatch", "generator.decode"))
    steps = _program.counters().get("decode.steps")
    return ms / steps if ms and steps else None
