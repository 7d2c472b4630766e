"""The share of the Kimi-VL cell's traced window in which the device was
idle while the host was inside the batcher or the generator, read as
``serving_idle_pct.audit`` reads the Qwen judge's cells."""

from benchmark.core import registry


def read(run):
    return registry.metric("serving_idle_pct.audit").read(run)
