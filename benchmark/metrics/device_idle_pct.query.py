"""The share of the traced window with nothing running on the device."""

from benchmark.core.readers import idle_pct as read  # noqa: F401
