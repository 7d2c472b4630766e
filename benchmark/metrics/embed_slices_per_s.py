"""Slices embedded over the whole window (step2's cohort embedding rate)."""

from benchmark.core.readers import units_per_s as read  # noqa: F401
