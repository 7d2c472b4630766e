"""Median host time, in ms, of a case's ``encode_batch_images`` call (it
returns host arrays, so the span ends after the device's work)."""

from benchmark.core.readers import span_median_ms


def read(run):
    return span_median_ms(run, "encode_batch_images")
