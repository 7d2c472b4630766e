"""Median host time, in ms, of a case's ``ShardedEmbeddingDatabase.search``
(it returns host lists of hits, so the span ends after the device's
work)."""

from benchmark.core.readers import span_median_ms


def read(run):
    return span_median_ms(run, "search")
