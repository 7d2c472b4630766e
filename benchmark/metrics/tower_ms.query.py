"""Median device time, in ms, of one case's image tower: the device time
of the program's ``encode.tower`` spans (the stream's time between their
CUDA events) in each ``encode.batch`` call, summed per case."""

from benchmark.metrics import _program


def read(run):
    return _program.median_of_children("encode.batch", ("encode.tower",), device=True)
