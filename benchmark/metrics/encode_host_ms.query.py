"""Median host time, in ms, of the encode engine's host stages in one
case's ``encode_batch_images`` call (the program's ``encode.batch`` span):
``encode.resize``, ``encode.stack`` and ``encode.upload``, summed per
case."""

from benchmark.metrics import _program

STAGES = ("encode.resize", "encode.stack", "encode.upload")


def read(run):
    return _program.median_of_children("encode.batch", STAGES)
