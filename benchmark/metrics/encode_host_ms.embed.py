"""Median host time, in ms, of the encode engine's host stages in one
``encode_batch_images`` call (the program's ``encode.batch`` span): the
canonicalisation (``encode.resize``), the stacking (``encode.stack``) and
the upload (``encode.upload``), summed per call."""

from benchmark.metrics import _program

STAGES = ("encode.resize", "encode.stack", "encode.upload")


def read(run):
    return _program.median_of_children("encode.batch", STAGES)
