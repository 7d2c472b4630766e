"""Median host time, in ms, of one request's preparation in the judge
backend (the program's ``judge.prepare`` span: its images to arrays, their
patches and the prompt's tokens), over the traced window's requests."""

from benchmark.metrics import _program


def read(run):
    return _program.median_host_ms("judge.prepare")
