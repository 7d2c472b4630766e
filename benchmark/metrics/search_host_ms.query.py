"""Median host time, in ms, of the database's host stages in one case's
search (the program's ``db.search`` span): the query's normalisation and
upload (``db.queries``) and the hit dicts (``db.hits``), summed per
search."""

from benchmark.metrics import _program


def read(run):
    return _program.median_of_children("db.search", ("db.queries", "db.hits"))
