"""The share of decoded row-steps whose token a request kept: the
program's ``decode.tokens_kept`` (each request's tokens up to its eos,
within its budget) over ``decode.row_steps`` (every slot or row of every
decode step run, those past a budget or in a free slot included). A
count: it repeats exactly for the same budgets and tokens."""

from benchmark.metrics import _program


def read(run):
    c = _program.counters()
    if not c.get("decode.row_steps"):
        return None
    return 100.0 * c.get("decode.tokens_kept", 0) / c["decode.row_steps"]
