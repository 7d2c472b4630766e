"""The share of the Kimi-VL cell's decoded row-steps whose token a request
kept (``decode.tokens_kept`` over ``decode.row_steps``), read as
``decode_use_pct.audit`` reads the Qwen judge's cells. A count."""

from benchmark.core import registry


def read(run):
    return registry.metric("decode_use_pct.audit").read(run)
