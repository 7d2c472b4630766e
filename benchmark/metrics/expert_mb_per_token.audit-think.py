"""Routed-expert weight MB that decode read per token served: K11's
distinct experts a decode call, summed over the traced window's decode
calls (``moe.expert_reads.decode``), times an expert's bf16 weights (3 H
F_e x 2 bytes), over the tokens the requests were served
(``decode.tokens_kept``). Lower means fewer experts a step per token: a
larger batch, or routing that overlaps more."""

from benchmark.metrics import _program


def read(run):
    c = _program.counters()
    reads, kept = c.get("moe.expert_reads.decode"), c.get("decode.tokens_kept")
    if not reads or not kept:
        return None
    cfg = run.config
    return reads * 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"] * 2 / 1e6 / kept
