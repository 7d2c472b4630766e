"""The judge's prefill as a share of the chip's bf16 peak: the prefill
operations of the traced requests over 989 TFLOP/s times the device time
of the program's prefill spans (``batcher.prefill``,
``batcher.shared_prefix``, ``generator.prefill``: the stream's time
between each span's CUDA events, its upload stalls included).

Operations (``judge_mfu.audit``'s formulas): each request's images, its
prompt after the wave's shared prefix and the lm_head at its last
position; the shared prefix once a wave.
"""

from benchmark.core import registry
from benchmark.core.peaks import BF16_FLOPS
from benchmark.metrics import _program

SPANS = ("batcher.prefill", "batcher.shared_prefix", "generator.prefill")


def prefill_flops(cfg: dict, rec: dict) -> float:
    mfu = registry.metric("judge_mfu.audit")
    t = cfg["text"]
    head = 2 * t["hidden_size"] * t["vocab_size"]
    shared = rec["shared_prefix"]
    total = mfu.prefix_flops(cfg, shared)
    for r in rec["requests"]:
        total += sum(mfu.image_flops(cfg, g) for g in r["grids"])
        total += mfu._token_flops(cfg, shared, r["prompt_len"]) + head
    return total


def read(run):
    ms = _program.device_ms(SPANS)
    if not ms or not run.traced:
        return None
    flops = sum(prefill_flops(run.config, rec) for rec in run.traced)
    return 100.0 * flops / (BF16_FLOPS * ms / 1e3)
