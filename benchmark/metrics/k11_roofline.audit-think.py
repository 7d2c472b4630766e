"""K11 (``ops/moe.py``: the routed experts of Kimi-VL's expert layers) as a
share of its roofline: the least time the chip could take for the traced
window's routed work over the device time of K11's kernels, found by their
names (``k11_align_kernel``, ``k11_gemm_kernel<...>``: every kernel whose
name holds ``k11_``) in the device trace, since graph replays run no
Python that a probe could wrap.

The work comes from the program's counters (K11's device-side tally, read
once the window has closed), prefill and decode apart, each phase's least
time the larger of its operations over the bf16 peak and its bytes over
the memory bandwidth:

- operations: 2 x 3 x H x F_e a token-expert pair (the gate, up and down
  products);
- bytes: each call's distinct experts' weights (3 H F_e in bf16), plus the
  activations: each token's bf16 row read and its f32 sum written once
  (the kernels write a row a pair, which the least time does not count).
"""

from benchmark.core.peaks import least_seconds
from benchmark.metrics import _program

MARK = "k11_"


def least(cfg: dict, pairs: int, expert_reads: int) -> float:
    H, Fe, k = cfg["hidden_size"], cfg["moe_intermediate_size"], cfg["num_experts_per_tok"]
    ops = 6 * H * Fe * pairs
    nbytes = expert_reads * 3 * H * Fe * 2 + (pairs // k) * H * (2 + 4)
    return least_seconds(ops, nbytes)


def device_seconds(run) -> float:
    if run.device is None:
        return 0.0
    return sum(s for name, s in run.device.by_name.items() if MARK in name)


def read(run):
    secs = device_seconds(run)
    c = _program.counters()
    if secs <= 0 or not any(c.get(f"moe.pairs.{p}") for p in ("prefill", "decode")):
        return None
    total = sum(least(run.config, c.get(f"moe.pairs.{p}", 0), c.get(f"moe.expert_reads.{p}", 0))
                for p in ("prefill", "decode"))
    return 100.0 * total / secs
