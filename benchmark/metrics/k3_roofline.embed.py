"""K3 (``ops/attention_block.fused_ln_attention``: LayerNorm, Q/K/V,
attention, the output projection and the residual) as a share of its
roofline: the least time the chip could take for the traced calls over the
device time of the kernels they launched.

Work counted per call of B items of S useful tokens (``valid_len``; the
pad tokens are not counted), width d: 8 B S d^2 operations for the four
projections and 4 B S^2 d for the scores and their product with V; bytes:
the bf16 input and output rows, the four weights, their biases and the
LayerNorm's scale and bias, each once.
"""

from benchmark.core.peaks import least_seconds

PROBE = ("emr2a_tpu_torch.models.layers", "fused_ln_attention", "K3")


def shape(args, kwargs):
    x = args[0]
    B, S, d = (int(n) for n in x.shape)
    return (B, int(kwargs.get("valid_len") or S), d)


def least(B: int, S: int, d: int) -> float:
    T = B * S
    flops = 8 * T * d * d + 4 * B * S * S * d
    nbytes = 2 * (2 * T * d + 4 * d * d + 6 * d)
    return least_seconds(flops, nbytes)


def read(run):
    calls = run.calls.get("K3")
    secs = run.device.kernel_seconds("K3") if run.device is not None else 0.0
    if not calls or secs <= 0:
        return None
    return 100.0 * sum(least(*c) for c in calls) / secs
