"""K1 (``ops/mlp.fused_ln_mlp``: LayerNorm, fc1, GELU, fc2 and the
residual) as a share of its roofline: the least time the chip could take
for the traced calls over the device time of the kernels they launched.

Work counted per call at T useful rows (the tower pads its 197 tokens to
200; the pad rows are not counted), width d and MLP width m: 4 T d m
operations (the two products); bytes: the bf16 input and output rows, both
weights and their biases and the LayerNorm's scale and bias, each once.
"""

from benchmark.core.peaks import least_seconds

PROBE = ("emr2a_tpu_torch.models.layers", "fused_ln_mlp", "K1")


def shape(args, kwargs):
    x, w1 = args[0], args[3]
    return (int(x.shape[0]), int(x.shape[1]), int(w1.shape[1]))


def least(T: int, d: int, m: int) -> float:
    flops = 4 * T * d * m
    nbytes = 2 * (2 * T * d + 2 * d * m + m + 3 * d)
    return least_seconds(flops, nbytes)


def useful_rows(T: int, cfg: dict) -> int:
    valid = (cfg["image_size"] // cfg["patch_size"]) ** 2 + 1
    padded = -(-valid // 8) * 8
    return T // padded * valid if T % padded == 0 else T


def read(run):
    calls = run.calls.get("K1")
    secs = run.device.kernel_seconds("K1") if run.device is not None else 0.0
    if not calls or secs <= 0:
        return None
    return 100.0 * sum(least(useful_rows(T, run.config), d, m) for T, d, m in calls) / secs
