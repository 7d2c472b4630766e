"""K8 (``ops/vision_flash.frame_flash_attention``: attention within each
image frame of the judge's vision tower) as a share of its roofline: the
least time the chip could take for the traced calls over the device time
of the kernels they launched.

Work counted per call of F frames of S tokens, H heads of width D:
4 F S^2 H D operations (the scores and their product with V); bytes: the
bf16 q, k, v and output, each once.
"""

from benchmark.core.peaks import least_seconds

PROBE = ("emr2a_tpu_torch.models.qwen3_vl", "frame_flash_attention", "K8")


def shape(args, kwargs):
    return tuple(int(n) for n in args[0].shape)        # q: (F, S, H, D)


def least(F: int, S: int, H: int, D: int) -> float:
    return least_seconds(4 * F * S * S * H * D, 2 * 4 * F * S * H * D)


def read(run):
    calls = run.calls.get("K8")
    secs = run.device.kernel_seconds("K8") if run.device is not None else 0.0
    if not calls or secs <= 0:
        return None
    return 100.0 * sum(least(*c) for c in calls) / secs
