"""K8 (``ops/vision_flash.frame_flash_attention``) in the Kimi-VL cell:
MoonViT's attention within each image, through the same call as the Qwen
tower's, counted and read as ``k8_roofline.audit`` reads it (the probed
calls' least time over the device time of their launches)."""

from benchmark.core import registry

_k8 = registry.metric("k8_roofline.audit")
PROBE = _k8.PROBE
shape = _k8.shape


def read(run):
    return _k8.read(run)
