"""Image preprocessing on the device: uint8 -> f32, /255, resize, centre
crop, normalise.

Port of ``emr2a_tpu/ops/preprocess.py`` with the same per-family specs
(that module imports JAX, so the specs are restated here; the tests pin
them equal).

The resize is the port's copy of ``jax.image.resize(..., antialias=True)``
(``jax/_src/image/scale.py``, ``compute_weight_mat``): per spatial axis an
(in, out) f32 weight matrix of the Keys cubic kernel (a = -0.5) or the
triangle kernel, stretched by the scale when downsampling and normalised
per output pixel, applied with two einsums on the tensor's own device.
``torch.nn.functional.interpolate`` is not that filter (its bicubic has
a = -0.75 and no antialias when downsampling), so it is not used. The step2
engine (``encoders/jit_encoder.py``) canonicalises images on the host to
the spec's size first, so on the main path the resize plan is the identity.

``sample_slice_indices`` is the CV runner's host-side slice sampling.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from emr2a_tpu_torch.data.images import plan_resize


@dataclass(frozen=True)
class PreprocessSpec:
    resize_size: int = 224          # shortest-edge target (or exact size)
    crop_size: int = 224
    shortest_edge: bool = True      # False: resize to (resize, resize) exactly
    method: str = "bicubic"         # "bilinear" | "bicubic"
    mean: Tuple[float, float, float] = (0.48145466, 0.4578275, 0.40821073)
    std: Tuple[float, float, float] = (0.26862954, 0.26130258, 0.27577711)


# HF CLIPProcessor geometry + OpenAI CLIP statistics.
CLIP_PREPROCESS = PreprocessSpec()
# open_clip default transform (BiomedCLIP): HF CLIPProcessor geometry and
# OpenAI CLIP statistics.
BIOMEDCLIP_PREPROCESS = PreprocessSpec()
# HF ViTImageProcessor: exact resize, 0.5 statistics, bilinear.
VIT_PREPROCESS = PreprocessSpec(shortest_edge=False, method="bilinear",
                                mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5))
# timm vit_base_patch16_224 (augreg): crop_pct 0.9 -> resize 248, crop 224.
TIMM_VIT_PREPROCESS = PreprocessSpec(resize_size=248, mean=(0.5, 0.5, 0.5),
                                     std=(0.5, 0.5, 0.5))
# DINOv3 (DINOv3ViTImageProcessorFast defaults): exact 224 x 224 resize,
# bilinear, ImageNet statistics, no crop.
DINOV3_PREPROCESS = PreprocessSpec(shortest_edge=False, method="bilinear",
                                   mean=(0.485, 0.456, 0.406),
                                   std=(0.229, 0.224, 0.225))


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


def resize_weights(n_in: int, n_out: int, method: str,
                   device=None) -> torch.Tensor:
    """(n_in, n_out) f32 weights of one axis of ``jax.image.resize(...,
    "cubic" if method == "bicubic" else "linear", antialias=True)``:
    half-pixel centres, the kernel stretched by 1 / scale when downsampling,
    each output column normalised to sum 1. The scale and its inverse are
    Python floats, as in JAX, and everything else is f32."""
    kernel = _keys_cubic if method == "bicubic" else _triangle
    f32 = dict(dtype=torch.float32, device=device)
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, **f32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, **f32)[:, None]).abs() / kernel_scale
    w = kernel(x)
    total = w.sum(dim=0, keepdim=True)
    eps = torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > 1000.0 * eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_images(x: torch.Tensor, rh: int, rw: int, method: str) -> torch.Tensor:
    """(B, H, W, C) f32 -> (B, rh, rw, C), as ``jax.image.resize`` with
    ``antialias=True``; an axis whose size does not change is left as it
    is, as JAX leaves it."""
    B, H, W, C = x.shape
    if H != rh:
        x = torch.einsum("bhwc,ho->bowc", x,
                         resize_weights(H, rh, method, x.device))
    if W != rw:
        x = torch.einsum("bhwc,wo->bhoc", x,
                         resize_weights(W, rw, method, x.device))
    return x


def preprocess_images(images_u8: torch.Tensor,
                      spec: PreprocessSpec) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, crop, crop, 3) f32 normalised, on the
    tensor's own device."""
    B, H, W, C = images_u8.shape
    rh, rw = plan_resize(H, W, spec.resize_size, spec.shortest_edge)
    x = images_u8.to(torch.float32) / 255.0
    if (rh, rw) != (H, W):
        x = resize_images(x, rh, rw, spec.method)
    cs = spec.crop_size
    top = (rh - cs) // 2
    left = (rw - cs) // 2
    x = x[:, top:top + cs, left:left + cs, :]
    mean = torch.tensor(spec.mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(spec.std, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def sample_slice_indices(n_slices: int, sample_n: int, mode: str = "uniform",
                         seed: int = 42) -> list:
    """The CV runner's per-patient slice sampling
    (``emr2a_tpu/ops/preprocess.py:sample_slice_indices``):

    - ``uniform``: stride positions ``range(0, n, n // k)[:k]``;
    - ``random``: ``np.random.seed(seed)``, then a choice without
      replacement (unsorted);
    - fewer slices than sample_n: all of them.
    """
    import numpy as np

    if n_slices <= sample_n:
        return list(range(n_slices))
    if mode == "uniform":
        step = n_slices // sample_n
        return list(range(0, n_slices, step))[:sample_n]
    if mode == "random":
        np.random.seed(seed)
        return np.random.choice(n_slices, size=sample_n, replace=False).tolist()
    raise ValueError(f"Unknown sampling strategy: {mode}")
