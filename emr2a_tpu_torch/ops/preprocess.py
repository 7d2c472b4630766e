"""Image preprocessing on the device: uint8 -> f32, /255, centre crop,
normalise.

Port of ``emr2a_tpu/ops/preprocess.py`` with the same per-family specs
(that module imports JAX, so the specs are restated here; the tests pin
them equal).

The device resize branch of the JAX function is not ported: the step2
engine (``encoders/jit_encoder.py``) canonicalises every image on the host
to the spec's size first, so on the main path the device plan is always
the identity. ``jax.image.resize`` (cubic: Keys a=-0.5, antialiased) and
torch's bicubic (a=-0.75) are different filters, so an input that would
need the device resize raises ``NotImplementedError`` instead of silently
differing.

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


# open_clip default transform (BiomedCLIP): HF CLIPProcessor geometry and
# OpenAI CLIP statistics.
BIOMEDCLIP_PREPROCESS = PreprocessSpec()


def preprocess_images(images_u8: torch.Tensor,
                      spec: PreprocessSpec) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, crop, crop, 3) f32 normalised, on the
    tensor's own device."""
    B, H, W, C = images_u8.shape
    rh, rw = plan_resize(H, W, spec.resize_size, spec.shortest_edge)
    if (rh, rw) != (H, W):
        raise NotImplementedError(
            f"device resize {H}x{W} -> {rh}x{rw} is not ported; canonicalise "
            f"on the host first (data.images.resize_to), as the encoders do")
    x = images_u8.to(torch.float32) / 255.0
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
