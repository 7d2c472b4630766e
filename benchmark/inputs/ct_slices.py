"""CT-like slices made on the device from a seed (after the synthetic
cohort of ``emr2a_tpu_torch/tools/cohort.py``): a body ellipse, two lungs
whose height changes with the slice's depth z in [0, 1), a texture of the
patient's own frequency and phase, and Gaussian noise; grey uint8."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.core.seeded import generator

_CHUNK = 256    # slices a call: a few hundred MB of float32 scratch at 512 x 512


@torch.no_grad()
def make_slices(patients, depths, size: int, seed: int, device) -> np.ndarray:
    """One slice per (patient, depth) pair: (n, size, size) uint8 on the
    host, made in chunks of ``_CHUNK`` slices from one noise stream."""
    dev = torch.device(device)
    patients, depths = np.asarray(patients), np.asarray(depths)
    gen = generator(seed, "slices", dev)
    out = np.empty((len(patients), size, size), dtype=np.uint8)
    for lo in range(0, len(patients), _CHUNK):
        out[lo:lo + _CHUNK] = _chunk(patients[lo:lo + _CHUNK], depths[lo:lo + _CHUNK],
                                     size, gen, dev)
    return out


def _chunk(patients, depths, size: int, gen: torch.Generator, dev) -> np.ndarray:
    p = torch.as_tensor(patients, dtype=torch.float32, device=dev)[:, None, None]
    z = torch.as_tensor(depths, dtype=torch.float32, device=dev)[:, None, None]
    grid = torch.arange(size, dtype=torch.float32, device=dev) / size - 0.5
    yy, xx = grid[None, :, None], grid[None, None, :]
    freq = 6 + 3 * torch.remainder(p, 12)
    body = ((xx / 0.45) ** 2 + (yy / 0.35) ** 2) < 1
    lungs = (((xx.abs() - 0.18) / 0.14) ** 2 + (yy / (0.2 + 0.1 * z)) ** 2) < 1
    tex = 40 * torch.sin(freq * np.pi * xx + p) * torch.cos(freq * np.pi * yy * (1 + z))
    img = torch.where(body, 170 + tex, torch.full_like(tex, 10.0)) - 120 * lungs.float()
    noise = torch.randn(img.shape, generator=gen, device=dev)
    img = torch.clamp(img + 8 * noise, 0, 255).to(torch.uint8)
    return img.cpu().numpy()


def rgb(grey: np.ndarray) -> np.ndarray:
    """(..., H, W) grey -> (..., H, W, 3), three equal channels."""
    return np.repeat(grey[..., None], 3, axis=-1)
