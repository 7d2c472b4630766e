"""A synthetic CT cohort on disk: 512x512 PNG slices and a manifest.jsonl."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

LABELS = ("Bacterial", "Viral", "PJP", "Normal")


def write_cohort(root: Path, n_patients: int = 12, n_slices: int = 40,
                 rgb: bool = False) -> Path:
    """CT-like slices in 4 classes: a body ellipse, lungs and
    patient-specific texture, saved as grey PNGs (three equal channels when
    ``rgb``); returns the manifest path."""
    from PIL import Image
    size = 512
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:size, 0:size] / size - 0.5
    records = []
    for p in range(n_patients):
        label = LABELS[p % 4]
        pdir = root / label / f"patient_{p:02d}"
        pdir.mkdir(parents=True)
        freq = 6 + 3 * p
        slices = []
        for s in range(n_slices):
            z = s / n_slices
            body = ((xx / 0.45) ** 2 + (yy / 0.35) ** 2) < 1
            lungs = (((np.abs(xx) - 0.18) / 0.14) ** 2 + (yy / (0.2 + 0.1 * z)) ** 2) < 1
            tex = 40 * np.sin(freq * np.pi * xx + p) * np.cos(freq * np.pi * yy * (1 + z))
            img = np.where(body, 170 + tex, 10) - 120 * lungs
            img = np.clip(img + rng.randn(size, size) * 8, 0, 255).astype(np.uint8)
            if rgb:
                img = np.repeat(img[..., None], 3, axis=-1)
            path = pdir / f"slice_{s}.png"
            Image.fromarray(img).save(path, compress_level=1)
            slices.append(str(path))
        records.append({"patient_id": f"P{p:03d}", "label": label,
                        "slices": slices})
    manifest = root / "manifest.jsonl"
    manifest.write_text("".join(json.dumps(r) + "\n" for r in records),
                        encoding="utf-8")
    return manifest
