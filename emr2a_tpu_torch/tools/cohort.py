"""A synthetic CT cohort on disk: 512x512 PNG slices, a manifest.jsonl,
and the raw tree step1 reads to build that manifest itself.

Layout under ``root``: ``CT_2D_image_core/<Label>/patient_NN/slice_S.png``
(named so that only a natural sort puts ``slice_2`` before ``slice_10``),
``Case_csv/<Label>.csv`` with a ``patient_id`` column and the clinical
columns under their zh headers (姓名, 性别, 年龄, 发热, 症状), and
``manifest.jsonl``, which lists the same patients, labels and slices as
step1 gives for that tree."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

LABELS = ("Bacterial", "Viral", "PJP", "Normal")
SYMPTOMS = ("咳嗽", "气促", "胸痛", "乏力", "咳痰")


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
    rows = {label: ["patient_id,姓名,性别,年龄,发热,症状"] for label in LABELS}
    for p in range(n_patients):
        label = LABELS[p % 4]
        name = f"patient_{p:02d}"
        pdir = root / "CT_2D_image_core" / label / name
        pdir.mkdir(parents=True)
        rows[label].append(f"P{p:03d},{name},{'男' if p % 2 else '女'},"
                           f"{25 + 3 * p},{'是' if p % 3 else '否'},"
                           f"{SYMPTOMS[p % len(SYMPTOMS)]}")
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
    (root / "Case_csv").mkdir(parents=True)
    for label, lines in rows.items():
        (root / "Case_csv" / f"{label}.csv").write_text(
            "\n".join(lines) + "\n", encoding="utf-8")
    manifest = root / "manifest.jsonl"
    manifest.write_text("".join(json.dumps(r) + "\n" for r in records),
                        encoding="utf-8")
    return manifest
