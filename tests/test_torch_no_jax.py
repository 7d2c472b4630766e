"""The port never loads JAX: in a fresh interpreter, import every module of
``emr2a_tpu_torch`` and run the fake-encoder step2 CLI, then check that
neither JAX, jaxlib, flax nor optax was imported, and that of the JAX
package only its framework-free modules were (config, the data helpers and
step1's manifest builder), which the port reuses."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent

_PROGRAM = r"""
import importlib, pkgutil, sys
import emr2a_tpu_torch
names = [m.name for m in pkgutil.walk_packages(emr2a_tpu_torch.__path__,
                                               "emr2a_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from emr2a_tpu_torch.pipelines.step2_embeddings.build_embeddings import main
main(["--manifest_path", sys.argv[1], "--encoder_type", "fake",
      "--device", "cpu", "--output_dir", sys.argv[2]])
reusable = ("emr2a_tpu", "emr2a_tpu.config", "emr2a_tpu.data",
            "emr2a_tpu.data.images", "emr2a_tpu.data.manifest",
            "emr2a_tpu.data.native_loader", "emr2a_tpu.pipelines",
            "emr2a_tpu.pipelines.step1_manifest")
loaded = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax")
    or (m.split(".")[0] == "emr2a_tpu" and m not in reusable
        and not m.startswith("emr2a_tpu.pipelines.step1_manifest.")))
print("MODULES", len(names), "LOADED", ",".join(loaded) or "-")
"""


def test_port_imports_no_jax(tmp_path):
    from PIL import Image
    img = tmp_path / "s0.png"
    Image.fromarray(np.full((16, 16, 3), 90, np.uint8)).save(img)
    manifest = tmp_path / "manifest.jsonl"
    manifest.write_text(json.dumps({"patient_id": "P1", "slices": [str(img)]})
                        + "\n", encoding="utf-8")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", _PROGRAM, str(manifest), str(tmp_path / "out")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    last = proc.stdout.strip().splitlines()[-1]
    n_modules = int(last.split()[1])
    assert n_modules >= 20, last
    assert last.endswith("LOADED -"), last
    assert np.load(tmp_path / "out" / "embeddings.npz")["P1"].shape == (1, 64)
