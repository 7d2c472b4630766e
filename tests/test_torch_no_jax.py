"""The port never loads JAX, nor any module of the JAX package, nor
sklearn: in a fresh interpreter, import every module of
``emr2a_tpu_torch``, run the fake-encoder step2 CLI, the database CLI
(``build`` and ``query --cpu``) and the CV runner (``--device cpu``, fake
encoders), then check that no module of jax, jaxlib, flax, optax, sklearn
or ``emr2a_tpu`` was imported."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent

_PROGRAM = r"""
import importlib, os, pkgutil, sys
import emr2a_tpu_torch
names = [m.name for m in pkgutil.walk_packages(emr2a_tpu_torch.__path__,
                                               "emr2a_tpu_torch.")]
for name in names:
    importlib.import_module(name)
manifest, out = sys.argv[1], sys.argv[2]
from emr2a_tpu_torch.pipelines.step2_embeddings.build_embeddings import main
main(["--manifest_path", manifest, "--encoder_type", "fake",
      "--device", "cpu", "--output_dir", out])
from emr2a_tpu_torch.retrieval.database_cli import main as db_main
db_main(["build", "--embeddings_path", out + "/embeddings.npz",
         "--manifest_path", manifest, "--db", out + "/db.npz", "--dtype",
         "int8", "--cpu"])
db_main(["query", "--db", out + "/db.npz", "--queries_path",
         out + "/embeddings.npz", "--k", "2", "--dtype", "int8", "--cpu",
         "--output", out + "/hits.jsonl"])
from emr2a_tpu_torch.analysis.run_cv_experiments import main as cv_main
os.chdir(out)
cv_main(["--manifest_path", manifest, "--output_dir", out + "/cv",
         "--image_encoder", "fake", "--text_encoder", "fake",
         "--experiment_id", "nj", "--cv_folds", "2", "--pca_dim", "4",
         "--device", "cpu"])
loaded = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "sklearn",
                           "emr2a_tpu"))
print("MODULES", len(names), "LOADED", ",".join(loaded) or "-")
"""


def test_port_imports_no_jax(tmp_path):
    from PIL import Image
    records = []
    for p in range(4):
        img = tmp_path / f"s{p}.png"
        Image.fromarray(np.full((16, 16, 3), 40 * p + 10, np.uint8)).save(img)
        records.append({"patient_id": f"P{p}", "label": "AB"[p % 2],
                        "slices": [str(img)], "meta": {"age": str(30 + p)}})
    manifest = tmp_path / "manifest.jsonl"
    manifest.write_text("".join(json.dumps(r) + "\n" for r in records),
                        encoding="utf-8")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", _PROGRAM, str(manifest), str(tmp_path / "out")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    last = proc.stdout.strip().splitlines()[-1]
    n_modules = int(last.split()[1])
    assert n_modules >= 30, last
    assert last.endswith("LOADED -"), last
    assert np.load(tmp_path / "out" / "embeddings.npz")["P1"].shape == (1, 64)
    hits = (tmp_path / "out" / "hits.jsonl").read_text().splitlines()
    assert len(hits) == 4
    assert (tmp_path / "out" / "cv" / "exp_nj" / "fold_2" / "metrics.json").exists()
