"""Project-wide configuration.

The port's own copy of ``emr2a_tpu/config.py:BaseConfig`` and
``MeshConfig``: paths, the seed and the bilingual disease-label maps, and
the device mesh's layout, with the same fields and defaults. ``device``
names a PyTorch device here (``cuda`` by default); ``MeshConfig`` is read
by ``parallel.create_mesh(cfg.mesh_shape, cfg.axis_names)``, and its dtype
policy is recorded as in JAX (the towers take their dtypes from their own
configs). The JAX package's encoder and LLM configs, which carry a
``MeshConfig``, have no reader in either package and are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Tuple


@dataclass
class BaseConfig:
    """Project-wide paths, seed and the bilingual disease-label maps."""

    project_root: Path = field(default_factory=lambda: Path("."))
    data_root: Path = field(default_factory=lambda: Path("./data"))
    output_dir: Path = field(default_factory=lambda: Path("./outputs"))
    features_dir: Path = field(default_factory=lambda: Path("./outputs/features"))
    logs_dir: Path = field(default_factory=lambda: Path("./outputs/logs"))
    models_dir: Path = field(default_factory=lambda: Path("./outputs/models"))
    results_dir: Path = field(default_factory=lambda: Path("./outputs/results"))
    device: str = "cuda"
    seed: int = 42

    # 4-class pneumonia subtyping: directory name -> Chinese display label.
    disease_labels: Dict[str, str] = field(default_factory=lambda: {
        "bing_du_xing_fei_yan": "病毒性肺炎",
        "正常胸部CT图像": "正常",
        "PJP": "PJP肺炎",
        "细菌性": "细菌性肺炎",
    })

    # Inverse map: display label -> directory name.
    label_dir_map: Dict[str, str] = field(default_factory=lambda: {
        "病毒性肺炎": "bing_du_xing_fei_yan",
        "正常": "正常胸部CT图像",
        "PJP肺炎": "PJP",
        "细菌性肺炎": "细菌性",
    })


@dataclass
class MeshConfig:
    """Device-mesh layout: ``data`` shards batches (slices at embed time,
    the case database at retrieval time); ``model`` carries the judge's and
    the trainer's tensor parallelism (``parallel/tensor.py``)."""

    axis_names: Tuple[str, ...] = ("data", "model")
    # -1 means "all remaining devices on this axis".
    mesh_shape: Tuple[int, ...] = (-1, 1)
    # Dtype policy: params and computation bf16, accumulation f32.
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    accum_dtype: str = "float32"
