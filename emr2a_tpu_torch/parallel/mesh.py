"""The device mesh of one process.

Port of ``emr2a_tpu/parallel/mesh.py``. JAX's single-controller model is
kept: one Python process holds a ``Mesh`` of ``torch.device``s and issues
each device's work itself, as JAX's ``shard_map`` does. The ``data`` axis
splits batches (slices at embed time, the case database at retrieval time,
the trainer's batch); the ``model`` axis carries Megatron tensor
parallelism (``tensor.py``: the judge's Qwen3-VL, served with ``tp=``, and
the trainer's towers), each card holding its shard of the projections and
the row-parallel sums exchanged by peer copies.

Differences from JAX:

- ``Mesh`` is this module's own small class: an ndarray of
  ``torch.device``s with ``axis_names``, ``shape`` as a mapping from axis
  name to size (``mesh.shape[DATA_AXIS]``), ``size`` and ``devices``;
- ``create_mesh`` takes the devices in the order given (no ICI-contiguous
  reordering: the cards of one host are joined all to all) and, without
  ``devices``, every visible CUDA device; it raises where there is none;
- a CUDA device may appear once in a mesh and must exist; only CPU devices
  repeat. ``force_cpu_devices(n)`` (JAX: ``n`` virtual host devices) makes
  the default mesh ``n`` CPU devices on ``data``, which is how the CPU tests
  run the sharded paths;
- ``initialize_distributed`` is a no-op for one process and raises for
  more: multi-host runs are not ported yet (ROADMAP.md, Queue 1, item 7c).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"

_default_mesh: Optional["Mesh"] = None


class Mesh:
    """An ndarray of ``torch.device``s with one name per axis."""

    def __init__(self, devices, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-D device array needs "
                             f"{devices.ndim} axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names repeat: {axis_names}")
        flat = [torch.device(d) for d in devices.flat]
        cuda = [d for d in flat if d.type == "cuda"]
        if any(d.index is None for d in cuda):
            raise ValueError("a mesh names CUDA devices with their index "
                             f"(cuda:N), got {[str(d) for d in cuda]}")
        if len({d.index for d in cuda}) != len(cuda):
            raise ValueError("a CUDA device may appear once in a mesh, got "
                             f"{[str(d) for d in cuda]}")
        if cuda:
            visible = torch.cuda.device_count()
            missing = [str(d) for d in cuda if d.index >= visible]
            if missing:
                raise ValueError(f"{missing} not among the {visible} visible "
                                 f"CUDA devices")
        if any(d.type not in ("cpu", "cuda") for d in flat):
            raise ValueError(f"a mesh holds CPU or CUDA devices, got "
                             f"{[str(d) for d in flat]}")
        self.devices = np.empty(devices.shape, dtype=object)
        for i, d in enumerate(flat):
            self.devices.flat[i] = d
        self.axis_names = axis_names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return (f"Mesh({', '.join(f'{a}={n}' for a, n in self.shape.items())}: "
                f"{[str(d) for d in self.devices.flat]})")


def local_device_count() -> int:
    return torch.cuda.device_count()


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-host bring-up: a no-op for a single process."""
    if num_processes is not None and num_processes > 1:
        raise NotImplementedError(
            "multi-host runs (num_processes > 1) are not ported yet "
            "(ROADMAP.md, Queue 1, item 7c)")


def _cuda_devices() -> list:
    """Every visible CUDA device; raises where there is none."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device: a mesh of the cards needs at least "
                           "one (pass devices=, or force_cpu_devices(n) for a "
                           "CPU mesh)")
    return [torch.device("cuda", i) for i in range(n)]


def create_mesh(mesh_shape: Sequence[int] = (-1, 1),
                axis_names: Sequence[str] = (DATA_AXIS, MODEL_AXIS),
                devices: Optional[Sequence] = None) -> Mesh:
    """Build a Mesh over ``devices`` (default: every visible CUDA device),
    in their order. A single ``-1`` absorbs all remaining devices."""
    if devices is None:
        devices = _cuda_devices()
    devices = list(devices)
    n = len(devices)
    shape = list(mesh_shape)
    if shape.count(-1) > 1:
        raise ValueError(f"At most one -1 allowed in mesh_shape, got {mesh_shape}")
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1])) or 1
        if n % known != 0:
            raise ValueError(f"{n} devices not divisible by fixed axes {known}")
        shape[shape.index(-1)] = n // known
    total = int(np.prod(shape))
    if total != n:
        raise ValueError(f"mesh_shape {shape} needs {total} devices, have {n}")
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devices):
        grid[i] = torch.device(d)
    return Mesh(grid.reshape(shape), axis_names)


def default_mesh(refresh: bool = False) -> Mesh:
    """Process-wide default mesh: every CUDA device on ``data``, model = 1.
    Raises where there is no CUDA device (``force_cpu_devices`` sets a CPU
    one)."""
    global _default_mesh
    if _default_mesh is None or refresh:
        _default_mesh = create_mesh((-1, 1))
    return _default_mesh


def set_default_mesh(mesh: Mesh) -> None:
    global _default_mesh
    _default_mesh = mesh


def force_cpu_devices(n: int = 8) -> Mesh:
    """Make the default mesh ``n`` CPU devices on ``data`` (JAX's ``n``
    virtual host devices) and return it."""
    mesh = create_mesh((-1, 1), devices=[torch.device("cpu")] * n)
    set_default_mesh(mesh)
    return mesh
