"""The device mesh: the cards of one process, or of several.

Port of ``emr2a_tpu/parallel/mesh.py``. JAX's single-controller model is
kept within a process: it holds a ``Mesh`` of ``torch.device``s and issues
each local device's work itself, as JAX's ``shard_map`` does. The ``data``
axis splits batches (slices at embed time, the case database at retrieval
time, the trainer's batch); the ``model`` axis carries Megatron tensor
parallelism (``tensor.py``: the judge's Qwen3-VL, served with ``tp=``, and
the trainer's towers), each card holding its shard of the projections and
the row-parallel sums exchanged by peer copies.

Several processes (JAX's multi-process runs, ``jax.distributed``):
``initialize_distributed`` brings up ``torch.distributed`` (NCCL on the
cards by default, gloo where asked, as the CPU tests do), and then
``devices()``, ``create_mesh()`` and ``default_mesh()`` span every
process's local devices in process order, as ``jax.devices()`` does. Each
mesh position records its owning process (``Mesh.processes``), so a
device's identity is (process, device): two processes may each call their
card ``cuda:0``. Only the sharded database runs over such a mesh
(``retrieval/database.py``: each process scans its own shards and the
candidates are all-gathered); every helper that would place or read a
device's data raises where that device belongs to another process
(``require_local``).

Differences from JAX:

- ``Mesh`` is this module's own small class: an ndarray of
  ``torch.device``s with ``axis_names``, ``processes`` (an int ndarray of
  the same shape), ``shape`` as a mapping from axis name to size
  (``mesh.shape[DATA_AXIS]``), ``size`` and ``devices``;
- ``create_mesh`` takes the devices in the order given (no ICI-contiguous
  reordering: the cards of one host are joined all to all) and, without
  ``devices``, every process's devices (``devices()``); it raises where
  there is none;
- a CUDA device may appear once a process in a mesh and a local one must
  exist; only CPU devices repeat. ``force_cpu_devices(n)`` (JAX: ``n``
  virtual host devices) makes the default mesh ``n`` CPU devices of each
  process on ``data``, which is how the CPU tests run the sharded paths;
- the backend is named (``"nccl"`` unless told otherwise) and never
  switched: where NCCL is missing ``initialize_distributed`` raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"

_default_mesh: Optional["Mesh"] = None
_local_ids: Optional[List[int]] = None   # initialize_distributed(local_device_ids=)


def _distributed() -> bool:
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def process_index() -> int:
    """This process's rank (JAX's ``jax.process_index()``); 0 alone."""
    return torch.distributed.get_rank() if _distributed() else 0


def process_count() -> int:
    """The number of processes (JAX's ``jax.process_count()``); 1 alone."""
    return torch.distributed.get_world_size() if _distributed() else 1


class Mesh:
    """An ndarray of ``torch.device``s with one name per axis, and the
    process that owns each (default: this one)."""

    def __init__(self, devices, axis_names: Sequence[str], processes=None):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-D device array needs "
                             f"{devices.ndim} axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names repeat: {axis_names}")
        me = process_index()
        owners = (np.full(devices.shape, me, dtype=np.int64) if processes is None
                  else np.asarray(processes, dtype=np.int64))
        if owners.shape != devices.shape:
            raise ValueError(f"processes has shape {owners.shape}, the devices "
                             f"{devices.shape}")
        if owners.size and (owners.min() < 0 or owners.max() >= process_count()):
            raise ValueError(f"processes {sorted(set(owners.flat))} outside the "
                             f"{process_count()} process(es)")
        flat = [torch.device(d) for d in devices.flat]
        cuda = [(int(p), d) for p, d in zip(owners.flat, flat) if d.type == "cuda"]
        if any(d.index is None for _, d in cuda):
            raise ValueError("a mesh names CUDA devices with their index "
                             f"(cuda:N), got {[str(d) for _, d in cuda]}")
        if len({(p, d.index) for p, d in cuda}) != len(cuda):
            raise ValueError("a CUDA device may appear once in a mesh, got "
                             f"{[_name(p, d) for p, d in cuda]}")
        local = [d for p, d in cuda if p == me]
        if local:
            visible = torch.cuda.device_count()
            missing = [str(d) for d in local if d.index >= visible]
            if missing:
                raise ValueError(f"{missing} not among the {visible} visible "
                                 f"CUDA devices")
        if any(d.type not in ("cpu", "cuda") for d in flat):
            raise ValueError(f"a mesh holds CPU or CUDA devices, got "
                             f"{[str(d) for d in flat]}")
        self.devices = np.empty(devices.shape, dtype=object)
        for i, d in enumerate(flat):
            self.devices.flat[i] = d
        self.processes = owners
        self.axis_names = axis_names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def is_local(self) -> bool:
        """Whether this process owns every device of the mesh."""
        return bool((self.processes == process_index()).all())

    def __repr__(self) -> str:
        names = [str(d) if self.is_local else _name(p, d)
                 for p, d in zip(self.processes.flat, self.devices.flat)]
        return (f"Mesh({', '.join(f'{a}={n}' for a, n in self.shape.items())}: "
                f"{names})")


def _name(process: int, device: torch.device) -> str:
    return f"process {process}: {device}"


def require_local(mesh: Mesh, what: str) -> None:
    """Raise where ``mesh`` holds a device of another process: ``what``
    would place or read that device's data, which only its own process
    can (the port never copies between processes but by a collective)."""
    if not mesh.is_local:
        me = process_index()
        others = sorted({_name(int(p), d) for p, d in zip(mesh.processes.flat,
                                                          mesh.devices.flat) if p != me})
        raise ValueError(f"{what} needs every device of the mesh in this process "
                         f"(process {me}); {others} belong to others. Across "
                         f"processes only the sharded database runs "
                         f"(retrieval/database.py)")


def local_device_count() -> int:
    return torch.cuda.device_count()


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: str = "nccl",
                           local_device_ids: Optional[Sequence[int]] = None) -> None:
    """Bring up ``torch.distributed`` over ``num_processes`` processes
    (JAX's ``jax.distributed.initialize``); a no-op for one process.

    ``coordinator_address`` is ``host:port`` of a free port that process 0
    listens on (``init_method=tcp://...``). ``backend`` is ``"nccl"`` (the
    cards; raises where NCCL is missing, with no switch to gloo) or
    ``"gloo"`` (the host). ``local_device_ids`` (JAX's argument of that
    name) are the CUDA devices this process drives, default every visible
    one; with NCCL the first is made the current device before any
    collective. The arguments are checked before any connection is
    tried."""
    if num_processes is None or num_processes <= 1:
        return
    if not coordinator_address:
        raise ValueError("initialize_distributed needs coordinator_address "
                         "(host:port) for more than one process")
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"process_id must be in [0, {num_processes}), got "
                         f"{process_id}")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    global _local_ids, _default_mesh
    ids = None if local_device_ids is None else [int(i) for i in local_device_ids]
    if backend == "nccl":
        if not torch.distributed.is_nccl_available():
            raise RuntimeError("backend='nccl' but this PyTorch has no NCCL; pass "
                               "backend='gloo' to run over the host")
        visible = torch.cuda.device_count()
        first = ids[0] if ids else 0
        if not 0 <= first < visible:
            raise ValueError(f"backend='nccl' needs a local card: cuda:{first} is not "
                             f"among the {visible} visible CUDA devices")
        torch.cuda.set_device(first)
    torch.distributed.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    _local_ids = ids
    _default_mesh = None


def shutdown_distributed() -> None:
    """Leave the process group ``initialize_distributed`` joined (JAX's
    ``jax.distributed.shutdown``); a no-op alone."""
    global _local_ids, _default_mesh
    if _distributed():
        torch.distributed.destroy_process_group()
    _local_ids = None
    _default_mesh = None


def _cuda_devices() -> list:
    """This process's CUDA devices (``local_device_ids``, else every
    visible one); raises where there is none."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device: a mesh of the cards needs at least "
                           "one (pass devices=, or force_cpu_devices(n) for a "
                           "CPU mesh)")
    return [torch.device("cuda", i) for i in (_local_ids or range(n))]


def local_devices() -> list:
    """This process's CUDA devices (JAX's ``jax.local_devices()``)."""
    return _cuda_devices()


def _spanning(local: Sequence[torch.device]):
    """(devices, processes): every process's ``local`` devices in process
    order (an object all-gather, so every process calls it together)."""
    local = [torch.device(d) for d in local]
    if process_count() == 1:
        return local, [0] * len(local)
    every = [None] * process_count()
    torch.distributed.all_gather_object(every, [str(d) for d in local])
    devices = [torch.device(d) for names in every for d in names]
    return devices, [p for p, names in enumerate(every) for _ in names]


def devices():
    """(devices, processes) of every process in process order (JAX's
    ``jax.devices()``, with each device's process); every process calls it
    together."""
    return _spanning(_cuda_devices())


def create_mesh(mesh_shape: Sequence[int] = (-1, 1),
                axis_names: Sequence[str] = (DATA_AXIS, MODEL_AXIS),
                devices: Optional[Sequence] = None,
                processes: Optional[Sequence[int]] = None) -> Mesh:
    """Build a Mesh over ``devices`` (default: every process's CUDA devices,
    ``devices()``), in their order, ``processes`` naming each one's owner
    (default this process, or ``devices()``'s). A single ``-1`` absorbs all
    remaining devices."""
    if devices is None:
        devices, owners = _spanning(_cuda_devices())
        processes = owners if processes is None else processes
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
    owners = None if processes is None else np.asarray(processes).reshape(shape)
    return Mesh(grid.reshape(shape), axis_names, owners)


def default_mesh(refresh: bool = False) -> Mesh:
    """Process-wide default mesh: every process's CUDA devices on ``data``,
    model = 1. Raises where there is no CUDA device (``force_cpu_devices``
    sets a CPU one)."""
    global _default_mesh
    if _default_mesh is None or refresh:
        _default_mesh = create_mesh((-1, 1))
    return _default_mesh


def set_default_mesh(mesh: Mesh) -> None:
    global _default_mesh
    _default_mesh = mesh


def force_cpu_devices(n: int = 8) -> Mesh:
    """Make the default mesh ``n`` CPU devices of every process on ``data``
    (JAX's ``n`` virtual host devices) and return it; with several
    processes every one calls it together."""
    local, owners = _spanning([torch.device("cpu")] * n)
    mesh = create_mesh((-1, 1), devices=local, processes=owners)
    set_default_mesh(mesh)
    return mesh
