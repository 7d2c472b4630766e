"""Placement over a mesh: replicas, batches split on dim 0, and the gather.

Port of ``emr2a_tpu/parallel/sharding.py``. JAX describes a placement with
a ``NamedSharding`` and lets ``device_put`` and XLA move the data; eager
PyTorch moves it here, so the helpers place and return tensors:

- ``data_devices``: the devices that hold the shards of an axis, in shard
  order (the axis's devices at index 0 of every other axis; JAX runs each
  shard on every device of the other axes, the port once); it and every
  helper below raise where a device belongs to another process
  (``mesh.require_local``);
- ``shard_owners``: (process, device) of each shard of an axis, for code
  that runs over several processes (the sharded database), and
  ``local_shards`` the positions of this process's;
- ``replicated``: a tensor's or a module's copy on each of them (one copy
  per distinct device: the CPU devices of a CPU mesh share one);
- ``batch_sharding`` / ``shard_batch``: dim 0 split into equal chunks, one
  per device, in order; dim 0 must divide by the axis size, as in JAX
  (callers pad);
- ``gather_batch``: the chunks back on one device, rows in order. The
  copies between cards are PyTorch's stream-ordered peer copies, so a
  gather to a card queues behind the shards' work without waiting on the
  host (a gather to the CPU waits for them).

JAX's ``with_sharding`` constrains a value's layout inside a jitted
program; eager PyTorch has no program to constrain, so it has no
counterpart here.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from emr2a_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    default_mesh,
    process_index,
    require_local,
)


def shard_owners(mesh: Optional[Mesh] = None, axis: str = DATA_AXIS
                 ) -> List[Tuple[int, torch.device]]:
    """(process, device) of each shard of ``axis``, in shard order."""
    mesh = mesh or default_mesh()
    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} is not one of {mesh.axis_names}")
    pos = mesh.axis_names.index(axis)
    index = tuple(slice(None) if i == pos else 0 for i in range(mesh.devices.ndim))
    return [(int(p), d) for p, d in zip(mesh.processes[index], mesh.devices[index])]


def local_shards(mesh: Optional[Mesh] = None, axis: str = DATA_AXIS) -> List[int]:
    """The positions along ``axis`` of the shards this process holds."""
    me = process_index()
    return [i for i, (p, _) in enumerate(shard_owners(mesh, axis)) if p == me]


def data_devices(mesh: Optional[Mesh] = None, axis: str = DATA_AXIS) -> List[torch.device]:
    """The devices of ``axis``, one per shard, in shard order; raises where
    one belongs to another process."""
    mesh = mesh or default_mesh()
    owners = shard_owners(mesh, axis)
    require_local(mesh, f"placing data on the {axis!r} axis")
    return [d for _, d in owners]


def _copy_to(obj, device: torch.device):
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    return copy.deepcopy(obj).to(device)


def replicated(obj, mesh: Optional[Mesh] = None, axis: str = DATA_AXIS) -> list:
    """``obj`` (a tensor or an ``nn.Module``) on each device of ``axis``.
    A module is moved to the first device itself, and deep-copied (before
    that move) to each other distinct device."""
    devices = data_devices(mesh, axis)
    distinct = list(dict.fromkeys(devices))
    placed = {d: _copy_to(obj, d) for d in distinct[1:]}
    placed[distinct[0]] = obj.to(distinct[0])
    return [placed[d] for d in devices]


@dataclass(frozen=True)
class BatchSharding:
    """Dim 0 of an ``ndim``-D array split into ``len(devices)`` equal
    chunks, chunk i on ``devices[i]``."""

    devices: Tuple[torch.device, ...]
    ndim: int


def batch_sharding(mesh: Optional[Mesh] = None, axis: str = DATA_AXIS,
                   ndim: int = 2) -> BatchSharding:
    """Shard dim 0 over ``axis``, replicate the rest."""
    return BatchSharding(tuple(data_devices(mesh, axis)), ndim)


def shard_batch(x: torch.Tensor, mesh: Optional[Mesh] = None,
                axis: str = DATA_AXIS) -> List[torch.Tensor]:
    """``x``'s chunks of dim 0, chunk i on the i-th device of ``axis``. Dim
    0 must divide by the axis size: callers pad."""
    devices = batch_sharding(mesh, axis, x.dim()).devices
    if x.shape[0] % len(devices):
        raise ValueError(f"dim 0 ({x.shape[0]}) does not divide by the "
                         f"{len(devices)} devices of {axis!r}: pad it first")
    size = x.shape[0] // len(devices)
    return [x[i * size:(i + 1) * size].to(d, non_blocking=d.type == "cuda")
            for i, d in enumerate(devices)]


def gather_batch(chunks: Sequence[torch.Tensor],
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """The chunks concatenated on dim 0 on ``device`` (default: the first
    chunk's), rows in chunk order."""
    device = chunks[0].device if device is None else torch.device(device)
    return torch.cat([c.to(device, non_blocking=device.type == "cuda")
                      for c in chunks])
