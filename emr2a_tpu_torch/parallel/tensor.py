"""The model axis: Megatron placement and the collectives, by peer copies.

JAX's ``shard_map`` / SPMD programs place each parameter by its
``PartitionSpec`` and let XLA insert the collectives. The port keeps JAX's
single controller: one Python thread issues every card's work in turn, and
data moves between cards by PyTorch's stream-ordered peer copies (no NCCL:
``torch.distributed`` needs a process a rank).

- ``model_devices``: the devices of ``model`` at index 0 of ``data`` (JAX
  runs every data replica of a replicated computation; the port runs one);
- ``shard_params``: a state dict cut by ``training/sharding_rules.
  spec_for_param`` into equal chunks in card order, one state dict per card
  (a replicated leaf whole on each), and ``unshard_param`` its inverse;
- ``replicate``: a tensor's copy on each card;
- ``reduce_to`` / ``all_reduce``: the sum of the cards' partials, added in
  card order 0..n-1 in f32 (then cast back), on one device or on each, so
  every card holds the same bits and a CPU mesh gets the same sum in the
  same order;
- ``all_gather``: the cards' slices of a dimension concatenated in card
  order, on each card (a replicated row-parallel projection, such as a
  quantized one, takes its whole input this way).

Every function is differentiable: autograd carries the copies, so the
trainer's backward through them needs no hand-written collective. With one
card each is the identity: ``x.to(its own device)`` is ``x`` itself and a
one-term sum is its term.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from emr2a_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, require_local
from emr2a_tpu_torch.parallel.sharding import data_devices


def check_mesh(mesh) -> None:
    """A ``mesh`` argument is the port's ``parallel.Mesh`` (a JAX mesh or any
    other object raises ``TypeError``) of this process's devices
    (``ValueError`` otherwise: the model axis runs in one process)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be an emr2a_tpu_torch.parallel.Mesh, got "
                        f"{type(mesh).__name__}")
    require_local(mesh, "the model axis")


def model_axis_size(mesh: Optional[Mesh]) -> int:
    """The size of the mesh's ``model`` axis; 1 without a mesh or axis."""
    return 1 if mesh is None else int(mesh.shape.get(MODEL_AXIS, 1))


def model_devices(mesh: Mesh) -> List[torch.device]:
    """The devices of ``model`` at index 0 of every other axis, in card
    order: where the model's shards live."""
    if MODEL_AXIS not in mesh.axis_names:
        require_local(mesh, "the model axis")
        return [mesh.devices.flat[0]]
    return data_devices(mesh, MODEL_AXIS)


def shard_dim(spec) -> Optional[int]:
    """The dimension a spec shards over ``model``, or None (replicated)."""
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def shard_tensor(value: torch.Tensor, spec, devices: Sequence[torch.device]
                 ) -> List[torch.Tensor]:
    """``value`` cut by ``spec`` into equal chunks in card order, chunk c on
    ``devices[c]`` (a replicated value whole on each). Each chunk is a copy
    that owns its storage, the one on ``value``'s own device too: a view
    would keep the whole tensor resident there after its source is
    dropped."""
    dim = shard_dim(spec)
    n = len(devices)
    if dim is None or n == 1:
        return [value.to(d) for d in devices]
    if value.shape[dim] % n:
        raise ValueError(f"dimension {dim} of a {tuple(value.shape)} leaf does not "
                         f"divide by the {n} cards of the model axis")
    return [c.to(d, copy=True, memory_format=torch.contiguous_format)
            for c, d in zip(value.chunk(n, dim), devices)]


def unshard_param(chunks: Sequence[torch.Tensor], spec,
                  device=None) -> torch.Tensor:
    """The whole tensor from ``shard_tensor``'s chunks (a replicated leaf:
    the first copy), on ``device`` (default: the first chunk's)."""
    device = chunks[0].device if device is None else torch.device(device)
    dim = shard_dim(spec)
    if dim is None or len(chunks) == 1:
        return chunks[0].to(device)
    return torch.cat([c.to(device) for c in chunks], dim=dim)


def shard_params(state: Dict[str, torch.Tensor], mesh: Mesh,
                 devices: Optional[Sequence[torch.device]] = None
                 ) -> List[Dict[str, torch.Tensor]]:
    """One state dict per card of the model axis (``devices``, default
    ``model_devices(mesh)``): each leaf cut by its ``spec_for_param`` into
    equal chunks in card order, a replicated leaf whole on each card."""
    from emr2a_tpu_torch.training.sharding_rules import spec_for_param
    devices = list(devices or model_devices(mesh))
    out: List[Dict[str, torch.Tensor]] = [{} for _ in devices]
    for key, value in state.items():
        for part, chunk in zip(out, shard_tensor(value, spec_for_param(key, value), devices)):
            part[key] = chunk
    return out


def replicate(x, devices: Sequence[torch.device]) -> list:
    """``x``'s copy on each device (``x`` itself where it already lies; a
    non-tensor, such as None or an int, is repeated)."""
    if not isinstance(x, torch.Tensor):
        return [x] * len(devices)
    return [x.to(d, non_blocking=True) for d in devices]


def reduce_to(partials: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The sum of ``partials`` on ``device``, added in card order in f32
    (the working dtype's rounding once, at the end); one partial is
    returned as it is, moved."""
    if len(partials) == 1:
        return partials[0].to(device)
    dtype = partials[0].dtype
    acc = partials[0].to(device).float()
    for p in partials[1:]:
        acc = acc + p.to(device, non_blocking=True).float()
    return acc.to(dtype)


def all_reduce(partials: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every card's copy of the sum of the cards' partials: card c gathers
    the n partials by peer copies and adds them in card order 0..n-1, so
    every card holds the same bits."""
    if len(partials) == 1:
        return [partials[0]]
    return [reduce_to(partials, p.device) for p in partials]


def all_gather(parts: Sequence[torch.Tensor], dim: int = -1) -> List[torch.Tensor]:
    """Every card's copy of the cards' slices concatenated on ``dim`` in card
    order (head-sharded activations made whole)."""
    if len(parts) == 1:
        return [parts[0]]
    return [torch.cat([q.to(p.device, non_blocking=True) for q in parts], dim=dim)
            for p in parts]
