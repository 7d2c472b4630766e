"""The port's mesh (``emr2a_tpu_torch/parallel``) against
``emr2a_tpu.parallel`` on the 8 CPU devices of tests/conftest.py:
``create_mesh``'s shapes, its ``-1`` rule and its errors equal JAX's; the
port's own rules (CUDA devices named once and present, no fallback to the
CPU, one process); the placement helpers; ``MeshConfig``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from emr2a_tpu import config as jax_config
from emr2a_tpu.parallel import mesh as jax_mesh
from emr2a_tpu_torch import config as port_config
from emr2a_tpu_torch.parallel import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    batch_sharding,
    create_mesh,
    data_devices,
    default_mesh,
    force_cpu_devices,
    gather_batch,
    initialize_distributed,
    local_device_count,
    replicated,
    shard_batch,
)
from emr2a_tpu_torch.parallel import mesh as port_mesh

CPU8 = ["cpu"] * 8


def _outcome(fn):
    try:
        mesh = fn()
    except ValueError as e:
        return f"ValueError: {e}"
    return dict(mesh.shape), tuple(mesh.axis_names), mesh.size


@pytest.mark.parametrize("shape,n", [
    ((-1, 1), 8), ((8, 1), 8), ((-1, 2), 8), ((2, -1), 8), ((4, 2), 8), ((-1, 4), 6),
    ((-1, -1), 8), ((-1, 3), 8), ((3, 2), 8), ((2, 2), 6), ((-1,), 5), ((1, 1, -1), 8),
])
def test_create_mesh_equals_jax(shape, n):
    """Shapes, the -1 rule and the ValueError texts, on the same device
    counts; a 1-D or 3-D shape with as many axis names."""
    names = (DATA_AXIS, MODEL_AXIS, "x")[:len(shape)]
    want = _outcome(lambda: jax_mesh.create_mesh(shape, names, jax.devices()[:n]))
    got = _outcome(lambda: create_mesh(shape, names, ["cpu"] * n))
    assert got == want


def test_mesh_shape_axes_and_devices():
    mesh = create_mesh((4, 2), devices=CPU8)
    assert mesh.shape == {DATA_AXIS: 4, MODEL_AXIS: 2} and mesh.shape[DATA_AXIS] == 4
    assert mesh.size == 8 and mesh.devices.shape == (4, 2)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert data_devices(mesh) == [torch.device("cpu")] * 4
    assert data_devices(mesh, MODEL_AXIS) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="axis 'nope'"):
        data_devices(mesh, "nope")
    with pytest.raises(ValueError, match="axis names"):
        Mesh(np.array(CPU8, dtype=object).reshape(4, 2), (DATA_AXIS,))


def test_cuda_devices_are_named_once_and_must_exist():
    """Only CPU devices repeat; a CUDA device named twice, one without an
    index, or one that is not there is refused (this host has no card, so
    every CUDA device is missing)."""
    with pytest.raises(ValueError, match="may appear once"):
        create_mesh((2, 1), devices=["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="with their index"):
        create_mesh((1, 1), devices=["cuda"])
    missing = f"cuda:{torch.cuda.device_count()}"
    with pytest.raises(ValueError, match="not among the"):
        create_mesh((1, 1), devices=[missing])
    with pytest.raises(ValueError, match="CPU or CUDA"):
        create_mesh((1, 1), devices=["meta"])


def test_default_mesh_raises_without_a_card_and_force_cpu_devices():
    """The default mesh is every CUDA device; where there is none it raises
    and does not fall back to the CPU. ``force_cpu_devices`` sets a CPU
    one, as JAX's sets n virtual host devices."""
    saved = port_mesh._default_mesh
    try:
        port_mesh.set_default_mesh(None)
        if torch.cuda.device_count() == 0:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                default_mesh()
            with pytest.raises(RuntimeError, match="no CUDA device"):
                create_mesh()
        assert local_device_count() == torch.cuda.device_count()
        forced = force_cpu_devices(4)
        assert default_mesh() is forced and forced.shape == {DATA_AXIS: 4, MODEL_AXIS: 1}
    finally:
        port_mesh.set_default_mesh(saved)


def test_initialize_distributed_one_process_only():
    """One process is a no-op (no process group); for more, bad arguments
    raise ``ValueError`` before any connection is tried, and NCCL where
    this PyTorch has none raises rather than switching to gloo (the
    processes themselves run in tests/test_torch_processes.py)."""
    initialize_distributed()
    initialize_distributed(num_processes=1, process_id=0)
    initialize_distributed("localhost:1234", num_processes=1, process_id=0)
    assert not torch.distributed.is_initialized()
    assert (port_mesh.process_index(), port_mesh.process_count()) == (0, 1)
    for kw, match in ((dict(process_id=2), r"process_id must be in \[0, 2\)"),
                      (dict(process_id=-1), "process_id must be in"),
                      (dict(process_id=None), "process_id must be in"),
                      (dict(process_id=0, coordinator_address=None), "coordinator_address"),
                      (dict(process_id=0, coordinator_address=""), "coordinator_address"),
                      (dict(process_id=0, backend="mpi"), "backend must be")):
        kw = {"coordinator_address": "localhost:1234", **kw}
        with pytest.raises(ValueError, match=match):
            initialize_distributed(num_processes=2, **kw)
    if not torch.distributed.is_nccl_available():
        with pytest.raises(RuntimeError, match="no NCCL"):
            initialize_distributed("localhost:1234", num_processes=2, process_id=0)
    assert not torch.distributed.is_initialized()


def test_shard_batch_and_gather():
    """Dim 0 split into equal chunks, one per data device, in order (JAX's
    contract: it must divide, callers pad); the gather puts them back."""
    mesh = create_mesh((4, 2), devices=CPU8)
    x = torch.arange(24.0).reshape(8, 3)
    spec = batch_sharding(mesh, ndim=2)
    assert spec.devices == (torch.device("cpu"),) * 4 and spec.ndim == 2
    chunks = shard_batch(x, mesh)
    assert [c.shape for c in chunks] == [(2, 3)] * 4
    assert torch.equal(chunks[1], x[2:4])
    assert torch.equal(gather_batch(chunks), x)
    assert torch.equal(gather_batch(shard_batch(torch.zeros(0, 3), mesh)), torch.zeros(0, 3))
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(torch.zeros(6, 3), mesh)


def test_replicated_tensor_and_module():
    """One copy a data device; on a CPU mesh the devices are one, so the
    copies are one object (the first device takes the object itself)."""
    mesh = create_mesh((8, 1), devices=CPU8)
    t = torch.ones(3)
    copies = replicated(t, mesh)
    assert len(copies) == 8 and all(c is copies[0] for c in copies)
    lin = torch.nn.Linear(2, 2)
    mods = replicated(lin, mesh)
    assert len(mods) == 8 and all(m is lin for m in mods)


def test_mesh_config_equals_jax():
    want = dataclasses.asdict(jax_config.MeshConfig())
    got = dataclasses.asdict(port_config.MeshConfig())
    assert got == want
    cfg = port_config.MeshConfig()
    mesh = create_mesh(cfg.mesh_shape, cfg.axis_names, CPU8)
    assert mesh.shape == {"data": 8, "model": 1}
