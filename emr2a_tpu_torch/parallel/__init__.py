"""The mesh, its data axis and its model axis (port of
``emr2a_tpu/parallel``): a process drives every local device of a
``Mesh``, and ``initialize_distributed`` joins several processes into one
mesh; see ``mesh.py``, ``sharding.py`` (the data axis) and ``tensor.py``
(the model axis)."""

from emr2a_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    create_mesh,
    default_mesh,
    force_cpu_devices,
    initialize_distributed,
    local_device_count,
    local_devices,
    process_count,
    process_index,
    require_local,
    set_default_mesh,
    shutdown_distributed,
)
from emr2a_tpu_torch.parallel.sharding import (
    batch_sharding,
    data_devices,
    gather_batch,
    local_shards,
    replicated,
    shard_batch,
    shard_owners,
)
from emr2a_tpu_torch.parallel.tensor import (
    all_gather,
    all_reduce,
    check_mesh,
    model_axis_size,
    model_devices,
    reduce_to,
    replicate,
    shard_params,
    unshard_param,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "create_mesh",
    "default_mesh",
    "force_cpu_devices",
    "initialize_distributed",
    "local_device_count",
    "local_devices",
    "process_count",
    "process_index",
    "require_local",
    "set_default_mesh",
    "shutdown_distributed",
    "batch_sharding",
    "data_devices",
    "gather_batch",
    "local_shards",
    "replicated",
    "shard_batch",
    "shard_owners",
    "all_gather",
    "all_reduce",
    "check_mesh",
    "model_axis_size",
    "model_devices",
    "reduce_to",
    "replicate",
    "shard_params",
    "unshard_param",
]
