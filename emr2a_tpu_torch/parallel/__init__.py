"""The mesh and its data axis (port of ``emr2a_tpu/parallel``): one process
drives every device of a ``Mesh``; see ``mesh.py`` and ``sharding.py``."""

from emr2a_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    create_mesh,
    default_mesh,
    force_cpu_devices,
    initialize_distributed,
    local_device_count,
    set_default_mesh,
)
from emr2a_tpu_torch.parallel.sharding import (
    batch_sharding,
    data_devices,
    gather_batch,
    replicated,
    shard_batch,
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
    "set_default_mesh",
    "batch_sharding",
    "data_devices",
    "gather_batch",
    "replicated",
    "shard_batch",
]
