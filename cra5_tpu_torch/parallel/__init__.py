"""Meshes, placements and the multi-process runtime of the port
(counterpart of ``cra5_tpu/parallel``)."""

from .distributed import (
    barrier,
    fetch_tree,
    init_distributed,
    is_primary,
    kv_barrier,
    local_work_slice,
    make_global_batch,
    process_count,
    process_index,
    put_tree,
)
from .mesh import local_device_count, make_mesh
from .sharding import (
    batch_sharding,
    gather_tensor,
    mesh_param_specs,
    replicate,
    shard_tensor,
    shard_variables,
    tp_placement,
    vaeformer_param_specs,
)
from .tensor_parallel import TPGroup, parallelize_, placement_of

__all__ = [
    "make_mesh",
    "local_device_count",
    "batch_sharding",
    "mesh_param_specs",
    "replicate",
    "vaeformer_param_specs",
    "shard_variables",
    "tp_placement",
    "shard_tensor",
    "gather_tensor",
    "TPGroup",
    "parallelize_",
    "placement_of",
    "barrier",
    "kv_barrier",
    "fetch_tree",
    "init_distributed",
    "is_primary",
    "local_work_slice",
    "make_global_batch",
    "process_count",
    "process_index",
    "put_tree",
]
