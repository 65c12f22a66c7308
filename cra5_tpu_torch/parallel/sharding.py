"""Placements of batches and parameters on a mesh.

Counterpart of ``cra5_tpu/parallel/sharding.py``. The batch is sharded
over the dp axis (``Shard(0)``) and everything else is replicated
(``Replicate()``). ``vaeformer_param_specs`` / ``mesh_param_specs`` give,
per port parameter name, the JAX package's Megatron split (the fused
``qkv`` and ``fc1`` kernels column-sharded, ``proj`` and ``fc2`` row-
sharded, replicated where the dim does not divide) as a spec: a tuple of
mesh axis names or None, one per dim of the port's tensor (``()`` is
replicated, as ``P()``). A port ``Linear`` weight is the transpose of the
flax kernel, so its spec is the flax spec reversed.

Placing parameters by those specs is tensor parallelism, which waits for
ROADMAP.md queue A4b: the JAX split cuts the fused qkv columns into
contiguous chunks (with tp = 2, chunk 0 holds all of q and half of k),
which a port that computes locally cannot use as is. ``shard_variables``
raises.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Tuple

from .mesh import axis_size

Spec = Tuple[Any, ...]


def batch_sharding(mesh, axis: str = "dp") -> list:
    """The batch's placements: sharded on dim 0 over ``axis``."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names]


def replicate(mesh) -> list:
    from torch.distributed.tensor import Replicate

    return [Replicate()] * mesh.ndim


def _flax_keys(name: str) -> list:
    """The flax path of a port parameter: 'g_a.blocks.3.mlp.fc1.weight' ->
    ['g_a', 'blocks_3', 'mlp', 'fc1', 'kernel'] (a Linear's weight is the
    kernel)."""
    keys = re.sub(r"blocks\.(\d+)", r"blocks_\1", name).split(".")
    if keys[-1] == "weight":
        keys[-1] = "kernel"
    return keys


def _spec_for_param(name: str, tp_axis: str) -> Spec:
    """The JAX package's _spec_for_param, in the port's layout."""
    keys = _flax_keys(name)
    path = "/".join(keys)
    is_kernel, is_bias = keys[-1] == "kernel", keys[-1] == "bias"
    column, row = (tp_axis, None), (None, tp_axis)  # flax kernel specs, reversed
    if "mlp" in path or "quan_mlp" in path or "post_quan_mlp" in path:
        if "fc1" in path:
            if is_kernel:
                return column
            if is_bias:
                return (tp_axis,)
        if "fc2" in path and is_kernel:
            return row
    if "attn" in path:
        if "qkv" in path:
            if is_kernel:
                return column
            if is_bias:
                return (tp_axis,)
        if "proj" in path and is_kernel:
            return row
    return ()


def vaeformer_param_specs(params: Dict[str, Any], tp_axis: str = "tp") -> Dict[str, Spec]:
    """The Megatron spec of every parameter, by port name."""
    return {name: _spec_for_param(name, tp_axis) for name in params}


def mesh_param_specs(mesh, params: Dict[str, Any], tp_axis: str = "tp") -> Dict[str, Spec]:
    """Per-parameter specs for this mesh (a DeviceMesh or an axis -> size
    mapping): the Megatron split where the mesh has a tp axis of more than
    one device AND the dim divides, replicated otherwise. ``params`` maps
    names to anything with a ``shape``."""
    tp = axis_size(mesh, tp_axis)

    def spec_of(name, leaf) -> Spec:
        spec = _spec_for_param(name, tp_axis) if tp > 1 else ()
        for dim, axis in enumerate(spec):
            if axis is not None and leaf.shape[dim] % tp:
                return ()
        return spec

    return {name: spec_of(name, leaf) for name, leaf in params.items()}


def check_no_tp(mesh, tp_axis: str = "tp") -> None:
    """Raise on a mesh with a tp axis of more than one device."""
    if axis_size(mesh, tp_axis) > 1:
        raise NotImplementedError(
            f"a {tp_axis} axis of {axis_size(mesh, tp_axis)} devices is tensor parallelism, "
            f"which waits for ROADMAP.md queue A4b (a head-aligned qkv split and local head "
            f"counts in Attention); use a dp (and sp) mesh")


def shard_variables(mesh, variables: Dict[str, Any], tp_axis: str = "tp") -> Dict[str, Any]:
    """Tensor-parallel placement of a variables tree: ROADMAP.md queue A4b."""
    raise NotImplementedError("shard_variables (tensor-parallel parameters) waits for "
                              "ROADMAP.md queue A4b; the port replicates parameters (put_tree)")
