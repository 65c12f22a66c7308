"""Placements of batches and parameters on a mesh.

Counterpart of ``cra5_tpu/parallel/sharding.py``. The batch is sharded
over the dp axis (``Shard(0)``). ``vaeformer_param_specs`` /
``mesh_param_specs`` give, per port parameter name, the JAX package's
Megatron split (the fused ``qkv`` and ``fc1`` kernels column-sharded,
``proj`` and ``fc2`` row-sharded, replicated where the dim does not
divide) as a spec: a tuple of mesh axis names or None, one per dim of the
port's tensor (``()`` is replicated, as ``P()``). A port ``Linear`` weight
is the transpose of the flax kernel, so its spec is the flax spec
reversed.

The port computes each rank's part locally, so its own placement
(``tp_placement``) differs from the JAX spec in two ways. GSPMD cuts the
fused qkv columns into contiguous chunks (with tp = 2, chunk 0 holds all
of q and half of k) and reshards around the attention; a rank that
computes its own heads needs a head-aligned cut instead: the qkv weight
is viewed as [3, H, Dh, C] and split over H, its bias likewise, and
``proj`` over its input dim in the same head order. And attention whose
head count does not divide by tp stays replicated, qkv and proj both,
where JAX splits the columns (the same arithmetic, placed otherwise).
Every split is a ``Split`` (dim, groups): the dim viewed as [groups, n]
and cut over n, so each rank keeps n / tp of every group. ``shard_tensor``
and ``gather_tensor`` are the one pair that cuts a full tensor (the fused
layout every checkpoint holds) to a rank's shard and joins the shards
back, exact inverses of each other.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

from .mesh import axis_size

Spec = Tuple[Any, ...]
Split = Tuple[int, int]  # (dim, groups): the dim viewed as [groups, n], cut over n
Placement = Dict[str, Optional[Split]]  # None: replicated


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


def tp_placement(params: Mapping[str, Any], tp: int, heads: Mapping[str, int]) -> Placement:
    """The port's placement of every parameter at tensor parallelism
    ``tp``: a parameter the JAX spec splits (``mesh_param_specs``) is split
    here too, head-aligned (the fused qkv weight and bias as (0, 3),
    ``fc1``'s as (0, 1), ``proj`` and ``fc2`` over their input dim as
    (1, 1)), except the qkv and proj of an attention module whose head
    count (``heads``: module name -> heads) does not divide by tp, which
    stay replicated. ``params`` maps names to anything with a ``shape``."""
    specs = mesh_param_specs({"tp": tp}, params)
    out: Placement = {}
    for name, spec in specs.items():
        split = None
        if any(a is not None for a in spec):
            module, _ = name.rsplit(".", 1)
            owner, layer = module.rsplit(".", 1)
            if layer == "qkv":
                split = (0, 3)
            elif layer == "fc1":
                split = (0, 1)
            else:  # proj, fc2: the row-parallel input dim
                split = (1, 1)
            if owner in heads and heads[owner] % tp:
                split = None
        out[name] = split
    return out


def shard_tensor(full: torch.Tensor, split: Optional[Split], rank: int, tp: int) -> torch.Tensor:
    """Rank ``rank``'s shard (of ``tp``) of a full tensor: its dim
    ``split[0]`` viewed as [groups, n] and cut over n (a copy); the tensor
    itself when ``split`` is None."""
    if split is None:
        return full
    dim, groups = split
    parts = full.unflatten(dim, (groups, -1)).chunk(tp, dim + 1)
    return parts[rank].flatten(dim, dim + 1).contiguous()


def gather_tensor(shards: Sequence[torch.Tensor], split: Optional[Split]) -> torch.Tensor:
    """The full tensor of the ranks' shards in rank order: the inverse of
    ``shard_tensor``."""
    if split is None:
        return shards[0]
    dim, groups = split
    return torch.cat([s.unflatten(dim, (groups, -1)) for s in shards], dim + 1).flatten(dim, dim + 1)


def full_shape(shape: Sequence[int], split: Optional[Split], tp: int) -> Tuple[int, ...]:
    """The full shape of a shard of ``shape``."""
    shape = tuple(int(s) for s in shape)
    if split is None:
        return shape
    dim = split[0]
    return shape[:dim] + (shape[dim] * tp,) + shape[dim + 1:]


def shard_variables(mesh, variables: Dict[str, torch.Tensor],
                    placement: Placement) -> Dict[str, torch.Tensor]:
    """This rank's local shards of a tree of full tensors: each split
    parameter cut at this rank's index on the mesh's tp axis, the rest as
    they are. No communication (``distributed.put_tree`` broadcasts rank
    0's values first)."""
    from .mesh import axis_group

    _, tp, rank = axis_group(mesh, "tp")
    return {k: shard_tensor(v, placement.get(k), rank, tp) for k, v in variables.items()}
