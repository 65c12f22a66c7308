"""Tensor parallelism: the Megatron split of attention and MLP over the
ranks of a mesh's tp axis.

Counterpart of what GSPMD derives in the JAX package from the specs of
``cra5_tpu/parallel/sharding.py``. The port computes locally, so the
collectives are explicit, two ``torch.autograd.Function``s over the tp
group:

  - ``CopyToTP``: identity forward, all-reduce of the gradient backward.
    It stands before the column-parallel ``qkv`` and ``fc1``, whose input
    every rank reads whole: each rank's input gradient is a partial sum
    over its columns, and without the reduction the LayerNorm and
    residual gradients would be partial sums too.
  - ``ReduceFromTP``: all-reduce forward, identity backward. It stands
    after the row-parallel ``proj`` and ``fc2``, whose products over each
    rank's share of the input dim are partial sums; the bias is added once,
    after the reduction (``nn/blocks.py::Dense``).

Both reduce in float32 and cast the sum to the tensor's dtype. The
row-parallel partial products are float32 themselves (the ``Dense`` of a
bfloat16 tower multiplies its bfloat16 values in float32), so a bf16 tower
rounds the sum once, as the one-device GEMM does with its float32
accumulator, and not once per rank; and gloo's all-reduce of bfloat16
tensors is not something to rely on.

``parallelize_(model, mesh)`` turns a model built whole into its tp
placement in place: ``sharding.tp_placement`` says which parameters are
cut, ``distributed.put_tree`` broadcasts rank 0's full values and keeps
each rank's shard, and every ``Attention`` and ``Mlp`` whose weights are
cut takes its local widths (``Attention.local_heads``) and gives its
``Dense`` layers their shards (``Dense.parallel_``). The model then holds
``model.tp`` (a ``TPGroup``) and ``model.tp_placement``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(eq=False)
class TPGroup:
    """The process group of a mesh's tp axis, its size and this rank's
    index in it. ``timing``: when a dict, the all-reduces add their
    seconds (after a device synchronize) under "forward_s" and
    "backward_s" and their count under "calls"."""

    group: Any
    size: int
    rank: int
    timing: Optional[Dict[str, float]] = None


def _all_reduce_f32(x: torch.Tensor, tp: TPGroup, where: str) -> torch.Tensor:
    """The sum over the tp group of ``x`` in float32, cast to x's dtype."""
    timing = tp.timing
    if timing is not None:
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
    total = torch.empty_like(x, dtype=torch.float32,
                             memory_format=torch.contiguous_format).copy_(x)
    dist.all_reduce(total, group=tp.group)
    total = total.to(x.dtype)
    if timing is not None:
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
        timing[where] = timing.get(where, 0.0) + time.perf_counter() - t0
        timing["calls"] = timing.get("calls", 0) + 1
    return total


class CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient summed over the tp group backward."""

    @staticmethod
    def forward(ctx, x, tp: TPGroup):
        ctx.tp = tp
        return x

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_f32(grad, ctx.tp, "backward_s"), None


class ReduceFromTP(torch.autograd.Function):
    """The sum over the tp group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, tp: TPGroup):
        return _all_reduce_f32(x, tp, "forward_s")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def model_placement(model: torch.nn.Module, tp: int):
    """``sharding.tp_placement`` of a model built whole: its parameters
    and the head count of each of its attention modules."""
    from ..nn.blocks import Attention
    from .sharding import tp_placement

    heads = {name: m.num_heads for name, m in model.named_modules() if isinstance(m, Attention)}
    return tp_placement(dict(model.named_parameters()), tp, heads)


def placement_of(model: torch.nn.Module) -> Dict[str, Any]:
    """The placement ``parallelize_`` gave the model ({} for a model that
    was not parallelized: every parameter whole)."""
    return getattr(model, "tp_placement", None) or {}


@torch.no_grad()
def parallelize_(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """Place a model built whole on the mesh's tp axis, in place (see the
    module docstring); a mesh whose tp axis has one device leaves it
    whole. Every rank of the mesh calls it: rank 0's values are
    broadcast."""
    from ..nn.blocks import Attention, Mlp
    from .distributed import put_tree
    from .mesh import axis_group

    if getattr(model, "tp", None) is not None:
        raise ValueError("the model is placed on a tp axis already")
    group, size, rank = axis_group(mesh, "tp")
    if size == 1:
        return model
    tp = TPGroup(group, size, rank)
    placement = model_placement(model, size)
    params = dict(model.named_parameters())
    local = put_tree(mesh, {k: p.data for k, p in params.items()}, placement)
    for name, p in params.items():
        if placement[name] is not None:
            p.data = local[name]
    for name, m in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, Attention) and placement[f"{pre}qkv.weight"] is not None:
            m.local_heads = m.num_heads // tp.size
            m.qkv.parallel_(tp, placement[f"{pre}qkv.weight"])
            m.proj.parallel_(tp, placement[f"{pre}proj.weight"])
        elif isinstance(m, Mlp) and placement[f"{pre}fc1.weight"] is not None:
            m.fc1.parallel_(tp, placement[f"{pre}fc1.weight"])
            m.fc2.parallel_(tp, placement[f"{pre}fc2.weight"])
    model.tp, model.tp_placement = tp, placement
    return model
