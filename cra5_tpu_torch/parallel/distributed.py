"""Multi-process runtime: ``torch.distributed`` wiring and helpers.

Counterpart of ``cra5_tpu/parallel/distributed.py``. The JAX package runs
one process a host, joined into one mesh; the port runs one process a
device (a rank), joined into one ``torch.distributed`` world:

  - training uses the mesh's dp axis: each rank feeds its local batch
    (``make_global_batch``), and the gradients are all-reduced over dp
    (``train/loop.py``);
  - tensor parallelism uses the mesh's tp axis: the ranks of a tp group
    hold shards of the attention and MLP weights (``put_tree`` cuts them,
    ``fetch_tree`` joins them; ``tensor_parallel.py`` has the
    collectives) and see the same batch;
  - archive recompression is embarrassingly parallel: the files are split
    over the ranks (``local_work_slice``) and each rank codes its own.

The backend is ``nccl`` for CUDA devices and ``gloo`` for the CPU unless
``backend=`` names one; a backend that fails to start raises (nothing
falls back to another). Everything here is a no-op in single-process mode.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

_BUCKET_BYTES = 256 << 20  # tensors flattened into buckets of at most this for a collective
_barriers: Dict[str, int] = {}  # name -> how many kv_barriers of that name this process held


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def _torchrun_env() -> bool:
    return all(os.environ.get(k) for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"))


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    backend: Optional[str] = None,
    device=None,
) -> int:
    """Join (or skip joining) a multi-process world; returns this process's
    rank (0 in single-process mode).

    Resolution: explicit args > ``CRA5_TPU_COORDINATOR`` (``host:port``) /
    ``CRA5_TPU_NUM_PROCESSES`` / ``CRA5_TPU_PROCESS_ID`` > torchrun's
    ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE`` (the
    counterpart of the JAX package's Cloud-TPU auto path; read when
    ``CRA5_TPU_DISTRIBUTED=1`` or when torchrun set them). A no-op when
    nothing is configured, when ``num_processes == 1``, or when a world is
    joined already. ``device``: the device type the world's collectives run
    on (default: the card); ``local_device_ids[0]`` (else ``LOCAL_RANK``,
    else the rank modulo the visible cards) is this rank's card."""
    if dist.is_initialized():
        return dist.get_rank()
    coordinator = coordinator or os.environ.get("CRA5_TPU_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("CRA5_TPU_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("CRA5_TPU_PROCESS_ID")
    auto = os.environ.get("CRA5_TPU_DISTRIBUTED") == "1" or _torchrun_env()
    if coordinator is None and not auto:
        return 0  # single-process mode
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError(
                "init_distributed: coordinator set but num_processes/process_id missing "
                "(args or CRA5_TPU_NUM_PROCESSES/CRA5_TPU_PROCESS_ID)")
        init_method = f"tcp://{coordinator}"
    else:
        if not _torchrun_env():
            raise ValueError("CRA5_TPU_DISTRIBUTED=1 needs torchrun's MASTER_ADDR, MASTER_PORT, "
                             "RANK and WORLD_SIZE")
        init_method = "env://"
        num_processes, process_id = _env_int("WORLD_SIZE"), _env_int("RANK")
    if num_processes == 1:
        return 0
    from ..device import resolve_device

    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs: Dict[str, Any] = {}
    if dev.type == "cuda":
        if local_device_ids:
            index = int(local_device_ids[0])
        else:
            local = _env_int("LOCAL_RANK")
            index = (local if local is not None else process_id) % torch.cuda.device_count()
        torch.cuda.set_device(index)
        if backend == "nccl":
            kwargs["device_id"] = torch.device("cuda", index)  # start NCCL now, fail here
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, **kwargs)
    if dist.get_backend() != backend:
        raise RuntimeError(f"asked for backend {backend}, the world runs {dist.get_backend()}")
    return dist.get_rank()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the rank that owns side effects (checkpoint writes, logs)."""
    return process_index() == 0


def barrier(name: str = "barrier") -> None:
    """Block until every rank reaches this point. No-op single-process."""
    if process_count() > 1:
        dist.barrier()


def kv_barrier(name: str, timeout_s: float = 600.0) -> None:
    """A barrier through the world's key-value store (the TCPStore rank 0
    hosts): it dispatches no device work, so it can align ranks before the
    first collective or after the last. Rank 0 also waits until every
    other rank has seen the barrier open, since the store dies with rank
    0's process. No-op single-process."""
    n = process_count()
    if n == 1:
        return
    from torch.distributed.distributed_c10d import _get_default_store

    store = _get_default_store()
    gen = _barriers.get(name, 0)
    _barriers[name] = gen + 1
    key = f"cra5_kv_barrier/{name}/{gen}"
    timeout = datetime.timedelta(seconds=timeout_s)
    if store.add(f"{key}/arrived", 1) == n:
        store.set(f"{key}/open", b"1")
    store.wait([f"{key}/open"], timeout)
    if store.add(f"{key}/left", 1) == n:
        store.set(f"{key}/all_left", b"1")
    if dist.get_rank() == 0:
        store.wait([f"{key}/all_left"], timeout)


def make_global_batch(mesh, local_batch, spec: str = "dp"):
    """A global batch from this rank's local shard: a ``DTensor`` sharded
    over the mesh's ``spec`` axis whose local shard is ``local_batch`` (on
    the mesh's device type), so the global batch is local x the axis size
    in rank order. Single-process it is the batch itself, on that device."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device("cpu")
    local = torch.as_tensor(local_batch).to(dev)
    if process_count() == 1:
        return local
    placements = [Shard(0) if name == spec else Replicate() for name in mesh.mesh_dim_names]
    return DTensor.from_local(local, mesh, placements, run_check=False)


def _buckets(tensors: List[torch.Tensor]) -> List[List[int]]:
    """Indexes of ``tensors`` grouped by (device, dtype) into buckets of at
    most _BUCKET_BYTES (a larger tensor is a bucket of its own)."""
    groups: Dict[Any, List[List[int]]] = {}
    sizes: Dict[Any, int] = {}
    for i, t in enumerate(tensors):
        key = (t.device, t.dtype)
        nbytes = t.numel() * t.element_size()
        if key not in groups or sizes[key] + nbytes > _BUCKET_BYTES:
            groups.setdefault(key, []).append([])
            sizes[key] = 0
        groups[key][-1].append(i)
        sizes[key] += nbytes
    return [b for bs in groups.values() for b in bs]


@torch.no_grad()
def bucketed_(tensors: List[torch.Tensor], collective) -> None:
    """Run ``collective(flat)`` on the tensors flattened into buckets, and
    copy each bucket's result back in place."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    for idx in _buckets(tensors):
        group = [tensors[i] for i in idx]
        flat = _flatten_dense_tensors(group)
        collective(flat)
        for t, v in zip(group, _unflatten_dense_tensors(flat, group)):
            t.copy_(v)


def broadcast_(tensors: List[torch.Tensor], src: int = 0, group=None) -> None:
    """Every rank's ``tensors`` take rank ``src``'s values, in place."""
    if process_count() > 1:
        bucketed_(tensors, lambda flat: dist.broadcast(flat, src, group=group))


def all_reduce_mean_(tensors: List[torch.Tensor], group=None) -> None:
    """Every rank's ``tensors`` become the mean over the group's ranks."""
    n = dist.get_world_size(group) if process_count() > 1 else 1
    if n > 1:
        def mean(flat):
            dist.all_reduce(flat, group=group)
            flat.div_(n)
        bucketed_(tensors, mean)


def put_tree(mesh, tree: Dict[str, torch.Tensor], specs: Optional[Dict[str, Any]] = None
             ) -> Dict[str, torch.Tensor]:
    """Place a tree (a dict of full tensors) over the mesh: every rank
    takes the values of the mesh's first rank, in place (a broadcast; a
    no-op single-process), and a leaf that ``specs`` (a
    ``sharding.Placement``: name -> split or None) splits is cut to this
    rank's shard at its index on the mesh's tp axis. The result maps each
    name to this rank's tensor: the given one where it is replicated, a
    new one where it is split."""
    from .sharding import shard_variables

    src = int(mesh.mesh.flatten()[0]) if mesh is not None else 0
    broadcast_(list(tree.values()), src=src)
    if not specs or not any(specs.values()):
        return tree
    return shard_variables(mesh, tree, specs)


def fetch_tree(tree: Dict[str, Any], mesh=None, specs: Optional[Dict[str, Any]] = None
               ) -> Dict[str, Any]:
    """A full CPU copy of a tree: a sharded ``DTensor`` leaf is
    all-gathered, a leaf that ``specs`` (a ``sharding.Placement``) splits
    over the mesh's tp axis is all-gathered over that axis and joined into
    its full layout (``sharding.gather_tensor``; every rank of the tp group
    calls), any other tensor (replicated) is copied as it is."""
    from torch.distributed.tensor import DTensor

    from .mesh import axis_group
    from .sharding import gather_tensor

    group, tp, _ = axis_group(mesh, "tp")

    def fetch(name, leaf):
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        if not isinstance(leaf, torch.Tensor):
            return leaf
        leaf = leaf.detach()
        split = (specs or {}).get(name)
        if split is not None and tp > 1:
            parts = [torch.empty_like(leaf) for _ in range(tp)]
            dist.all_gather(parts, leaf.contiguous(), group=group)
            leaf = gather_tensor(parts, split)
        return leaf.cpu()

    return {k: fetch(k, v) for k, v in tree.items()}


def local_work_slice(n_items: int) -> slice:
    """The contiguous [start, stop) of a length-``n_items`` work list this
    rank owns."""
    pi, pc = process_index(), process_count()
    return slice(pi * n_items // pc, (pi + 1) * n_items // pc)
