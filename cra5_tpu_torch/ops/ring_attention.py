"""Ring attention: exact attention with the token axis sharded over ranks.

Counterpart of ``cra5_tpu/ops/ring_attention.py``: each rank keeps its Q
block and the K/V blocks travel around the ring, rank r sending to
(r + 1) % n, while an online softmax accumulates in float32 (the JAX
package's arithmetic: the running max starts at -1e30, the sum is floored
at 1e-30, the output is cast to q's dtype). The per-block products are
``torch.matmul``, as they are einsums outside any Pallas kernel in JAX.

The blocks move with ``dist.batch_isend_irecv`` (the send and the receive
of a step posted together, which keeps NCCL from the deadlock that
unpaired blocking send/recv can reach). Gloo's send and receive take CPU
tensors only, so a ring of CUDA tensors needs an NCCL group: it raises on
a gloo group rather than copying through the host. At one rank there is
no rotation, and any device works.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

_NEG_INF = -1e30


def _rotate(t: torch.Tensor, group) -> torch.Tensor:
    """This rank's block goes to the next rank; the previous rank's comes in."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(group, (r + 1) % n), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (r - 1) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def ring_attention_shard(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group=None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v: this rank's (B, H, N_local, D) blocks of a sequence sharded
    over ``group`` (default: the world) in rank order; returns this rank's
    output block."""
    n = dist.get_world_size(group) if dist.is_initialized() else 1
    if n > 1 and q.device.type == "cuda" and dist.get_backend(group) == "gloo":
        raise ValueError("ring attention on CUDA tensors needs an NCCL group: gloo's send and "
                         "receive take CPU tensors")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    B, H, Nl, _ = q.shape
    qf = q.float() * scale
    acc = torch.zeros_like(qf)
    m = torch.full((B, H, Nl, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Nl, 1), dtype=torch.float32, device=q.device)
    for step in range(n):
        logits = torch.matmul(qf, k.float().transpose(-1, -2))
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        p = torch.exp(logits - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, v.float())
        m = m_new
        if step < n - 1:  # the JAX loop's last rotation only brings the blocks home
            k, v = _rotate(k.contiguous(), group), _rotate(v.contiguous(), group)
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                           axis_name: str = "sp", scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v: the whole (B, H, N, D) on every rank, N divisible by the
    mesh axis' size. Each rank takes its contiguous token block, the ring
    runs over the axis, and the blocks are all-gathered: every rank returns
    the whole output."""
    group = mesh.get_group(axis_name) if mesh is not None else None
    n = dist.get_world_size(group) if dist.is_initialized() else 1
    if q.shape[2] % n:
        raise ValueError(f"{q.shape[2]} tokens do not split over {n} ranks")
    r = dist.get_rank(group) if n > 1 else 0
    blk = q.shape[2] // n
    local = [t[:, :, r * blk:(r + 1) * blk].contiguous() for t in (q, k, v)]
    out = ring_attention_shard(*local, group=group, scale=scale)
    if n == 1:
        return out
    parts = [torch.empty_like(out) for _ in range(n)]
    dist.all_gather(parts, out, group=group)
    return torch.cat(parts, dim=2)
