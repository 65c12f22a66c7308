"""The net/aux optimizer split, with optax's arithmetic.

Counterpart of ``cra5_tpu/train/optim.py``: the aux optimizer trains only
the entropy bottleneck's ``quantiles`` (Adam at a constant rate); the net
optimizer trains everything else, clipping the net gradients by their
global norm and then applying Adam at the scheduled rate. The rules are
optax's, not ``torch.optim``'s:

  - clipping scales by ``max_norm / norm`` only when ``norm >= max_norm``
    (``clip_grad_norm_`` uses ``max_norm / (norm + 1e-6)``);
  - Adam: b1 = 0.9, b2 = 0.999, eps = 1e-8 outside the square root,
    eps_root = 0 inside it, bias-corrected moments;
  - update i (counted from 0) uses the rate ``schedule(i)``.

Parameters and moments are updated in place (the JAX package returns new
trees); the gradients are consumed.

Under tensor parallelism each rank holds shards of some parameters
(``split``, their names) and whole copies of the rest. The clip's global
norm then sums the shards' squares over the tp group (``tp_group``) and
counts each replicated parameter once, as the norm of the whole tree;
every rank gets the same norm, so the replicated parameters stay equal.
Adam is elementwise and runs on the shards as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Collection, Dict, List, Optional, Union

import torch

from .schedulers import Schedule, build_schedule

B1, B2, EPS = 0.9, 0.999, 1e-8


def is_aux(name: str) -> bool:
    """'aux' parameters are the entropy bottleneck's quantiles."""
    return name.split(".")[-1] == "quantiles"


@dataclasses.dataclass
class OptState:
    mu: Dict[str, torch.Tensor]  # first moments, by parameter name
    nu: Dict[str, torch.Tensor]  # second moments
    count: int = 0  # updates applied so far


def _adam_(params: List[torch.Tensor], grads: List[torch.Tensor], mu: List[torch.Tensor],
           nu: List[torch.Tensor], count: int, lr: float) -> None:
    """optax.scale_by_adam then scale(-lr), in place; count is the number
    of updates before this one."""
    if not params:
        return
    torch._foreach_mul_(mu, B1)
    torch._foreach_add_(mu, grads, alpha=1.0 - B1)
    torch._foreach_mul_(nu, B2)
    torch._foreach_addcmul_(nu, grads, grads, value=1.0 - B2)
    t = count + 1
    mu_hat = torch._foreach_div(mu, 1.0 - B1 ** t)
    denom = torch._foreach_div(nu, 1.0 - B2 ** t)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, EPS)
    torch._foreach_div_(mu_hat, denom)
    torch._foreach_add_(params, mu_hat, alpha=-lr)


def _global_norm(grads: List[torch.Tensor], is_shard: List[bool], tp_group) -> torch.Tensor:
    """The norm of the whole tree: the shards' squares summed over the tp
    group, the replicated tensors' counted once."""
    norms = torch.stack(torch._foreach_norm(grads))
    if tp_group is None or not any(is_shard):
        return torch.linalg.vector_norm(norms)
    import torch.distributed as dist

    mask = torch.tensor(is_shard, device=norms.device)
    squares = norms.square()
    sharded = torch.where(mask, squares, 0.0).sum()
    dist.all_reduce(sharded, group=tp_group)
    return (torch.where(mask, 0.0, squares).sum() + sharded).sqrt()


class NetAuxAdam:
    """``init(params) -> OptState``; ``update_(params, grads, state)``
    applies one update in place."""

    def __init__(self, net_lr: Union[float, Schedule], aux_lr: float, max_grad_norm: float):
        self.net_lr, self.aux_lr, self.max_grad_norm = net_lr, aux_lr, max_grad_norm

    def net_rate(self, count: int) -> float:
        return self.net_lr(count) if callable(self.net_lr) else self.net_lr

    def init(self, params: Dict[str, torch.Tensor]) -> OptState:
        zeros = lambda: {k: torch.zeros_like(p, memory_format=torch.preserve_format)
                         for k, p in params.items()}
        return OptState(mu=zeros(), nu=zeros(), count=0)

    @torch.no_grad()
    def update_(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                state: OptState, split: Collection[str] = (), tp_group=None) -> OptState:
        """``split``: the names of the parameters held as tensor-parallel
        shards, whose squares the clip's norm sums over ``tp_group``."""
        groups = {True: [], False: []}
        for name in params:
            groups[is_aux(name)].append(name)
        net, aux = groups[False], groups[True]
        net_grads = [grads[k] for k in net]
        if net_grads:
            norm = _global_norm(net_grads, [k in split for k in net], tp_group)
            factor = torch.where(norm < self.max_grad_norm, torch.ones_like(norm),
                                 self.max_grad_norm / norm)
            torch._foreach_mul_(net_grads, factor)
        for names, gs, lr in ((net, net_grads, self.net_rate(state.count)),
                              (aux, [grads[k] for k in aux], self.aux_lr)):
            _adam_([params[k] for k in names], gs, [state.mu[k] for k in names],
                   [state.nu[k] for k in names], state.count, lr)
        state.count += 1
        return state


def make_net_aux_optimizers(
    learning_rate: float = 1e-4,
    aux_learning_rate: float = 1e-3,
    max_grad_norm: float = 1.0,
    scheduler: Optional[dict] = None,
    total_steps: Optional[int] = None,
) -> NetAuxAdam:
    """``scheduler``: an optional schedule config dict (e.g.
    ``dict(type="WarmupCosineLR", warmup_steps=1000)``) for the net
    optimizer; the aux optimizer keeps a constant rate."""
    net_lr = build_schedule(scheduler, learning_rate, total_steps)
    return NetAuxAdam(net_lr, aux_learning_rate, max_grad_norm)
