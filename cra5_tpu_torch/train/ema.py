"""Exponential moving average of the parameters, with warmup decay.

Counterpart of ``cra5_tpu/train/ema.py``: the effective decay is
``min(decay, (1 + n) / (10 + n))`` at the n-th update (from 1). The JAX
package returns a new tree each step; here the shadow copies are updated
in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass
class EmaState:
    params: Dict[str, torch.Tensor]  # shadow copies, by parameter name
    steps: int = 0


def ema_init(params: Dict[str, torch.Tensor]) -> EmaState:
    return EmaState(params={k: p.detach().clone() for k, p in params.items()}, steps=0)


@torch.no_grad()
def ema_update_(state: EmaState, new_params: Dict[str, torch.Tensor],
                decay: float = 0.9999) -> EmaState:
    """e <- e - (1 - d) (e - p), in place."""
    state.steps += 1
    d = min(decay, (1.0 + state.steps) / (10.0 + state.steps))
    ema = list(state.params.values())
    diff = torch._foreach_sub(ema, [new_params[k].detach() for k in state.params])
    torch._foreach_mul_(diff, 1.0 - d)
    torch._foreach_sub_(ema, diff)
    return state
