"""Seeded initializers mirroring the flax ones the JAX package uses.

flax's ``truncated_normal(stddev)`` draws a standard normal truncated to
[-2, 2] and scales it by ``stddev`` as it is (the result's standard
deviation is 0.8796 * stddev); ``lecun_normal`` corrects for the
truncation, scaling by sqrt(1 / fan_in) / 0.8796 so that the result has
standard deviation sqrt(1 / fan_in). Values are
drawn in float32 from an explicit ``torch.Generator`` and then rounded to
the parameter's dtype. The draws differ from JAX's for the same seed; the
distributions are the same.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

_TRUNC_STD = 0.87962566103423978  # std of a standard normal cut to [-2, 2]


@torch.no_grad()
def trunc_normal_(t: torch.Tensor, stddev: float, generator: Optional[torch.Generator] = None,
                  scale: float = 1.0) -> torch.Tensor:
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    u.uniform_(lo, 1.0 - lo, generator=generator)
    z = torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)
    return t.copy_(z.clamp_(-2.0, 2.0) * stddev * scale)


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: Optional[torch.Generator] = None):
    return trunc_normal_(t, math.sqrt(1.0 / fan_in) / _TRUNC_STD, generator)


@torch.no_grad()
def init_linear_(lin: torch.nn.Linear, generator: Optional[torch.Generator] = None,
                 scale: float = 1.0) -> None:
    """The JAX package's Dense init: trunc_normal(0.02) times ``scale``,
    zero bias."""
    trunc_normal_(lin.weight, 0.02, generator, scale)
    if lin.bias is not None:
        lin.bias.zero_()
