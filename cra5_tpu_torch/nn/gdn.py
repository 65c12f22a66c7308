"""Generalized Divisive Normalization (Ballé et al.) and its simplified form.

Counterpart of ``cra5_tpu/nn/gdn.py``. ``beta`` and ``gamma`` are stored
re-parameterised, as flax stores them (so converted weights carry across
as they are), and ``NonNegativeParam`` maps them to their effective
values in ``forward`` through ``entropy.ops.lower_bound``, whose gradient
is the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..entropy.ops import lower_bound


class NonNegativeParam:
    """sqrt-reparameterization keeping effective weights >= minimum."""

    def __init__(self, minimum: float = 0.0, eps: float = 2 ** -18):
        self.pedestal = eps ** 2
        self.bound = (minimum + self.pedestal) ** 0.5

    def init(self, x: np.ndarray) -> np.ndarray:
        return np.sqrt(np.maximum(x + self.pedestal, self.pedestal))

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        r = lower_bound(r, self.bound)
        return r * r - self.pedestal


class GDN(nn.Module):
    """y[c] = x[c] / sqrt(beta[c] + sum_k gamma[c,k] * x[k]^2) over NCHW
    (``inverse=True`` multiplies instead, for the synthesis transform)."""

    def __init__(self, channels: int, inverse: bool = False, beta_min: float = 1e-6,
                 gamma_init: float = 0.1, device=None):
        super().__init__()
        self.channels, self.inverse, self.gamma_init = channels, inverse, gamma_init
        self.beta_rp = NonNegativeParam(minimum=beta_min)
        self.gamma_rp = NonNegativeParam()
        self.beta = nn.Parameter(torch.empty(channels, device=device))
        self.gamma = nn.Parameter(torch.empty(channels, channels, device=device))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        """The flax init (deterministic): unit beta, gamma_init * I."""
        C = self.channels
        self.beta.copy_(torch.from_numpy(self.beta_rp.init(np.ones(C, np.float32))))
        self.gamma.copy_(torch.from_numpy(
            self.gamma_rp.init(self.gamma_init * np.eye(C, dtype=np.float32))))

    def _norm(self, v: torch.Tensor) -> torch.Tensor:
        gamma = self.gamma_rp(self.gamma)
        beta = self.beta_rp(self.beta)
        return torch.einsum("bchw,kc->bkhw", v, gamma) + beta[None, :, None, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.sqrt(self._norm(x * x))
        return x * norm if self.inverse else x / norm


class GDN1(GDN):
    """Simplified GDN: absolute value instead of square, no sqrt."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = self._norm(x.abs())
        return x * norm if self.inverse else x / norm
