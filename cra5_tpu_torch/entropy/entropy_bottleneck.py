"""Factorized-prior ("entropy bottleneck") parameters and integer tables.

Counterpart of ``cra5_tpu/entropy/entropy_bottleneck.py``: the per-channel
monotone MLP parameters with their init, the medians used to centre the z
symbols, and ``eb_update``, which builds the CDF tables on the host in
float64. The parameters stay float32 under a bfloat16 model, as in the JAX
package. ``likelihood`` and ``loss`` wait for the training slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from scipy.special import expit as sigmoid
from torch import nn

from .cdf import CdfTable, build_cdf_table


class EntropyBottleneck(nn.Module):
    def __init__(
        self,
        channels: int,
        filters: Tuple[int, ...] = (3, 3, 3, 3),
        init_scale: float = 10.0,
        device=None,
    ):
        super().__init__()
        self.channels = channels
        self.filters = tuple(filters)
        self.init_scale = init_scale
        dims = (1,) + self.filters + (1,)
        for i in range(len(self.filters) + 1):
            shape = (channels, dims[i + 1], dims[i])
            self.register_parameter(
                f"matrix{i}", nn.Parameter(torch.empty(shape, device=device))
            )
            self.register_parameter(
                f"bias{i}",
                nn.Parameter(torch.empty(channels, dims[i + 1], 1, device=device)),
            )
            if i < len(self.filters):
                self.register_parameter(
                    f"factor{i}",
                    nn.Parameter(torch.empty(channels, dims[i + 1], 1, device=device)),
                )
        self.quantiles = nn.Parameter(torch.empty(channels, 1, 3, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The flax initializers: constant softplus-inverse matrices,
        uniform(-0.5, 0.5) biases, zero factors, quantiles (-s, 0, s)."""
        K = len(self.filters)
        dims = (1,) + self.filters + (1,)
        scale = self.init_scale ** (1.0 / (K + 1))
        for i in range(K + 1):
            getattr(self, f"matrix{i}").fill_(float(np.log(np.expm1(1.0 / scale / dims[i + 1]))))
            getattr(self, f"bias{i}").uniform_(-0.5, 0.5, generator=generator)
            if i < K:
                getattr(self, f"factor{i}").zero_()
        self.quantiles.copy_(
            torch.tensor([-self.init_scale, 0.0, self.init_scale]).expand_as(self.quantiles)
        )

    def medians(self) -> torch.Tensor:
        return self.quantiles[:, 0, 1]

    def params_numpy(self) -> dict:
        """{matrix0, bias0, factor0, ..., quantiles} as numpy arrays, the
        input of ``eb_update``."""
        return {k: v.detach().float().cpu().numpy() for k, v in self.named_parameters()}


def eb_params_from_variables(variables: dict, prefix: str = "") -> dict:
    """This module's {matrix0, bias0, ..., quantiles} from a flax variables
    tree given as nested dicts of numpy arrays."""
    params = variables.get("params", variables)
    for part in filter(None, prefix.split("/")):
        params = params[part]
    return {k: np.asarray(v) for k, v in params.items()}


def eb_update(params: dict, filters: Tuple[int, ...] = (3, 3, 3, 3), precision: int = 16) -> CdfTable:
    """Integer CDF tables from the EB params (host, float64)."""
    quantiles = np.asarray(params["quantiles"], dtype=np.float64)  # (C,1,3)
    medians = quantiles[:, 0, 1]

    minima = np.clip(np.ceil(medians - quantiles[:, 0, 0]).astype(np.int32), 0, None)
    maxima = np.clip(np.ceil(quantiles[:, 0, 2] - medians).astype(np.int32), 0, None)

    offset = -minima
    pmf_start = medians - minima
    pmf_length = maxima + minima + 1
    max_length = int(pmf_length.max())

    samples = np.arange(max_length, dtype=np.float64)[None, None, :] + pmf_start[:, None, None]

    def logits(v):
        x = v
        K = len(filters)
        for i in range(K + 1):
            m = np.asarray(params[f"matrix{i}"], dtype=np.float64)
            b = np.asarray(params[f"bias{i}"], dtype=np.float64)
            x = np.einsum("coi,cin->con", np.logaddexp(0.0, m), x) + b
            if i < K:
                f = np.asarray(params[f"factor{i}"], dtype=np.float64)
                x = x + np.tanh(f) * np.tanh(x)
        return x

    low = logits(samples - 0.5)
    up = logits(samples + 0.5)
    pmf = (sigmoid(up) - sigmoid(low))[:, 0, :]
    tail_mass = sigmoid(low[:, 0, :1]) + sigmoid(-up[:, 0, -1:])

    table = build_cdf_table(pmf, tail_mass, pmf_length, precision)
    table.offset = offset.astype(np.int32)
    return table
