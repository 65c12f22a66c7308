"""Factorized-prior ("entropy bottleneck") model and integer tables.

Counterpart of ``cra5_tpu/entropy/entropy_bottleneck.py``: the per-channel
monotone MLP with its init, the medians used to centre the z symbols, the
training forward (noise-quantized outputs and their likelihoods), the
quantile-fitting ``loss``, and ``eb_update``, which builds the CDF tables
on the host in float64. The parameters stay float32 under a bfloat16
model, as in the JAX package, and the promotions match: the first MLP
layer's product is rounded to the inputs' dtype (``preferred_element_type
= logits.dtype`` there), and everything after the first bias add is
float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from scipy.special import expit as sigmoid
from torch import nn

from .cdf import CdfTable, build_cdf_table
from .ops import along, lower_bound, quantize


def _logits_cumulative(params: dict, inputs: torch.Tensor, nfilters: int) -> torch.Tensor:
    """The monotone per-channel MLP. inputs: (C, 1, N) -> (C, 1, N). Each
    layer's product runs in the promoted dtype and is rounded to the
    dtype of its input."""
    logits = inputs
    for i in range(nfilters + 1):
        matrix = nn.functional.softplus(params[f"matrix{i}"])  # (C, f_out, f_in)
        acc = torch.promote_types(matrix.dtype, logits.dtype)
        prod = torch.matmul(matrix.to(acc), logits.to(acc)).to(logits.dtype)
        logits = prod + params[f"bias{i}"]
        if i < nfilters:
            logits = logits + torch.tanh(params[f"factor{i}"]) * torch.tanh(logits)
    return logits


class EntropyBottleneck(nn.Module):
    def __init__(
        self,
        channels: int,
        filters: Tuple[int, ...] = (3, 3, 3, 3),
        init_scale: float = 10.0,
        tail_mass: float = 1e-9,
        likelihood_bound: float = 1e-9,
        device=None,
    ):
        super().__init__()
        self.channels = channels
        self.filters = tuple(filters)
        self.init_scale = init_scale
        self.tail_mass = tail_mass
        self.likelihood_bound = likelihood_bound
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

    def _params_dict(self) -> dict:
        return {k: v for k, v in self.named_parameters() if k != "quantiles"}

    def likelihood(self, values: torch.Tensor) -> torch.Tensor:
        """values: (C, 1, N); P(the unit bin around each value)."""
        p, K = self._params_dict(), len(self.filters)
        lower = _logits_cumulative(p, values - 0.5, K)
        upper = _logits_cumulative(p, values + 0.5, K)
        return torch.sigmoid(upper) - torch.sigmoid(lower)

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None):
        """x: (B, C, *spatial) -> (outputs, likelihood), both shaped like x:
        additive uniform noise when training, else rounding around the
        medians."""
        perm = (1, 0) + tuple(range(2, x.dim()))
        xt = x.permute(perm)  # (C, B, ...)
        shape = xt.shape
        values = xt.reshape(shape[0], 1, -1)
        medians = self.medians().reshape(-1, 1, 1)
        mode = "noise" if training else "dequantize"
        # values is (C, 1, B * prod(spatial)): the batch is the outer factor of dim 2
        outputs = quantize(values, mode, means=medians, generator=along(generator, 2))
        likelihood = self.likelihood(outputs)
        if self.likelihood_bound > 0:
            likelihood = lower_bound(likelihood, self.likelihood_bound)
        return outputs.reshape(shape).permute(perm), likelihood.reshape(shape).permute(perm)

    def loss(self) -> torch.Tensor:
        """The quantile-fitting auxiliary loss; only the quantiles carry
        gradient."""
        p = {k: v.detach() for k, v in self._params_dict().items()}
        logits = _logits_cumulative(p, self.quantiles, len(self.filters))
        t = float(np.log(2.0 / self.tail_mass - 1.0))
        target = torch.tensor([-t, 0.0, t], dtype=torch.float32, device=logits.device)
        return (logits - target).abs().sum()

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
