"""Gaussian-conditional entropy model: scale table, CDF-row indexes, the
training likelihood and the integer tables (counterpart of
``cra5_tpu/entropy/gaussian_conditional.py``).

The erfc-based likelihood runs in float32 even under a bfloat16 model, as
in the JAX package: the scales and |values| are cast to float32 before
the CDF.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import scipy.special
import scipy.stats
import torch
from torch import nn

from .cdf import CdfTable, build_cdf_table
from .ops import lower_bound, quantize

SCALES_MIN = 0.11
SCALES_MAX = 256.0
SCALES_LEVELS = 64


def get_scale_table(
    smin: float = SCALES_MIN, smax: float = SCALES_MAX, levels: int = SCALES_LEVELS
) -> np.ndarray:
    return np.exp(np.linspace(math.log(smin), math.log(smax), levels)).astype(np.float32)


def build_indexes(
    scales: torch.Tensor, scale_table: torch.Tensor, scale_bound: float = SCALES_MIN
) -> torch.Tensor:
    """Each scale's CDF-table row: the number of table entries (excluding
    the last) strictly below the bounded scale. Both operands are float32,
    as in the JAX package: a scale equal to a table entry maps to that
    entry's row."""
    if scales.dtype != torch.float32 or scale_table.dtype != torch.float32:
        raise TypeError("build_indexes compares float32 scales with a float32 table")
    s = lower_bound(scales, scale_bound)
    idx = torch.searchsorted(scale_table[:-1].contiguous(), s.reshape(-1), right=False)
    return idx.to(torch.int32).reshape(scales.shape)


def _standardized_cumulative(x: torch.Tensor) -> torch.Tensor:
    """0.5 * erfc(-x / sqrt(2)) in float32; erfc keeps the tails precise."""
    return 0.5 * torch.special.erfc(-(2 ** -0.5) * x.float())


class GaussianConditional(nn.Module):
    """Mean-scale Gaussian likelihood of the noise-quantized latent. It has
    no parameters; ``forward`` returns (outputs, likelihood)."""

    def __init__(self, scale_bound: float = SCALES_MIN, likelihood_bound: float = 1e-9):
        super().__init__()
        self.scale_bound = scale_bound
        self.likelihood_bound = likelihood_bound

    def likelihood(self, inputs: torch.Tensor, scales: torch.Tensor,
                   means: Optional[torch.Tensor] = None) -> torch.Tensor:
        values = inputs - means if means is not None else inputs
        scales = lower_bound(scales.float(), self.scale_bound)
        values = values.abs().float()
        upper = _standardized_cumulative((0.5 - values) / scales)
        lower = _standardized_cumulative((-0.5 - values) / scales)
        return upper - lower

    def forward(self, inputs: torch.Tensor, scales: torch.Tensor,
                means: Optional[torch.Tensor] = None, training: bool = False,
                generator: Optional[torch.Generator] = None):
        mode = "noise" if training else "dequantize"
        outputs = quantize(inputs, mode, means=means, generator=generator)
        likelihood = self.likelihood(outputs, scales, means)
        if self.likelihood_bound > 0:
            likelihood = lower_bound(likelihood, self.likelihood_bound)
        return outputs, likelihood


def gc_update(scale_table: np.ndarray, tail_mass: float = 1e-9, precision: int = 16) -> CdfTable:
    """Per-scale integer CDF tables, built on the host in float64."""
    scale_table = np.asarray(scale_table, dtype=np.float64)
    multiplier = -scipy.stats.norm.ppf(tail_mass / 2)
    pmf_center = np.ceil(scale_table * multiplier).astype(np.int64)
    pmf_length = 2 * pmf_center + 1
    max_length = int(pmf_length.max())

    samples = np.abs(np.arange(max_length, dtype=np.int64) - pmf_center[:, None]).astype(np.float64)
    scales = scale_table[:, None]

    def std_cum(x):
        return 0.5 * scipy.special.erfc(-(2 ** -0.5) * x)

    upper = std_cum((0.5 - samples) / scales)
    lower = std_cum((-0.5 - samples) / scales)
    pmf = upper - lower
    tail = 2 * lower[:, :1]

    table = build_cdf_table(pmf, tail, pmf_length, precision)
    table.offset = (-pmf_center).astype(np.int32)
    return table
