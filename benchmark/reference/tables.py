"""Integer CDF tables of the two entropy models, built on the host in
float64 from the entropy parameters (a frozen copy of the algorithm that
``docs/FORMATS.md`` section 2 makes normative: 16-bit precision, the
frequency-stealing repair, C's half-away-from-zero rounding on float32).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import scipy.special
import scipy.stats

PRECISION = 16
SCALES_MIN, SCALES_MAX, SCALES_LEVELS = 0.11, 256.0, 64
TAIL_MASS = 1e-9
EB_FILTERS = (3, 3, 3, 3)


@dataclasses.dataclass
class Table:
    cdf: np.ndarray      # (rows, max_len + 2) int32, zero padded
    length: np.ndarray   # (rows,) int32: pmf length + 2
    offset: np.ndarray   # (rows,) int32


def quantized_cdf(pmf: np.ndarray) -> np.ndarray:
    pmf32 = np.asarray(pmf, dtype=np.float32)
    scaled = pmf32 * np.float32(1 << PRECISION)
    floor = np.floor(scaled)
    freq = (floor + (scaled - floor >= np.float32(0.5))).astype(np.uint64)
    total = int(freq.sum())
    one = 1 << PRECISION
    scaled_freq = (np.uint64(one) * freq) // np.uint64(total)
    cdf = np.zeros(len(freq) + 1, dtype=np.int64)
    np.cumsum(scaled_freq.astype(np.int64), out=cdf[1:])
    cdf[-1] = one
    freqs = np.diff(cdf)
    big = np.int64(1) << 62
    for i in np.flatnonzero(freqs == 0):
        candidates = np.where(freqs > 1, freqs, big)
        j = int(np.argmin(candidates))
        freqs[j] -= 1
        freqs[i] += 1
    cdf[1:] = np.cumsum(freqs)
    if cdf[-1] != one or np.any(np.diff(cdf) <= 0):
        raise ValueError("cdf repair failed")
    return cdf.astype(np.int32)


def _table(pmf: np.ndarray, tail: np.ndarray, length: np.ndarray) -> Table:
    n = len(length)
    cdf = np.zeros((n, int(length.max()) + 2), dtype=np.int32)
    for i in range(n):
        row = quantized_cdf(np.concatenate([pmf[i, :length[i]].astype(np.float32),
                                            np.float32([tail[i]])]))
        cdf[i, :len(row)] = row
    return Table(cdf, (length + 2).astype(np.int32), np.zeros(n, np.int32))


def scale_table() -> np.ndarray:
    return np.exp(np.linspace(math.log(SCALES_MIN), math.log(SCALES_MAX),
                              SCALES_LEVELS)).astype(np.float32)


def gaussian_table(scales: np.ndarray) -> Table:
    """One row per scale of the mean-scale Gaussian."""
    s = np.asarray(scales, dtype=np.float64)
    center = np.ceil(s * -scipy.stats.norm.ppf(TAIL_MASS / 2)).astype(np.int64)
    length = 2 * center + 1
    samples = np.abs(np.arange(int(length.max()))[None, :] - center[:, None]).astype(np.float64)
    cum = lambda v: 0.5 * scipy.special.erfc(-(2 ** -0.5) * v)
    upper, lower = cum((0.5 - samples) / s[:, None]), cum((-0.5 - samples) / s[:, None])
    table = _table(upper - lower, 2 * lower[:, 0], length)
    table.offset = (-center).astype(np.int32)
    return table


def eb_logits(p: dict, v: np.ndarray) -> np.ndarray:
    """The factorized prior's monotone MLP in float64; v: (C, 1, N)."""
    x = v
    k = len(EB_FILTERS)
    for i in range(k + 1):
        m = np.logaddexp(0.0, np.asarray(p[f"matrix{i}"], np.float64))
        x = np.einsum("coi,cin->con", m, x) + np.asarray(p[f"bias{i}"], np.float64)
        if i < k:
            x = x + np.tanh(np.asarray(p[f"factor{i}"], np.float64)) * np.tanh(x)
    return x


def factorized_table(p: dict) -> Table:
    """One row per channel of the factorized prior, from its parameters
    (``matrix{i}``, ``bias{i}``, ``factor{i}``, ``quantiles``)."""
    q = np.asarray(p["quantiles"], np.float64)
    med = q[:, 0, 1]
    lo = np.clip(np.ceil(med - q[:, 0, 0]).astype(np.int32), 0, None)
    hi = np.clip(np.ceil(q[:, 0, 2] - med).astype(np.int32), 0, None)
    length = (hi + lo + 1).astype(np.int64)
    samples = np.arange(int(length.max()), dtype=np.float64)[None, None, :] + (med - lo)[:, None, None]
    low, up = eb_logits(p, samples - 0.5), eb_logits(p, samples + 0.5)
    sig = scipy.special.expit
    pmf = (sig(up) - sig(low))[:, 0, :]
    tail = sig(low[:, 0, 0]) + sig(-up[:, 0, -1])
    table = _table(pmf, tail, length)
    table.offset = (-lo).astype(np.int32)
    return table
