"""Quantized-CDF construction for the rANS coders (numpy, integer-exact).

Counterpart of ``cra5_tpu/entropy/cdf.py``, kept as the port's own copy so
that nothing here imports the JAX package. ``pmf_to_quantized_cdf`` turns a
float PMF into an integer CDF summing to 2**precision, repairing zero
frequencies by stealing counts from the lowest-frequency symbol. The float
rounding emulates C's ``std::round`` on float32 (half away from zero) rather
than numpy's banker rounding: the tables must be identical integer for
integer on every platform, or streams stop cross-decoding.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


def pmf_to_quantized_cdf(pmf: Sequence[float], precision: int = 16) -> np.ndarray:
    pmf32 = np.asarray(pmf, dtype=np.float32)
    if pmf32.ndim != 1:
        raise ValueError("pmf must be 1-D")
    if np.any(pmf32 < 0) or not np.all(np.isfinite(pmf32)):
        raise ValueError("Invalid pmf: non-finite or negative element found")

    scale = np.float32(1 << precision)
    scaled = pmf32 * scale  # float32 multiply, like the C++ (float p * int)
    # std::round(float): half away from zero; pmf entries are >= 0.
    floor = np.floor(scaled)
    freq = (floor + (scaled - floor >= np.float32(0.5))).astype(np.uint64)

    total = int(freq.sum())
    if total == 0:
        raise ValueError("Invalid pmf: at least one element must be non-zero")

    one = 1 << precision
    scaled_freq = (np.uint64(one) * freq) // np.uint64(total)
    cdf_arr = np.zeros(len(freq) + 1, dtype=np.int64)
    np.cumsum(scaled_freq.astype(np.int64), out=cdf_arr[1:])
    cdf_arr[-1] = one

    # Zero-frequency repair: each zero-frequency symbol, in ascending order,
    # steals one count from the currently lowest-frequency symbol with
    # freq > 1 (first such index on ties).
    freqs = np.diff(cdf_arr)
    for i in np.flatnonzero(freqs == 0):
        candidates = np.where(freqs > 1, freqs, np.int64(1) << 62)
        j = int(np.argmin(candidates))
        if candidates[j] == np.int64(1) << 62:
            raise ValueError("Cannot repair cdf: no symbol to steal from")
        freqs[j] -= 1
        freqs[i] += 1

    cdf_arr[1:] = np.cumsum(freqs)
    if cdf_arr[0] != 0 or cdf_arr[-1] != one or np.any(np.diff(cdf_arr) <= 0):
        raise ValueError("cdf repair failed: not strictly increasing to 2**precision")
    return cdf_arr.astype(np.int32)


@dataclasses.dataclass
class CdfTable:
    """Per-index quantized CDF tables as consumed by the coders.

    quantized_cdf: (n, max_len+2) int32, row i holds a cdf of length
        cdf_length[i] (= pmf_length[i] + 2, incl. the leading 0 and the
        tail-mass bucket), zero padded.
    cdf_length:    (n,) int32
    offset:        (n,) int32 symbol offset (symbol - offset = cdf bin)
    """

    quantized_cdf: np.ndarray
    cdf_length: np.ndarray
    offset: np.ndarray

    @property
    def num_indexes(self) -> int:
        return self.quantized_cdf.shape[0]

    @property
    def max_length(self) -> int:
        return self.quantized_cdf.shape[1]

    def validate(self, precision: int = 16) -> None:
        """Raise ``AssertionError`` unless every row runs from 0 to
        2**precision, strictly increasing, over its ``cdf_length``."""
        one = 1 << precision
        for i in range(self.num_indexes):
            row = self.quantized_cdf[i, : int(self.cdf_length[i])]
            if not (row[0] == 0 and row[-1] == one):
                raise AssertionError(f"row {i} endpoints invalid")
            if not np.all(np.diff(row) > 0):
                raise AssertionError(f"row {i} not strictly increasing")


def build_cdf_table(
    pmfs: np.ndarray,
    tail_mass: np.ndarray,
    pmf_length: np.ndarray,
    precision: int = 16,
) -> CdfTable:
    """Row i codes pmf[i, :pmf_length[i]] ++ [tail_mass[i]]. Offsets are
    zero; the caller sets the real ones."""
    pmfs = np.asarray(pmfs)
    pmf_length = np.asarray(pmf_length, dtype=np.int64)
    tail_mass = np.asarray(tail_mass).reshape(-1)
    n = len(pmf_length)
    cdf = np.zeros((n, int(pmf_length.max()) + 2), dtype=np.int32)
    for i in range(n):
        prob = np.concatenate(
            [pmfs[i, : pmf_length[i]].astype(np.float32), np.float32([tail_mass[i]])]
        )
        row = pmf_to_quantized_cdf(prob, precision)
        cdf[i, : len(row)] = row
    return CdfTable(
        quantized_cdf=cdf,
        cdf_length=(pmf_length + 2).astype(np.int32),
        offset=np.zeros(n, dtype=np.int32),
    )
