"""Rate-distortion-optimised quantisation as a vectorised tensor op.

Counterpart of ``cra5_tpu/ops/rdoq.py``. Each value picks, among round(x)
- 1, round(x) and round(x) + 1, the symbol that minimises
``lmbda * (x - q)**2 + bits(q)``: the bit cost of an in-range symbol is
``precision - log2(freq)`` of its bin in the quantized CDF row, and an
escape costs the row's tail bucket plus its bypass nibbles. Ties go to the
first candidate, as ``argmin`` does in both packages. Plain tensor code:
on the card the same ops run there, and no kernel stands behind it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..entropy.cdf import CdfTable

PRECISION = 16
BYPASS = 4


def _bits_tables(table: CdfTable) -> Tuple[np.ndarray, np.ndarray]:
    """(ncdfs, max_len) bit costs a bin, and (ncdfs,) tail-bucket bits."""
    cdf = table.quantized_cdf.astype(np.float64)
    freqs = np.maximum(cdf[:, 1:] - cdf[:, :-1], 1.0)
    bits = PRECISION - np.log2(freqs)
    cols = np.arange(bits.shape[1])[None, :]
    # bins at and past the tail bucket cost what the tail bucket costs
    tail_idx = (table.cdf_length - 2)[:, None]
    tail_bits = np.take_along_axis(bits, np.maximum(tail_idx, 0), axis=1)
    bits = np.where(cols < tail_idx, bits, tail_bits)
    return bits.astype(np.float32), tail_bits[:, 0].astype(np.float32)


def rdoq_costs(x: torch.Tensor, indexes: torch.Tensor, table: CdfTable,
               lmbda: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The three candidates of each value (int32, stacked on a new first
    axis) and their float32 costs, on x's device."""
    bits_np, tail_np = _bits_tables(table)
    dev = x.device
    bits_flat = torch.as_tensor(bits_np.reshape(-1), device=dev)
    tail_bits = torch.as_tensor(tail_np, device=dev)
    offsets = torch.as_tensor(table.offset.astype(np.int32), device=dev)
    max_values = torch.as_tensor((table.cdf_length - 2).astype(np.int32), device=dev)
    max_len = bits_np.shape[1]

    idx = indexes.to(device=dev, dtype=torch.int64)
    off, mv = offsets[idx], max_values[idx]
    r = torch.round(x).to(torch.int32)

    def cost(q: torch.Tensor) -> torch.Tensor:
        v = q - off
        in_range = (v >= 0) & (v < mv)
        in_bits = bits_flat[idx * max_len + v.clamp(0, max_len - 1)]
        # an escape: the tail bucket, then the bypass length and raw nibbles
        raw = torch.where(v < 0, -2 * v - 1, 2 * (v - mv))
        nb = torch.ceil(torch.log2(raw.to(torch.float32).clamp_min(1.0) + 1.0) / BYPASS)
        esc_bits = tail_bits[idx] + BYPASS * (1.0 + nb)
        rate = torch.where(in_range, in_bits, esc_bits)
        return lmbda * (x - q.to(x.dtype)).square() + rate

    cands = torch.stack([r - 1, r, r + 1])
    return cands, torch.stack([cost(q) for q in cands])


def rdoq(x: torch.Tensor, indexes: torch.Tensor, table: CdfTable, lmbda: float) -> torch.Tensor:
    """x: float32 values, means already subtracted; indexes: their CDF
    rows. Returns the int32 symbols, shaped like ``x``, on x's device."""
    cands, costs = rdoq_costs(x, indexes, table, lmbda)
    return cands.gather(0, costs.argmin(dim=0)[None])[0]
