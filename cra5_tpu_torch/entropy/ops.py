"""Bound and quantization primitives (inference forward only).

Counterpart of ``cra5_tpu/entropy/ops.py``. ``torch.round`` rounds half to
even, as ``jnp.round`` does, so symbols agree with the JAX package exactly.
The straight-through gradients wait for the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    """max(x, bound), computed in x's dtype."""
    return torch.clamp(x, min=bound)


def quantize(
    inputs: torch.Tensor, mode: str, means: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """"dequantize": round(x - means) + means; "symbols": int32
    round(x - means)."""
    outputs = inputs - means if means is not None else inputs
    outputs = torch.round(outputs)
    if mode == "dequantize":
        return outputs + means if means is not None else outputs
    if mode == "symbols":
        return outputs.to(torch.int32)
    raise ValueError(f"Invalid quantization mode: {mode!r}")
