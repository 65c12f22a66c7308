"""Bound and quantization primitives with their training gradients.

Counterpart of ``cra5_tpu/entropy/ops.py``. ``torch.round`` rounds half to
even, as ``jnp.round`` does, so symbols agree with the JAX package exactly.
``lower_bound`` and ``quantize_ste`` are ``autograd.Function``s with the
custom gradients of the JAX package's ``custom_vjp``s.
"""

from __future__ import annotations

from typing import Optional

import torch


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound: float):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp(x, min=bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        pass_through = (x >= ctx.bound) | (g < 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    """max(x, bound), computed in x's dtype. The gradient passes where
    x >= bound, or where it would push x upward (grad < 0)."""
    return _LowerBound.apply(x, bound)


class _QuantizeSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def quantize_ste(x: torch.Tensor) -> torch.Tensor:
    """round(x) with the identity (straight-through) gradient."""
    return _QuantizeSTE.apply(x)


def quantize(
    inputs: torch.Tensor,
    mode: str,
    means: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """"noise": inputs + uniform(-0.5, 0.5) noise in the inputs' dtype,
    drawn from ``generator`` (training); "ste": round(x - means) + means
    with the straight-through gradient; "dequantize": round(x - means) +
    means; "symbols": int32 round(x - means)."""
    if mode == "noise":
        if generator is None:
            raise ValueError("mode='noise' requires a generator")
        noise = torch.empty(inputs.shape, dtype=inputs.dtype, device=inputs.device)
        return inputs + noise.uniform_(-0.5, 0.5, generator=generator)
    outputs = inputs - means if means is not None else inputs
    if mode == "ste":
        outputs = quantize_ste(outputs)
        return outputs + means if means is not None else outputs
    outputs = torch.round(outputs)
    if mode == "dequantize":
        return outputs + means if means is not None else outputs
    if mode == "symbols":
        return outputs.to(torch.int32)
    raise ValueError(f"Invalid quantization mode: {mode!r}")
