"""Bound and quantization primitives with their training gradients.

Counterpart of ``cra5_tpu/entropy/ops.py``. ``torch.round`` rounds half to
even, as ``jnp.round`` does, so symbols agree with the JAX package exactly.
``lower_bound`` and ``quantize_ste`` are ``autograd.Function``s with the
custom gradients of the JAX package's ``custom_vjp``s.

``BatchRows`` stands where a generator stands when a data-parallel rank
computes some rows of a global batch (``train/loop.py``): each draw takes
the whole batch's noise and keeps the rank's rows.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

import torch


@dataclasses.dataclass(frozen=True)
class BatchRows:
    """Rows [start, stop) of a global batch of ``total`` rows: every draw
    takes the global batch's values from ``generator`` and keeps these
    rows, so a rank adds to its rows exactly what one device running the
    whole batch adds there (a CUDA draw's values depend on how many it
    draws, so a local draw would differ). ``dim`` is the dim of the drawn
    shape whose outermost factor is the batch (``along`` sets it)."""
    generator: torch.Generator
    start: int
    stop: int
    total: int
    dim: int = 0

    def along(self, dim: int) -> "BatchRows":
        return dataclasses.replace(self, dim=dim)

    def draw(self, shape: Sequence[int], fill: Callable[[Sequence[int], torch.Generator],
                                                        torch.Tensor]) -> torch.Tensor:
        rows = self.stop - self.start
        per = shape[self.dim] // rows
        full = list(shape)
        full[self.dim] = per * self.total
        return fill(full, self.generator).narrow(self.dim, per * self.start,
                                                 per * rows).contiguous()


Noise = Union[torch.Generator, BatchRows]


def along(generator: Optional[Noise], dim: int) -> Optional[Noise]:
    """``generator`` with its batch at ``dim`` (a plain generator as is)."""
    return generator.along(dim) if isinstance(generator, BatchRows) else generator


def draw(shape: Sequence[int], generator: Noise,
         fill: Callable[[Sequence[int], torch.Generator], torch.Tensor]) -> torch.Tensor:
    """``fill(shape, generator)``, or a ``BatchRows``' rows of it."""
    if isinstance(generator, BatchRows):
        return generator.draw(shape, fill)
    return fill(shape, generator)


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
    generator: Optional[Noise] = None,
) -> torch.Tensor:
    """"noise": inputs + uniform(-0.5, 0.5) noise in the inputs' dtype,
    drawn from ``generator`` (training; a ``BatchRows`` draws its rows of
    the global batch's noise); "ste": round(x - means) + means
    with the straight-through gradient; "dequantize": round(x - means) +
    means; "symbols": int32 round(x - means)."""
    if mode == "noise":
        if generator is None:
            raise ValueError("mode='noise' requires a generator")
        fill = lambda shape, g: torch.empty(shape, dtype=inputs.dtype, device=inputs.device
                                            ).uniform_(-0.5, 0.5, generator=g)
        return inputs + draw(inputs.shape, generator, fill)
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


def dequantize(inputs: torch.Tensor, means: Optional[torch.Tensor] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Integer symbols back to values: symbols + means in the means' dtype,
    or the symbols in ``dtype``."""
    if means is not None:
        return inputs.to(means.dtype) + means
    return inputs.to(dtype)


def compute_padding(in_h: int, in_w: int, *, out_h: Optional[int] = None,
                    out_w: Optional[int] = None, min_div: int = 1):
    """(pad, unpad), each (left, right, top, bottom), that take an
    in_h x in_w image to out_h x out_w (by default the next multiple of
    ``min_div``), centred; unpad is pad negated."""
    if out_h is None:
        out_h = (in_h + min_div - 1) // min_div * min_div
    if out_w is None:
        out_w = (in_w + min_div - 1) // min_div * min_div
    if out_h % min_div != 0 or out_w % min_div != 0:
        raise ValueError(f"Padded size not divisible by {min_div}")
    left = (out_w - in_w) // 2
    right = out_w - in_w - left
    top = (out_h - in_h) // 2
    bottom = out_h - in_h - top
    pad = (left, right, top, bottom)
    return pad, tuple(-p for p in pad)
