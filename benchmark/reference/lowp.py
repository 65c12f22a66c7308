"""Matrix products at a chosen precision.

"fp32" multiplies the float32 operands as they are (the caller switches
TF32 off). The controls round both operands first and multiply in float32:
"tf32" to TF32's 10-bit mantissa (round to nearest, ties away), "fp8" to
float8 e4m3 with one scale a tensor (the operand's largest magnitude maps
to 448), the step below float32 and below bfloat16 that a later change
might take.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def _tf32(t: torch.Tensor) -> torch.Tensor:
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF  # round the 13 dropped bits, ties away
    return bits.view(torch.float32)


def _fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.abs().amax().clamp(min=1e-30)
    scale = E4M3_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def rounded(t: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "fp32":
        return t
    if prec == "tf32":
        return _tf32(t.float())
    if prec == "fp8":
        return _fp8(t.float())
    raise ValueError(f"unknown precision {prec!r}")


class _Round(torch.autograd.Function):
    """Rounds in the forward; the gradient passes through."""

    @staticmethod
    def forward(ctx, t, prec):
        return rounded(t, prec)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundGrad(torch.autograd.Function):
    """The identity in the forward; rounds the gradient in the backward, so
    the backward's products also take rounded operands."""

    @staticmethod
    def forward(ctx, t, prec):
        ctx.prec = prec
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return rounded(g, ctx.prec), None


def r(t: torch.Tensor, prec: str) -> torch.Tensor:
    return t if prec == "fp32" else _Round.apply(t, prec)


def matmul(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "fp32":
        return torch.matmul(a, b)
    return _RoundGrad.apply(torch.matmul(r(a, prec), r(b, prec)), prec)
