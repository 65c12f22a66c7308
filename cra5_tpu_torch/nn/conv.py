"""Convolutional layers of the CompressAI-style image codecs, NCHW.

Counterpart of ``cra5_tpu/nn/conv.py``, with the same module names, so a
flax variables tree maps onto these modules path by path
(``convert.flax_layout``). Unlike flax, a PyTorch layer is told its input
channels when it is built.

  - ``conv2d``: a strided conv with padding k // 2 (``nn.Conv2d``, named
    ``conv`` inside, as flax names its ``nn.Conv``).
  - ``deconv2d``: the transposed conv of output size H * s. flax computes
    it as a VALID ``ConvTranspose`` cropped to ``[k//2, k//2 + H*s)``;
    ``conv_transpose2d(padding=k//2, output_padding=s-1)`` keeps exactly
    that window whenever s - 1 <= k // 2, which every zoo layer meets
    (5 x 5, stride 2). Its weight is ``ConvTranspose2d``'s (in, out, kh,
    kw), the flax kernel flipped, since flax applies its kernel flipped.
  - ``MaskedConv2d`` / ``CheckerboardMaskedConv2d`` store the raw kernel and
    apply the mask in ``forward``, as flax does, so gradients and
    converted weights agree.
  - ``qrelu``: the clamp to [0, 2^b - 1] with the relaxed gradient outside
    it, an ``autograd.Function`` with the JAX package's ``custom_vjp``.

The convolutions run ``torch.nn.functional.conv2d`` /
``conv_transpose2d`` in float32 with TF32 off (``device.resolve_device``),
and with cuDNN off (``native_conv``): on the card they then run
PyTorch's own im2col / col2im and cuBLAS GEMMs, which repeat bitwise, as
the codec's decode needs, where cuDNN's default transposed convs do not;
``python -m cra5_tpu_torch.profiling.conv_routes`` times the towers down
each route. ``reset_parameters_`` is the flax init: lecun-normal kernels,
zero biases, the GDN and EntropyBottleneck inits.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .gdn import GDN
from .init import lecun_normal_


def native_conv():
    """A context with cuDNN off, its other flags as they are: the zoo's
    convolutions run inside it."""
    c = torch.backends.cudnn
    return c.flags(enabled=False, benchmark=c.benchmark, benchmark_limit=c.benchmark_limit,
                   deterministic=c.deterministic, allow_tf32=c.allow_tf32)


class conv2d(nn.Module):
    """stride-s conv with 'same' padding (k // 2)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 5,
                 stride: int = 2, device=None):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride,
                              padding=kernel_size // 2, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with native_conv():
            return self.conv(x)


class deconv2d(nn.Module):
    """stride-s transposed conv: output H * s, the reference's deconv
    geometry (padding k // 2, output_padding s - 1)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 5,
                 stride: int = 2, device=None):
        super().__init__()
        p = kernel_size // 2
        if stride - 1 > p:
            raise ValueError(f"deconv2d: output_padding {stride - 1} past padding {p} leaves "
                             f"the VALID-and-crop window")
        self.conv = nn.ConvTranspose2d(in_channels, out_channels, kernel_size, stride,
                                       padding=p, output_padding=stride - 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with native_conv():
            return self.conv(x)


def _mask_A_B(kernel_size, mask_type: str, cin: int, cout: int) -> np.ndarray:
    """PixelCNN mask over the HWIO kernel layout."""
    kh, kw = kernel_size
    m = np.ones((kh, kw, cin, cout), np.float32)
    ch, cw = kh // 2, kw // 2
    m[ch, cw + (1 if mask_type == "B" else 0):, :, :] = 0
    m[ch + 1:, :, :, :] = 0
    return m


def _checkerboard_mask(k: int, cin: int, cout: int) -> np.ndarray:
    """Checkerboard mask over HWIO: anchor positions ((i + j) even) out."""
    m = np.ones((k, k, 1, 1), np.float32)
    ii, jj = np.meshgrid(np.arange(k), np.arange(k), indexing="ij")
    m[(ii + jj) % 2 == 0, :, :] = 0
    return np.broadcast_to(m, (k, k, cin, cout)).copy()


class _MaskedConv(nn.Module):
    """A stride-1 'same' conv whose raw OIHW ``weight`` is masked at call
    time."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 mask_hwio: np.ndarray, device=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size,
                                               kernel_size, device=device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))
        mask = torch.from_numpy(np.ascontiguousarray(mask_hwio.transpose(3, 2, 0, 1)))
        self.register_buffer("mask", mask.to(device), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with native_conv():
            return F.conv2d(x, self.weight * self.mask, self.bias, padding=self.kernel_size // 2)


class MaskedConv2d(_MaskedConv):
    """PixelCNN-style masked conv (the context models)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 5,
                 mask_type: str = "A", device=None):
        k = kernel_size
        super().__init__(in_channels, out_channels, k,
                         _mask_A_B((k, k), mask_type, in_channels, out_channels), device)
        self.mask_type = mask_type


class CheckerboardMaskedConv2d(_MaskedConv):
    """Checkerboard-masked conv (ELIC-style spatial context)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 5, device=None):
        k = kernel_size
        super().__init__(in_channels, out_channels, k,
                         _checkerboard_mask(k, in_channels, out_channels), device)


class subpel_conv3x3(nn.Module):
    """3x3 conv + pixel shuffle upsampling."""

    def __init__(self, in_channels: int, out_channels: int, upscale: int = 2, device=None):
        super().__init__()
        self.upscale = upscale
        self.conv = conv2d(in_channels, out_channels * upscale * upscale, 3, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.pixel_shuffle(self.conv(x), self.upscale)


class _QReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bit_depth: int, beta: int):
        ctx.save_for_backward(x)
        ctx.bit_depth, ctx.beta = bit_depth, beta
        return torch.clamp(x, 0.0, 2.0 ** bit_depth - 1)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        max_val = 2.0 ** ctx.bit_depth - 1
        alpha = -0.9943258522851727  # ln(2)/beta-derived constant from the paper
        inside = (x >= 0) & (x <= max_val)
        grad_out = g * torch.exp(alpha * torch.abs(2.0 * x / max_val - 1.0) ** ctx.beta)
        return torch.where(inside, g, grad_out), None, None


def qrelu(x: torch.Tensor, bit_depth: int = 8, beta: int = 100) -> torch.Tensor:
    """Clamped ReLU to [0, 2**bit_depth - 1] with a differentiable
    relaxation outside the bounds (Chandrasekar et al.)."""
    return _QReLU.apply(x, bit_depth, beta)


class QReLU(nn.Module):
    def __init__(self, bit_depth: int = 8, beta: int = 100):
        super().__init__()
        self.bit_depth, self.beta = bit_depth, beta

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return qrelu(x, self.bit_depth, self.beta)


class ResidualBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        self.conv1 = conv2d(in_channels, out_channels, 3, 1, device=device)
        self.conv2 = conv2d(out_channels, out_channels, 3, 1, device=device)
        self.skip = (conv2d(in_channels, out_channels, 1, 1, device=device)
                     if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.conv1(x), 0.01)
        h = F.leaky_relu(self.conv2(h), 0.01)
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class GDNStub(nn.Module):
    """A GDN named ``g``, as the JAX package nests it."""

    def __init__(self, channels: int, inverse: bool = False, device=None):
        super().__init__()
        self.g = GDN(channels, inverse=inverse, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.g(x)


class ResidualBlockWithStride(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 2, device=None):
        super().__init__()
        self.conv1 = conv2d(in_channels, out_channels, 3, stride, device=device)
        self.conv2 = conv2d(out_channels, out_channels, 3, 1, device=device)
        self.gdn = GDNStub(out_channels, device=device)
        self.skip = conv2d(in_channels, out_channels, 1, stride, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.conv1(x), 0.01)
        h = self.gdn(self.conv2(h))
        return self.skip(x) + h


class ResidualBlockUpsample(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, upscale: int = 2, device=None):
        super().__init__()
        self.subpel = subpel_conv3x3(in_channels, out_channels, upscale, device=device)
        self.conv = conv2d(out_channels, out_channels, 3, 1, device=device)
        self.igdn = GDNStub(out_channels, inverse=True, device=device)
        self.upsample = subpel_conv3x3(in_channels, out_channels, upscale, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.subpel(x), 0.01)
        h = self.igdn(self.conv(h))
        return self.upsample(x) + h


class _ResidualUnit(nn.Module):
    def __init__(self, channels: int, device=None):
        super().__init__()
        c = channels
        self.c1 = conv2d(c, c // 2, 1, 1, device=device)
        self.c2 = conv2d(c // 2, c // 2, 3, 1, device=device)
        self.c3 = conv2d(c // 2, c, 1, 1, device=device)

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.c1(v))
        h = F.relu(self.c2(h))
        return v + self.c3(h)


class AttentionBlock(nn.Module):
    """Cheng 2020's convolutional attention block."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        for i in range(3):
            setattr(self, f"trunk_{i}", _ResidualUnit(channels, device))
        for i in range(3):
            setattr(self, f"mask_{i}", _ResidualUnit(channels, device))
        self.mask_conv = conv2d(channels, channels, 1, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = x
        for i in range(3):
            a = getattr(self, f"trunk_{i}")(a)
        b = x
        for i in range(3):
            b = getattr(self, f"mask_{i}")(b)
        return x + a * torch.sigmoid(self.mask_conv(b))


@torch.no_grad()
def reset_parameters_(module: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """The flax initializers over every layer of ``module``: lecun-normal
    conv, transposed-conv and masked-conv kernels (fan-in in x kh x kw),
    zero biases, and the GDN's and EntropyBottleneck's own inits (the
    latter's uniform biases drawn from ``generator``). The draws differ
    from JAX's for the same seed; the distributions are the same."""
    from ..entropy import EntropyBottleneck

    for m in module.modules():
        if isinstance(m, (nn.Conv2d, _MaskedConv)):
            lecun_normal_(m.weight, m.weight[0].numel(), generator)
            m.bias.zero_()
        elif isinstance(m, nn.ConvTranspose2d):
            lecun_normal_(m.weight, m.weight.shape[0] * m.weight[0, 0].numel(), generator)
            m.bias.zero_()
        elif isinstance(m, (GDN, EntropyBottleneck)):
            m.reset_parameters(generator)
    return module
