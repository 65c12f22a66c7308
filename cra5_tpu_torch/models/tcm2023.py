"""TCM 2023 (Liu, Sun, Katto, "Learned Image Compression with Mixed
Transformer-CNN Architectures", CVPR 2023, arXiv:2303.14978), at its
published block (LIC_TCM ``models/tcm.py``).

ConvTransBlock stages (a residual-conv branch, ``ResidualBlock(c) + c``,
and a Swin branch over split channels, fused by a 1x1), residual down- and
up-sampling transforms, ConvTrans hyper transforms (z of
``hyper_channels`` = 192, hyper windows of 4), and the charm slice model
whose supports pass through SWAtten gates before the cc transforms. A
SWAtten gate is Cheng 2020's attention block on ``inter_dim`` channels
with a Swin pair (W, then SW) at the head of its mask branch, between a
1x1 in and a 1x1 out; its units end in a ReLU, as CompressAI's
``AttentionBlock`` units do (``nn/conv.py::_ResidualUnit``, which
cheng2020, ELIC and InvCompress share, has none). The latent residual
prediction reads the attended mean support. Every Swin block keeps its
window and shift at every input (``SwinBlock(fixed_window=True)``).

This is not the JAX package's form (window 4, a Swin trunk gate, the raw
support into the lrp, no second residual on the conv branch; ROADMAP
C21): the port's TCM is held to ``tests/reference_tcm2023.py``. Coding is
``stf2022.CharmCodec``'s (``CODEC_KIND = "charm"``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..entropy import EntropyBottleneck, GaussianConditional
from ..nn.conv import (
    ResidualBlock,
    ResidualBlockUpsample,
    ResidualBlockWithStride,
    conv2d,
    subpel_conv3x3,
)
from ..nn.swin import SwinBlock
from .google import _ConvStack
from .stf2022 import _CharmModel


class _TokensSwin(nn.Module):
    """A fixed-window SwinBlock over an NCHW tensor (named ``swin``)."""

    def __init__(self, dim: int, head_dim: int, window_size: int, shifted: bool, device=None):
        super().__init__()
        self.swin = SwinBlock(dim, max(1, dim // head_dim), window_size,
                              window_size // 2 if shifted else 0, fixed_window=True,
                              device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        t = self.swin(x.reshape(B, C, H * W).transpose(1, 2), H, W)
        return t.transpose(1, 2).reshape(B, C, H, W)


class ConvTransBlock(nn.Module):
    """Split channels into a residual-conv branch and a Swin branch, fuse
    with a 1x1, add the input."""

    def __init__(self, conv_dim: int, trans_dim: int, head_dim: int, window_size: int,
                 shifted: bool, device=None):
        super().__init__()
        c = conv_dim + trans_dim
        self.conv_dim = conv_dim
        self.conv1_1 = conv2d(c, c, 1, 1, device)
        self.conv_block = ResidualBlock(conv_dim, conv_dim, device)
        self.trans_block = _TokensSwin(trans_dim, head_dim, window_size, shifted, device=device)
        self.conv1_2 = conv2d(c, c, 1, 1, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cx, tx = torch.split(self.conv1_1(x), [self.conv_dim, x.shape[1] - self.conv_dim], dim=1)
        out = self.conv1_2(torch.cat([self.conv_block(cx) + cx, self.trans_block(tx)], dim=1))
        return x + out


class _AttentionUnit(nn.Module):
    """CompressAI's ``AttentionBlock`` unit: 1x1 to c/2, 3x3, 1x1 to c,
    ReLU between, + the input, then a ReLU."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        c = channels
        self.c1 = conv2d(c, c // 2, 1, 1, device=device)
        self.c2 = conv2d(c // 2, c // 2, 3, 1, device=device)
        self.c3 = conv2d(c // 2, c, 1, 1, device=device)

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.c2(F.relu(self.c1(v))))
        return F.relu(v + self.c3(h))


class SWAtten(nn.Module):
    """The slice model's gate: h = 1x1 in to ``inter_dim``; a trunk of three
    units; a mask branch of a Swin pair (W, SW), three units and a 1x1;
    1x1 out of h + trunk * sigmoid(mask)."""

    def __init__(self, in_dim: int, output_dim: int, head_dim: int, window_size: int,
                 inter_dim: int = 128, device=None):
        super().__init__()
        d = device
        self.in_conv = conv2d(in_dim, inter_dim, 1, 1, d)
        for i in range(3):
            setattr(self, f"trunk_{i}", _AttentionUnit(inter_dim, d))
        self.mask_swin_0 = _TokensSwin(inter_dim, head_dim, window_size, False, device=d)
        self.mask_swin_1 = _TokensSwin(inter_dim, head_dim, window_size, True, device=d)
        for i in range(3):
            setattr(self, f"mask_{i}", _AttentionUnit(inter_dim, d))
        self.mask_conv = conv2d(inter_dim, inter_dim, 1, 1, d)
        self.out_conv = conv2d(inter_dim, output_dim, 1, 1, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.in_conv(x)
        a, b = h, self.mask_swin_1(self.mask_swin_0(h))
        for i in range(3):
            a = getattr(self, f"trunk_{i}")(a)
            b = getattr(self, f"mask_{i}")(b)
        return self.out_conv(h + a * torch.sigmoid(self.mask_conv(b)))


class _TCMStage(nn.Module):
    """``depth`` ConvTransBlocks on 2 ``dim`` channels (W, SW, ...), then the
    resample ``(kind, out, arg)``: "rbs" | "rbu" | "conv" | "subpel"."""

    def __init__(self, dim: int, depth: int, head_dim: int, window_size: int,
                 resample: Tuple, device=None):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            setattr(self, f"ctb_{i}", ConvTransBlock(dim, dim, head_dim, window_size,
                                                     shifted=bool(i % 2), device=device))
        kind, out, arg = resample
        c = 2 * dim
        if kind == "rbs":
            self.resample = ResidualBlockWithStride(c, out, arg, device)
        elif kind == "rbu":
            self.resample = ResidualBlockUpsample(c, out, arg, device)
        elif kind == "conv":
            self.resample = conv2d(c, out, 3, arg, device)
        else:
            self.resample = subpel_conv3x3(c, out, arg, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"ctb_{i}")(x)
        return self.resample(x)


class TCM2023(_CharmModel):
    N = 128
    M = 320
    hyper_channels = 192
    hyper_window = 4
    hyper_head_dim = 32

    def __init__(self, config: Tuple[int, ...] = (2, 2, 2, 2, 2, 2),
                 head_dim: Tuple[int, ...] = (8, 16, 32, 32, 16, 8), N: Optional[int] = None,
                 M: Optional[int] = None, num_slices: int = 5, max_support_slices: int = 5,
                 in_channel: int = 3, window_size: int = 8, device=None):
        self.config, self.head_dim = tuple(config), tuple(head_dim)
        self.num_slices, self.max_support_slices = num_slices, max_support_slices
        self.window_size = window_size
        super().__init__(N, M, in_channel, device)

    @property
    def max_support(self) -> int:
        return self.max_support_slices

    def _build(self) -> None:
        N, M, d, ws = self.N, self.M, self.device, self.window_size
        cfg, hd, hc, C = self.config, self.head_dim, self.hyper_channels, self.in_channel
        hw, hhd = self.hyper_window, self.hyper_head_dim
        self.g_a_in = ResidualBlockWithStride(C, 2 * N, 2, d)
        for i in range(3):
            setattr(self, f"m_down{i + 1}", _TCMStage(
                N, cfg[i], hd[i], ws, ("rbs", 2 * N, 2) if i < 2 else ("conv", M, 2), d))
        self.g_s_in = ResidualBlockUpsample(M, 2 * N, 2, d)
        for i in range(3):
            setattr(self, f"m_up{i + 1}", _TCMStage(
                N, cfg[3 + i], hd[3 + i], ws, ("rbu", 2 * N, 2) if i < 2 else ("subpel", C, 2),
                d))
        self.h_a_in = ResidualBlockWithStride(M, 2 * N, 2, d)
        self.ha_down1 = _TCMStage(N, cfg[0], hhd, hw, ("conv", hc, 2), d)
        self.h_mean_in = ResidualBlockUpsample(hc, 2 * N, 2, d)
        self.hs_up1 = _TCMStage(N, cfg[3], hhd, hw, ("subpel", M, 2), d)
        self.h_scale_in = ResidualBlockUpsample(hc, 2 * N, 2, d)
        self.hs_up2 = _TCMStage(N, cfg[3], hhd, hw, ("subpel", M, 2), d)

        s = self.slice_size
        cc = (("conv", 224, 3, 1), ("gelu",), ("conv", 128, 3, 1), ("gelu",), ("conv", s, 3, 1))
        for i in range(self.num_slices):
            sup, out = M + s * min(i, self.max_support), M + s * min(i, 5)
            for kind in ("mean", "scale"):
                setattr(self, f"atten_{kind}_{i}", SWAtten(sup, out, 16, ws, 128, d))
                setattr(self, f"cc_{kind}_transforms_{i}", _ConvStack(cc, out, d))
            setattr(self, f"lrp_transforms_{i}", _ConvStack(cc, out + s, d))
        self.entropy_bottleneck = EntropyBottleneck(hc, device=d)
        self.gaussian_conditional = GaussianConditional()

    def g_a(self, x: torch.Tensor) -> torch.Tensor:
        x = self.g_a_in(x)
        for i in range(3):
            x = getattr(self, f"m_down{i + 1}")(x)
        return x

    def g_s(self, y_hat: torch.Tensor) -> torch.Tensor:
        x = self.g_s_in(y_hat)
        for i in range(3):
            x = getattr(self, f"m_up{i + 1}")(x)
        return x

    def h_a(self, y: torch.Tensor) -> torch.Tensor:
        return self.ha_down1(self.h_a_in(y))

    def h_mean_s(self, z_hat: torch.Tensor) -> torch.Tensor:
        return self.hs_up1(self.h_mean_in(z_hat))

    def h_scale_s(self, z_hat: torch.Tensor) -> torch.Tensor:
        return self.hs_up2(self.h_scale_in(z_hat))

    def slice_entropy(self, latent_means, latent_scales, y_hat_slices: Sequence[torch.Tensor],
                      i: int):
        """(mu, sigma, the attended mean support the lrp reads) of slice i."""
        support = list(y_hat_slices[: self.max_support])
        mean_support = getattr(self, f"atten_mean_{i}")(torch.cat([latent_means] + support, 1))
        scale_support = getattr(self, f"atten_scale_{i}")(torch.cat([latent_scales] + support, 1))
        return (getattr(self, f"cc_mean_transforms_{i}")(mean_support),
                getattr(self, f"cc_scale_transforms_{i}")(scale_support), mean_support)

    def slice_residual(self, mean_support, y_hat_slice, i: int):
        lrp_in = torch.cat([mean_support, y_hat_slice], dim=1)
        return 0.5 * torch.tanh(getattr(self, f"lrp_transforms_{i}")(lrp_in))
