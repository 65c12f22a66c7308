"""Cheng 2020 codecs: residual and attention conv transforms over the joint
autoregressive entropy model.

Counterpart of ``cra5_tpu/models/waseda.py``: ``Cheng2020Anchor`` (residual
blocks and subpel upsampling, M == N) and ``Cheng2020Attention`` (with the
conv attention blocks in g_a and g_s). The entropy side is
``JointAutoregressiveHierarchicalPriors``'; compress and decompress run
through ``codec.AutoregressiveCodec``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.conv import (
    AttentionBlock,
    ResidualBlock,
    ResidualBlockUpsample,
    ResidualBlockWithStride,
    conv2d,
    subpel_conv3x3,
)
from .google import JointAutoregressiveHierarchicalPriors, _ConvStack


class _ChengAnalysis(nn.Module):
    def __init__(self, N: int, in_channel: int = 3, attention: bool = False, device=None):
        super().__init__()
        d = device
        self.rbs1 = ResidualBlockWithStride(in_channel, N, 2, d)
        self.rb1 = ResidualBlock(N, N, d)
        self.rbs2 = ResidualBlockWithStride(N, N, 2, d)
        self.attn1 = AttentionBlock(N, d) if attention else None
        self.rb2 = ResidualBlock(N, N, d)
        self.rbs3 = ResidualBlockWithStride(N, N, 2, d)
        self.rb3 = ResidualBlock(N, N, d)
        self.conv_out = conv2d(N, N, 3, 2, d)
        self.attn2 = AttentionBlock(N, d) if attention else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.rb1(self.rbs1(x))
        x = self.rbs2(x)
        if self.attn1 is not None:
            x = self.attn1(x)
        x = self.rb3(self.rbs3(self.rb2(x)))
        x = self.conv_out(x)
        return self.attn2(x) if self.attn2 is not None else x


class _ChengSynthesis(nn.Module):
    def __init__(self, N: int, out_channel: int = 3, attention: bool = False, device=None):
        super().__init__()
        d = device
        self.attn1 = AttentionBlock(N, d) if attention else None
        self.rb1 = ResidualBlock(N, N, d)
        self.rbu1 = ResidualBlockUpsample(N, N, 2, d)
        self.rb2 = ResidualBlock(N, N, d)
        self.rbu2 = ResidualBlockUpsample(N, N, 2, d)
        self.attn2 = AttentionBlock(N, d) if attention else None
        self.rb3 = ResidualBlock(N, N, d)
        self.rbu3 = ResidualBlockUpsample(N, N, 2, d)
        self.rb4 = ResidualBlock(N, N, d)
        self.subpel_out = subpel_conv3x3(N, out_channel, 2, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.attn1 is not None:
            x = self.attn1(x)
        x = self.rbu2(self.rb2(self.rbu1(self.rb1(x))))
        if self.attn2 is not None:
            x = self.attn2(x)
        x = self.rb4(self.rbu3(self.rb3(x)))
        return self.subpel_out(x)


class _ChengHyperSynthesis(nn.Module):
    """h_s with subpel upsampling."""

    def __init__(self, N: int, device=None):
        super().__init__()
        d = device
        self.c1 = conv2d(N, N, 3, 1, d)
        self.up1 = subpel_conv3x3(N, N, 2, d)
        self.c2 = conv2d(N, N * 3 // 2, 3, 1, d)
        self.up2 = subpel_conv3x3(N * 3 // 2, N * 3 // 2, 2, d)
        self.c3 = conv2d(N * 3 // 2, N * 2, 3, 1, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in (self.c1, self.up1, self.c2, self.up2):
            x = F.leaky_relu(layer(x), 0.01)
        return self.c3(x)


class Cheng2020Anchor(JointAutoregressiveHierarchicalPriors):
    """M == N throughout."""

    N = 192
    M = 192
    attention = False

    def _build_g(self) -> None:
        N, C, d = self.N, self.in_channel, self.device
        self.g_a = _ChengAnalysis(N, C, attention=self.attention, device=d)
        self.g_s = _ChengSynthesis(N, C, attention=self.attention, device=d)

    def _build_h(self) -> None:
        N = self.N
        self.h_a = _ConvStack((("conv", N, 3, 1), ("lrelu",), ("conv", N, 3, 1), ("lrelu",),
                               ("conv", N, 3, 2), ("lrelu",), ("conv", N, 3, 1), ("lrelu",),
                               ("conv", N, 3, 2)), N, self.device)
        self.h_s = _ChengHyperSynthesis(N, device=self.device)


class Cheng2020Attention(Cheng2020Anchor):
    attention = True
