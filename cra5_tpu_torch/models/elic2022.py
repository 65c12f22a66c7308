"""ELIC 2022 (He et al.): unevenly grouped channel-conditional entropy model
with a two-pass checkerboard spatial context.

Counterpart of ``cra5_tpu/models/elic2022.py``, module by module and name
by name: residual-bottleneck transforms with attention, channel groups
[16, 16, 32, 64, M - 128], ``cc_transforms_{i}`` channel supports,
``context_prediction_{i}`` checkerboard-masked convs and
``param_aggregation_{i}`` 1x1 stacks. The checkerboard is a pack/unpack
to (H, W/2): each pass of each group codes as one v2 stream a sample.

``ElicCodec`` (a ``codec._SliceCodec``: v2 always, as the JAX package's)
decodes each pass (K2, or K3 when sorted) against indexes the decoder
derives from the groups it already holds. Both sides compute each group's
parameters from the same tensors through the same code (``_hat`` rebuilds
a pass's y_hat from its symbols on both sides), on ``nn/conv.py``'s
cuDNN-off convolutions, so the decoder's indexes equal the encoder's
bitwise.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..entropy import EntropyBottleneck, GaussianConditional
from ..entropy.ops import quantize_ste
from ..nn.conv import AttentionBlock, CheckerboardMaskedConv2d, conv2d, deconv2d
from .codec import _SliceCodec
from .google import CompressionModel, _ConvStack, _medians


class ResidualBottleneckBlock(nn.Module):
    def __init__(self, channels: int, device=None):
        super().__init__()
        c = channels
        self.conv1 = conv2d(c, c // 2, 1, 1, device=device)
        self.conv2 = conv2d(c // 2, c // 2, 3, 1, device=device)
        self.conv3 = conv2d(c // 2, c, 1, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.conv1(x))
        h = F.relu(self.conv2(h))
        return x + self.conv3(h)


def _rbs(owner: nn.Module, prefix: str, channels: int, device) -> None:
    for i in range(3):
        setattr(owner, f"{prefix}_{i}", ResidualBottleneckBlock(channels, device))


def _run_rbs(owner: nn.Module, prefix: str, x: torch.Tensor) -> torch.Tensor:
    for i in range(3):
        x = getattr(owner, f"{prefix}_{i}")(x)
    return x


class _ElicAnalysis(nn.Module):
    def __init__(self, N: int, M: int, in_channel: int = 3, device=None):
        super().__init__()
        d = device
        self.down1 = conv2d(in_channel, N, 5, 2, d)
        _rbs(self, "rb1", N, d)
        self.down2 = conv2d(N, N, 5, 2, d)
        _rbs(self, "rb2", N, d)
        self.attn1 = AttentionBlock(N, d)
        self.down3 = conv2d(N, N, 5, 2, d)
        _rbs(self, "rb3", N, d)
        self.down4 = conv2d(N, M, 5, 2, d)
        self.attn2 = AttentionBlock(M, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _run_rbs(self, "rb1", self.down1(x))
        x = self.attn1(_run_rbs(self, "rb2", self.down2(x)))
        x = _run_rbs(self, "rb3", self.down3(x))
        return self.attn2(self.down4(x))


class _ElicSynthesis(nn.Module):
    def __init__(self, N: int, M: int, out_chans: int = 3, device=None):
        super().__init__()
        d = device
        self.attn1 = AttentionBlock(M, d)
        self.up1 = deconv2d(M, N, 5, 2, d)
        _rbs(self, "rb1", N, d)
        self.up2 = deconv2d(N, N, 5, 2, d)
        self.attn2 = AttentionBlock(N, d)
        _rbs(self, "rb2", N, d)
        self.up3 = deconv2d(N, N, 5, 2, d)
        _rbs(self, "rb3", N, d)
        self.up4 = deconv2d(N, out_chans, 5, 2, d)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        x = _run_rbs(self, "rb1", self.up1(self.attn1(y)))
        x = _run_rbs(self, "rb2", self.attn2(self.up2(x)))
        x = _run_rbs(self, "rb3", self.up3(x))
        return self.up4(x)


@functools.lru_cache(maxsize=64)
def _anchor_mask(H: int, W: int) -> np.ndarray:
    """1 at anchor positions ((h + w) even: [0::2, 0::2] and [1::2, 1::2])."""
    hh, ww = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    return ((hh + ww) % 2 == 0).astype(np.float32)


def checkerboard_pack(x: torch.Tensor, anchor: bool) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, H, W // 2) keeping the anchor (or non-anchor)
    positions; W must be even."""
    if anchor:
        even, odd = x[:, :, 0::2, 0::2], x[:, :, 1::2, 1::2]
    else:
        even, odd = x[:, :, 0::2, 1::2], x[:, :, 1::2, 0::2]
    B, C, H2, W2 = even.shape
    return torch.stack([even, odd], dim=3).reshape(B, C, 2 * H2, W2)


def checkerboard_unpack(packed: torch.Tensor, anchor: bool, W: int) -> torch.Tensor:
    """Inverse of checkerboard_pack; the complement is zero."""
    B, C, H, W2 = packed.shape
    out = packed.new_zeros(B, C, H, W)
    if anchor:
        out[:, :, 0::2, 0::2] = packed[:, :, 0::2]
        out[:, :, 1::2, 1::2] = packed[:, :, 1::2]
    else:
        out[:, :, 0::2, 1::2] = packed[:, :, 0::2]
        out[:, :, 1::2, 0::2] = packed[:, :, 1::2]
    return out


class ELIC2022(CompressionModel):
    N = 192
    M = 320

    CODEC_KIND = "elic"
    downsampling_factor = 64

    def __init__(self, N: Optional[int] = None, M: Optional[int] = None, num_slices: int = 5,
                 in_channel: int = 3, device=None):
        self.num_slices = num_slices
        super().__init__(N, M, in_channel, device)

    @property
    def groups(self) -> List[int]:
        return [0, 16, 16, 32, 64, self.M - 128][: self.num_slices + 1]

    def _build(self) -> None:
        N, M, d, g = self.N, self.M, self.device, self.groups
        if sum(g[1:]) != M:
            raise ValueError(f"M={M} must equal sum of channel groups {g[1:]} (= {sum(g[1:])}); "
                             f"adjust M or num_slices")
        self.g_a = _ElicAnalysis(N, M, self.in_channel, d)
        self.g_s = _ElicSynthesis(N, M, self.in_channel, d)
        self.h_a = _ConvStack((("conv", N, 3, 1), ("relu",), ("conv", N, 5, 2), ("relu",),
                               ("conv", N, 5, 2)), M, d)
        self.h_s = _ConvStack((("deconv", N, 5, 2), ("relu",), ("deconv", N * 3 // 2, 5, 2),
                               ("relu",), ("conv", 2 * M, 3, 1)), N, d)
        for i in range(1, self.num_slices):
            cin = g[1] if i == 1 else g[1] + g[i]
            setattr(self, f"cc_transforms_{i - 1}", _ConvStack(
                (("conv", 224, 5, 1), ("relu",), ("conv", 128, 5, 1), ("relu",),
                 ("conv", g[i + 1] * 2, 5, 1)), cin, d))
        for i in range(self.num_slices):
            gi = g[i + 1]
            setattr(self, f"context_prediction_{i}",
                    CheckerboardMaskedConv2d(gi, 2 * gi, kernel_size=5, device=d))
            support = 2 * M if i == 0 else 2 * gi + 2 * M
            setattr(self, f"param_aggregation_{i}", _ConvStack(
                (("conv", 640, 1, 1), ("relu",), ("conv", 512, 1, 1), ("relu",),
                 ("conv", gi * 2, 1, 1)), 2 * gi + support, d))
        self.entropy_bottleneck = EntropyBottleneck(N, device=d)
        self.gaussian_conditional = GaussianConditional()

    def _support(self, y_hat_slices: Sequence[torch.Tensor], i: int,
                 hyper_params: torch.Tensor) -> torch.Tensor:
        if i == 0:
            return hyper_params
        sup_in = (y_hat_slices[0] if i == 1
                  else torch.cat([y_hat_slices[0], y_hat_slices[i - 1]], dim=1))
        return torch.cat([getattr(self, f"cc_transforms_{i - 1}")(sup_in), hyper_params], dim=1)

    def _params(self, ctx: torch.Tensor, support: torch.Tensor, i: int):
        pa = getattr(self, f"param_aggregation_{i}")(torch.cat([ctx, support], dim=1))
        return torch.chunk(pa, 2, dim=1)

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        y = self.g_a(x)
        B, C, H, W = y.shape
        z = self.h_a(y)
        z_hat, z_likelihoods = self.entropy_bottleneck(z, training=training, generator=generator)
        if not training:
            medians = _medians(self.entropy_bottleneck)
            z_hat = quantize_ste(z - medians) + medians
        hyper_params = self.h_s(z_hat)
        amask = torch.from_numpy(_anchor_mask(H, W)).to(y.device)[None, None]

        g = self.groups
        y_hat_slices: List[torch.Tensor] = []
        likelihoods: List[torch.Tensor] = []
        for i, y_slice in enumerate(torch.split(y, g[1:], dim=1)):
            support = self._support(y_hat_slices, i, hyper_params)
            means_a, scales_a = self._params(y.new_zeros(B, 2 * g[i + 1], H, W), support, i)
            y_anchor_hat = (quantize_ste(y_slice - means_a) + means_a) * amask
            ctx = getattr(self, f"context_prediction_{i}")(y_anchor_hat)
            means_n, scales_n = self._params(ctx, support, i)
            scales_hat = scales_a * amask + scales_n * (1 - amask)
            means_hat = means_a * amask + means_n * (1 - amask)
            _, lk = self.gaussian_conditional(y_slice, scales_hat, means=means_hat,
                                              training=training, generator=generator)
            likelihoods.append(lk)
            y_hat_slices.append(quantize_ste(y_slice - means_hat) + means_hat)

        x_hat = self.g_s(torch.cat(y_hat_slices, dim=1))
        return {"x_hat": x_hat,
                "likelihoods": {"y": torch.cat(likelihoods, dim=1), "z": z_likelihoods}}

    # ---- device halves for ElicCodec ----
    def analysis(self, x: torch.Tensor) -> Dict[str, Any]:
        y = self.g_a(x)
        z = self.h_a(y)
        z_sym = torch.round(z - _medians(self.entropy_bottleneck)).to(torch.int32)
        return {"y": y, "z_sym": z_sym, "z_shape": tuple(z.shape[-2:])}

    def hyper_params_from_z(self, z_sym: torch.Tensor) -> torch.Tensor:
        return self.h_s(z_sym.to(torch.float32) + _medians(self.entropy_bottleneck))

    def anchor_params(self, y_hat_slices: Sequence[torch.Tensor], hyper_params: torch.Tensor,
                      i: int):
        B, _, H, W = hyper_params.shape
        support = self._support(y_hat_slices, i, hyper_params)
        return self._params(hyper_params.new_zeros(B, 2 * self.groups[i + 1], H, W), support, i)

    def non_anchor_params(self, y_anchor_hat: torch.Tensor, y_hat_slices: Sequence[torch.Tensor],
                          hyper_params: torch.Tensor, i: int):
        support = self._support(y_hat_slices, i, hyper_params)
        return self._params(getattr(self, f"context_prediction_{i}")(y_anchor_hat), support, i)

    def synthesis(self, y_hat: torch.Tensor) -> torch.Tensor:
        return self.g_s(y_hat)


class ElicCodec(_SliceCodec):
    """Per group, one v2 stream a sample for the anchors and one for the
    non-anchors: y's strings run group by group, anchors then non-anchors."""

    def _symbols(self, y: torch.Tensor, means: torch.Tensor, anchor: bool) -> torch.Tensor:
        return checkerboard_pack(torch.round(y - means).to(torch.int32), anchor)

    def _indexes(self, scales: torch.Tensor, anchor: bool) -> torch.Tensor:
        """The GC rows of one pass, packed; the decoder's must equal the
        encoder's."""
        return self._gc_indexes(checkerboard_pack(scales, anchor))

    @staticmethod
    def _hat(sym: torch.Tensor, means: torch.Tensor, anchor: bool, W: int) -> torch.Tensor:
        """One pass's y_hat (zero off the pass) from its packed symbols."""
        return checkerboard_unpack(sym.to(torch.float32) + checkerboard_pack(means, anchor),
                                   anchor, W)

    def _encode_slices(self, y: torch.Tensor, hyper: torch.Tensor) -> list:
        m, W = self.model, y.shape[-1]
        handles, y_hat_slices = [], []
        for i, y_slice in enumerate(torch.split(y, m.groups[1:], dim=1)):
            means, scales = m.anchor_params(y_hat_slices, hyper, i)
            sym = self._symbols(y_slice, means, True)
            handles += self._gc_coder.encode_dispatch_batch(sym, self._indexes(scales, True))
            y_anchor_hat = self._hat(sym, means, True, W)
            means, scales = m.non_anchor_params(y_anchor_hat, y_hat_slices, hyper, i)
            sym = self._symbols(y_slice, means, False)
            handles += self._gc_coder.encode_dispatch_batch(sym, self._indexes(scales, False))
            y_hat_slices.append(y_anchor_hat + self._hat(sym, means, False, W))
        return handles

    def _decode_slices(self, ups: list, B: int, hyper: torch.Tensor, W: int) -> torch.Tensor:
        m = self.model
        y_hat_slices: List[torch.Tensor] = []
        for i in range(m.num_slices):
            p = 2 * i * B  # this group's anchor streams, then its non-anchor ones
            means, scales = m.anchor_params(y_hat_slices, hyper, i)
            sym = self._decode(ups[p:p + B], self._indexes(scales, True))
            y_anchor_hat = self._hat(sym, means, True, W)
            means, scales = m.non_anchor_params(y_anchor_hat, y_hat_slices, hyper, i)
            sym = self._decode(ups[p + B:p + 2 * B], self._indexes(scales, False))
            y_hat_slices.append(y_anchor_hat + self._hat(sym, means, False, W))
        return torch.cat(y_hat_slices, dim=1)
