"""Patch embedding and its exact ConvTranspose inverse, as matmuls.

Counterpart of ``cra5_tpu/nn/patch_embed.py``. For the patch geometries the
VAEformer uses (kw == sw, kh in {sh, sh + 1}) the strided conv is a patch
extraction plus one matmul, and the ConvTranspose one matmul plus an
overlap-add: row kh-1 of patch h lands on row 0 of patch h+1, so
721 = 71 * 10 + 11 rows come back exactly. Every other geometry takes the
general paths, the JAX package's VALID ``conv_general_dilated`` and
``conv_transpose`` as im2col / col2im matmuls (``F.unfold``, one matmul,
``F.fold``), whose output is ``Hp * sh + max(kh - sh, 0)`` rows (and so
for the columns) as ``lax.conv_transpose`` gives. No cuDNN convolution is
involved on either path, so no algorithm choice enters the numerics.

Weights use PyTorch's layouts: ``PatchEmbed.weight`` is Conv2d's (out, in,
kh, kw); ``PatchUnembed.weight`` is ConvTranspose2d's (in, out, kh, kw),
i.e. the flax kernel spatially flipped, since flax applies its
ConvTranspose kernel flipped. Parameters are float32; both compute in
``dtype``, casting the weights where they are used, as flax does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .init import lecun_normal_


def _tiled(patch_size, patch_stride) -> bool:
    """The fast geometry: columns tile, rows overlap by at most one."""
    (kh, kw), (sh, sw) = patch_size, patch_stride
    return kw == sw and kh in (sh, sh + 1)


class PatchEmbed(nn.Module):
    def __init__(self, in_chans: int, embed_dim: int, patch_size: Tuple[int, int],
                 patch_stride: Tuple[int, int], dtype=torch.float32, device=None):
        super().__init__()
        self.patch_size, self.patch_stride = tuple(patch_size), tuple(patch_stride)
        self.dtype = dtype
        kh, kw = self.patch_size
        self.weight = nn.Parameter(torch.empty(embed_dim, in_chans, kh, kw, device=device))
        self.bias = nn.Parameter(torch.empty(embed_dim, device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        D, C, kh, kw = self.weight.shape
        lecun_normal_(self.weight, kh * kw * C, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor):
        """x: (B, C, H, W) -> tokens (B, Hp*Wp, D), (Hp, Wp)."""
        kh, kw = self.patch_size
        sh, sw = self.patch_stride
        B, C, H, W = x.shape
        Hp, Wp = (H - kh) // sh + 1, (W - kw) // sw + 1
        x = x.to(self.dtype).contiguous()  # NCHW, whatever the caller's strides
        if not (_tiled(self.patch_size, self.patch_stride) and W == Wp * sw):
            # im2col: (B, C*kh*kw, Hp*Wp), channel-major as the weight's rows
            cols = F.unfold(x, (kh, kw), stride=(sh, sw)).transpose(1, 2)
            w = self.weight.to(self.dtype).reshape(self.weight.shape[0], -1)
            return cols @ w.T + self.bias.to(self.dtype), (Hp, Wp)
        patch = x[:, :, : Hp * sh].reshape(B, C, Hp, sh, Wp, kw)
        if kh == sh + 1:
            extra = x[:, :, sh::sh][:, :, :Hp]  # row h*sh + sh of token h
            patch = torch.cat([patch, extra.reshape(B, C, Hp, 1, Wp, kw)], dim=3)
        patch = patch.permute(0, 2, 4, 3, 5, 1).reshape(B, Hp * Wp, kh * kw * C)
        w = self.weight.to(self.dtype).permute(2, 3, 1, 0).reshape(kh * kw * C, -1)
        return patch @ w + self.bias.to(self.dtype), (Hp, Wp)


class PatchUnembed(nn.Module):
    """ConvTranspose inverse of PatchEmbed, without bias."""

    def __init__(self, embed_dim: int, out_chans: int, patch_size: Tuple[int, int],
                 patch_stride: Tuple[int, int], dtype=torch.float32, device=None):
        super().__init__()
        self.patch_size, self.patch_stride = tuple(patch_size), tuple(patch_stride)
        self.dtype = dtype
        kh, kw = self.patch_size
        self.weight = nn.Parameter(torch.empty(embed_dim, out_chans, kh, kw, device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        D, C, kh, kw = self.weight.shape
        lecun_normal_(self.weight, kh * kw * D, generator)

    def forward(self, x: torch.Tensor, grid: Tuple[int, int]) -> torch.Tensor:
        """x: (B, N, D) tokens on ``grid`` -> (B, C, H, W)."""
        B, N, D = x.shape
        Hp, Wp = grid
        kh, kw = self.patch_size
        sh, sw = self.patch_stride
        C = self.weight.shape[1]
        y = x.to(self.dtype) @ self.weight.to(self.dtype).reshape(D, C * kh * kw)
        if not _tiled(self.patch_size, self.patch_stride):
            # col2im: each token's (C, kh, kw) patch added in at (h*sh, w*sw)
            out = (Hp * sh + max(kh - sh, 0), Wp * sw + max(kw - sw, 0))
            return F.fold(y.transpose(1, 2), out, (kh, kw), stride=(sh, sw))
        p = y.reshape(B, Hp, Wp, C, kh, kw).permute(0, 3, 1, 4, 2, 5)  # (B, C, Hp, kh, Wp, kw)
        if kh == sh:
            return p.reshape(B, C, Hp * kh, Wp * kw)
        main = p[:, :, :, :sh].contiguous()
        extra = p[:, :, :, sh]  # (B, C, Hp, Wp, kw)
        main[:, :, 1:, 0] += extra[:, :, :-1]
        return torch.cat(
            [main.reshape(B, C, Hp * sh, Wp * kw), extra[:, :, -1:].reshape(B, C, 1, Wp * kw)],
            dim=2,
        )
