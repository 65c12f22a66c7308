"""Patch embedding and its exact ConvTranspose inverse, as matmuls.

Counterpart of ``cra5_tpu/nn/patch_embed.py``. For the patch geometries the
VAEformer uses (kw == sw, kh in {sh, sh + 1}) the strided conv is a patch
extraction plus one matmul, and the ConvTranspose one matmul plus an
overlap-add: row kh-1 of patch h lands on row 0 of patch h+1, so
721 = 71 * 10 + 11 rows come back exactly. No cuDNN convolution is
involved, so no algorithm choice enters the numerics.

Weights use PyTorch's layouts: ``PatchEmbed.weight`` is Conv2d's (out, in,
kh, kw); ``PatchUnembed.weight`` is ConvTranspose2d's (in, out, kh, kw),
i.e. the flax kernel spatially flipped, since flax applies its
ConvTranspose kernel flipped. Parameters are float32; both compute in
``dtype``, casting the weights where they are used, as flax does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .init import lecun_normal_


def _check_geometry(patch_size, patch_stride):
    (kh, kw), (sh, sw) = patch_size, patch_stride
    if kw != sw or kh not in (sh, sh + 1):
        raise NotImplementedError(
            f"patch {patch_size} with stride {patch_stride}: only kw == sw and "
            "kh in {sh, sh+1} are supported"
        )


class PatchEmbed(nn.Module):
    def __init__(self, in_chans: int, embed_dim: int, patch_size: Tuple[int, int],
                 patch_stride: Tuple[int, int], dtype=torch.float32, device=None):
        super().__init__()
        _check_geometry(patch_size, patch_stride)
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
        if W != Wp * sw:
            raise ValueError(f"width {W} is not a whole number of {sw}-wide patches")
        x = x.to(self.dtype).contiguous()  # NCHW, whatever the caller's strides
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
        _check_geometry(patch_size, patch_stride)
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
        sh, _ = self.patch_stride
        C = self.weight.shape[1]
        y = x.to(self.dtype) @ self.weight.to(self.dtype).reshape(D, C * kh * kw)
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
