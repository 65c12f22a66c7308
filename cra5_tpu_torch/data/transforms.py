"""Colour transforms: RGB <-> YCbCr (ITU-R BT.601) and YUV 4:4:4 <-> 4:2:0.

Counterpart of ``cra5_tpu/data/transforms.py`` on torch tensors: the same
BT.601 weights, the 0.5 chroma offset, the 2x2 average pool that drops an
odd last row or column, and the 2x chroma upsampling. ``jax.image.resize``
upsamples by 2 with half-pixel centres and a triangle (or box) kernel
whose weights are renormalized where it leaves the grid; at a factor of 2
that is ``F.interpolate(..., align_corners=False)``, whose source
coordinate clamps to the edge, so the borders agree too.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

_YCBCR_WEIGHTS = (0.299, 0.587, 0.114)


def rgb2ycbcr(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3, H, W) float in [0, 1] -> YCbCr, chroma centred at 0.5."""
    r, g, b = torch.split(rgb, 1, dim=-3)
    kr, kg, kb = _YCBCR_WEIGHTS
    y = kr * r + kg * g + kb * b
    cb = 0.5 * (b - y) / (1.0 - kb) + 0.5
    cr = 0.5 * (r - y) / (1.0 - kr) + 0.5
    return torch.cat([y, cb, cr], dim=-3)


def ycbcr2rgb(ycbcr: torch.Tensor) -> torch.Tensor:
    y, cb, cr = torch.split(ycbcr, 1, dim=-3)
    kr, kg, kb = _YCBCR_WEIGHTS
    r = y + (2.0 - 2.0 * kr) * (cr - 0.5)
    b = y + (2.0 - 2.0 * kb) * (cb - 0.5)
    g = (y - kr * r - kb * b) / kg
    return torch.cat([r, g, b], dim=-3)


def _planes(c: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (N, 1, H, W) for the 2-D ops."""
    return c.reshape(-1, 1, *c.shape[-2:])


def yuv_444_to_420(
    yuv: Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    mode: str = "avg_pool",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """4:4:4 (..., 3, H, W) -> (y, u, v) with chroma subsampled 2x."""
    if mode != "avg_pool":
        raise ValueError(f'Invalid downsampling mode "{mode}"')
    if isinstance(yuv, tuple):
        y, u, v = yuv
    else:
        y, u, v = torch.split(yuv, 1, dim=-3)

    def _down(c):
        out = F.avg_pool2d(_planes(c), 2, 2)
        return out.reshape(*c.shape[:-2], *out.shape[-2:])

    return y, _down(u), _down(v)


def yuv_420_to_444(
    yuv: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    mode: str = "bilinear",
    return_tuple: bool = False,
):
    """(y, u, v) with 2x-subsampled chroma -> 4:4:4."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f'Invalid upsampling mode "{mode}"')
    y, u, v = yuv

    def _up(c):
        kw = dict(align_corners=False) if mode == "bilinear" else {}
        out = F.interpolate(_planes(c), scale_factor=2, mode=mode, **kw)
        return out.reshape(*c.shape[:-2], *out.shape[-2:])

    u, v = _up(u), _up(v)
    if return_tuple:
        return y, u, v
    return torch.cat([y, u, v], dim=-3)
