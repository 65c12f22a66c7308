"""Evaluation metrics: PSNR, MS-SSIM, the theoretic rate, and the weather
scores (latitude-weighted RMSE, mean absolute error, anomaly correlation).

Counterpart of ``cra5_tpu/metrics.py``, on tensors of any device. MS-SSIM
uses fixed 11 x 11 Gaussian windows (sigma 1.5) as depthwise valid
convolutions, five scales with Wang et al.'s weights by default; the
latitude weights are WeatherBench's w(phi) = cos(phi) / mean(cos(phi)).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() - b.float()).square().mean()


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    return 20.0 * math.log10(max_val) - 10.0 * torch.log10(mse(a, b))


def bpp_from_likelihoods(likelihoods: Dict[str, torch.Tensor], num_pixels: int) -> torch.Tensor:
    """Theoretic rate: -sum(log2 l) over every likelihood, per pixel."""
    return sum(torch.log(l).sum() / (-math.log(2) * num_pixels) for l in likelihoods.values())


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-0.5 * ((np.arange(size) - size // 2) / sigma) ** 2)
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def _depthwise_filter(x: torch.Tensor, kernel2d: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) filtered channel by channel, valid padding."""
    C = x.shape[1]
    return F.conv2d(x, kernel2d.expand(C, 1, *kernel2d.shape).contiguous(), groups=C)


def ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0, return_cs: bool = False):
    """Single-scale SSIM over (B, C, H, W); the mean over every dim (and,
    with ``return_cs``, the mean contrast-structure term)."""
    a, b = a.float(), b.float()
    C1, C2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2
    kernel = torch.as_tensor(_gaussian_kernel(), device=a.device)
    mu_a, mu_b = _depthwise_filter(a, kernel), _depthwise_filter(b, kernel)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sigma_aa = _depthwise_filter(a * a, kernel) - mu_aa
    sigma_bb = _depthwise_filter(b * b, kernel) - mu_bb
    sigma_ab = _depthwise_filter(a * b, kernel) - mu_ab
    cs = (2 * sigma_ab + C2) / (sigma_aa + sigma_bb + C2)
    ssim_map = ((2 * mu_ab + C1) / (mu_aa + mu_bb + C1)) * cs
    if return_cs:
        return ssim_map.mean(), cs.mean()
    return ssim_map.mean()


def ms_ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0,
            weights: Sequence[float] = MSSSIM_WEIGHTS) -> torch.Tensor:
    """Multi-scale SSIM (Wang et al. 2003) over (B, C, H, W). Five scales
    need H, W >= 11 * 2**4 = 176; pass fewer weights for smaller images."""
    a, b = a.float(), b.float()
    vals = []
    for i in range(len(weights)):
        s, cs = ssim(a, b, max_val, return_cs=True)
        if i == len(weights) - 1:
            vals.append(torch.clamp(s, min=0.0))
        else:
            vals.append(torch.clamp(cs, min=0.0))
            a, b = F.avg_pool2d(a, 2), F.avg_pool2d(b, 2)
    w = torch.as_tensor(weights, dtype=torch.float32, device=a.device)
    return torch.prod(torch.stack(vals) ** w)


def lat_weights(num_lat: int, endpoint: bool = True) -> np.ndarray:
    """WeatherBench latitude weights on a [90, -90] grid, mean 1. ERA5's
    0.25-degree grids hold both poles (721 points, endpoint=True)."""
    lat = np.linspace(90.0, -90.0, num_lat, endpoint=endpoint)
    w = np.maximum(np.cos(np.deg2rad(lat)), 0.0)
    return (w / w.mean()).astype(np.float32)


def _weights(pred: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    if weights is None:
        weights = torch.as_tensor(lat_weights(pred.shape[-2]), device=pred.device)
    return weights.reshape(1, 1, -1, 1)


def wrmse(pred: torch.Tensor, target: torch.Tensor, weights: Optional[torch.Tensor] = None,
          per_channel: bool = False) -> torch.Tensor:
    """Latitude-weighted RMSE over (B, C, H_lat, W_lon): a scalar, or (C,)."""
    se = (pred.float() - target.float()).square() * _weights(pred, weights)
    return torch.sqrt(se.mean(dim=(0, 2, 3)) if per_channel else se.mean())


def mean_abs_error(pred: torch.Tensor, target: torch.Tensor,
                   per_channel: bool = True) -> torch.Tensor:
    ae = (pred.float() - target.float()).abs()
    return ae.mean(dim=(0, 2, 3)) if per_channel else ae.mean()


def acc(pred: torch.Tensor, target: torch.Tensor, climatology: torch.Tensor,
        weights: Optional[torch.Tensor] = None, per_channel: bool = True) -> torch.Tensor:
    """Latitude-weighted anomaly correlation of (pred - clim) and (target -
    clim) over (B, H, W), per channel by default."""
    w = _weights(pred, weights)
    pa, ta = (pred - climatology).float(), (target - climatology).float()
    dims = (0, 2, 3) if per_channel else None

    def total(t):
        return t.sum(dim=dims) if dims else t.sum()

    den = torch.sqrt(total(w * pa * pa) * total(w * ta * ta))
    return total(w * pa * ta) / torch.clamp(den, min=1e-12)
