"""Training losses: rate-distortion with optional learned-log-variance
weighting, and the KL-weighted VAE loss.

Counterpart of ``cra5_tpu/train/loss.py``. The promotions match the JAX
package: ``target - x_hat`` is float32 for a float32 target and a bf16
x_hat, and ``log(likelihood)`` is taken in the likelihood's own dtype
(float32 from both entropy models).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch


def bpp_from_likelihoods(likelihoods: Dict[str, torch.Tensor], num_pixels: int) -> torch.Tensor:
    """Bits per pixel implied by the likelihoods: -sum(log2 l) / pixels."""
    return sum(torch.log(l).sum() / (-math.log(2) * num_pixels) for l in likelihoods.values())


@dataclasses.dataclass
class RateDistortionLoss:
    lmbda: float = 0.01
    bpp_weight: float = 0.01
    metric: str = "mse"
    learn_log_variance: bool = False

    def __call__(self, output: Dict[str, Any], target: torch.Tensor,
                 logvar: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        N, _, H, W = target.shape
        out: Dict[str, torch.Tensor] = {}
        out["bpp_loss"] = self.bpp_weight * bpp_from_likelihoods(output["likelihoods"], N * H * W)
        if self.metric == "mse":
            rec = (target - output["x_hat"]).square()
            if self.learn_log_variance and logvar is not None:
                out["mse_loss"] = (rec / torch.exp(logvar) + logvar).mean()
            else:
                out["mse_loss"] = self.lmbda * rec.mean()
        elif self.metric in ("ms-ssim", "ms_ssim"):
            raise NotImplementedError(
                "the ms-ssim distortion needs metrics.py's ms_ssim, which is not "
                "ported yet (ROADMAP.md queue A3)")
        else:
            raise NotImplementedError(f"metric {self.metric!r}")
        out["loss"] = out["bpp_loss"] + out["mse_loss"]
        return out


def kl_weighted_loss(output: Dict[str, Any], target: torch.Tensor, kl_weight: float = 1e-6,
                     logvar: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """VAE loss: the (optionally logvar-weighted) L1 reconstruction plus
    ``kl_weight`` times the posterior's KL."""
    rec = (target - output["x_hat"]).abs()
    nll = rec / torch.exp(logvar) + logvar if logvar is not None else rec
    nll_loss = nll.mean()
    kl_loss = torch.mean(output["kl"])
    return {"nll_loss": nll_loss, "kl_loss": kl_loss, "vae_loss": nll_loss + kl_weight * kl_loss}
