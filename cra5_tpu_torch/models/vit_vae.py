"""VITAutoencoderKL: the variational ViT auto-encoder without entropy
coding, for latent-diffusion-style use downstream.

Counterpart of ``cra5_tpu/models/vit_vae.py``: the VAEformer's g_a / g_s
towers (named ``encoder`` / ``decoder`` as in flax) around 1x1 quant convs
and a diagonal Gaussian posterior. ``forward`` samples the posterior from
an explicit ``torch.Generator`` when ``sample_posterior`` is set and a
generator is given, else takes its mode. Training pairs with
``train.ema``; evaluating with the EMA's params stands in for the
reference's ``ema_scope``. Like JAX's, it has no likelihoods and no
Trainer path.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..device import resolve_device
from ..nn.vit import ViTDecoder, ViTEncoder
from .vaeformer import Conv1x1, DiagonalGaussian, VAEformerConfig, reset_seeded_


class VITAutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEformerConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.device = resolve_device(device)
        c, d = cfg, dict(dtype=dtype, device=self.device)
        self.encoder = ViTEncoder(c.img_size, c.patch_size, c.patch_stride, c.in_chans,
                                  c.y_channels, c.depth, c.num_heads, c.window_sizes, c.interval,
                                  **d)
        self.decoder = ViTDecoder(c.img_size, c.patch_size, c.patch_stride, c.in_chans,
                                  c.y_channels, c.depth, c.num_heads, c.window_sizes, c.interval,
                                  **d)
        self.quant_conv = Conv1x1(2 * c.y_channels, 2 * c.embed_dim, **d)
        self.post_quant_conv = Conv1x1(c.embed_dim, c.y_channels, **d)

    def reset_parameters(self, seed: int = 0) -> "VITAutoencoderKL":
        """The flax initializers, drawn from a generator seeded with ``seed``."""
        return reset_seeded_(self, seed)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        return DiagonalGaussian(self.quant_conv(self.encoder(x)))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x: torch.Tensor, sample_posterior: bool = True,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        posterior = self.encode(x)
        z = (posterior.sample(generator) if sample_posterior and generator is not None
             else posterior.mode())
        return {"x_hat": self.decode(z), "kl": posterior.kl(),
                "posterior_mean": posterior.mean, "posterior_logvar": posterior.logvar}
