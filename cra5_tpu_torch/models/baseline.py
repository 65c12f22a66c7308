"""VAEformer ablation baselines.

Counterpart of ``cra5_tpu/models/baseline.py``:

  - ``VariationCNNPrior``: the ViT g_a / g_s of the VAEformer with a conv
    mean-scale hyperprior (``google._ConvStack``: h_a conv 3/1, lrelu,
    conv 5/2, lrelu, conv 5/2; h_s deconv 5/2, lrelu, deconv 5/2 to
    3M/2, lrelu, conv 3/1 to 2M) and the variational posterior; with
    ``variational=False`` the deterministic mean-scale baseline.
  - ``vaeformer_former_baseline()``: the ViT hyperprior without the 1x1
    quant convs, a ``VAEformer`` config (``lower_dim=False``). The JAX
    package's 268v config keeps ``embed_dim=256`` while y carries the
    ViT's 1024 channels, so its GaussianConditional cannot broadcast and
    the model does not build; the port sets ``embed_dim=y_channels`` at
    268v as both packages' tiny variant does (ROADMAP C9).

``VariationCNNPrior`` has the VAEformer's device-method surface, so
``VAEformerCodec`` wraps it unchanged; like JAX's it has no
``CODEC_KIND``. Its conv hyperprior computes in float32 with float32
parameters whatever the model dtype, as flax promotes a bf16 y against
float32 kernels, and runs with cuDNN off (``nn/conv.py``), so the scales
the decoder re-derives from the z symbols equal the encoder's bitwise.
g_a and g_s take ``cfg.remat`` (JAX's ignore it): recomputing blocks in
the backward changes the memory of a train step, not its numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..device import resolve_device
from ..entropy import EntropyBottleneck, GaussianConditional
from ..nn.vit import ViTDecoder, ViTEncoder
from .google import _ConvStack
from .vaeformer import (Conv1x1, DiagonalGaussian, VAEformerConfig, reset_seeded_, vaeformer_268,
                        vaeformer_tiny)


def vaeformer_former_baseline() -> VAEformerConfig:
    """The ViT hyperprior without quant / post-quant 1x1 convs at 268v;
    without lower_dim, y carries the full ViT width (C9)."""
    cfg = vaeformer_268()
    return dataclasses.replace(cfg, lower_dim=False, embed_dim=cfg.y_channels,
                               name="vaeformer_former_baseline")


def vaeformer_former_baseline_tiny() -> VAEformerConfig:
    cfg = vaeformer_tiny()
    # without lower_dim, y carries the full ViT width
    return dataclasses.replace(cfg, lower_dim=False, embed_dim=cfg.y_channels,
                               name="former_baseline_tiny")


class VariationCNNPrior(nn.Module):
    """ViT analysis / synthesis + conv mean-scale hyperprior."""

    def __init__(self, cfg: VAEformerConfig, variational: bool = True, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cfg, self.variational, self.dtype = cfg, variational, dtype
        self.device = resolve_device(device)
        c, d = cfg, dict(dtype=dtype, device=self.device)
        self.g_a = ViTEncoder(c.img_size, c.patch_size, c.patch_stride, c.in_chans, c.y_channels,
                              c.depth, c.num_heads, c.window_sizes, c.interval,
                              remat=c.remat, **d)
        self.g_s = ViTDecoder(c.img_size, c.patch_size, c.patch_stride, c.in_chans, c.y_channels,
                              c.depth, c.num_heads, c.window_sizes, c.interval,
                              remat=c.remat, **d)
        if c.lower_dim:
            mult = 2 if variational else 1
            self.quant_conv = Conv1x1(2 * c.y_channels, mult * c.embed_dim, **d)
            self.post_quant_conv = Conv1x1(c.embed_dim, c.y_channels, **d)
        M, N = c.embed_dim, c.z_channels
        self.h_a = _ConvStack((("conv", N, 3, 1), ("lrelu",), ("conv", N, 5, 2), ("lrelu",),
                               ("conv", N, 5, 2)), M, device=self.device)
        self.h_s = _ConvStack((("deconv", M, 5, 2), ("lrelu",), ("deconv", M * 3 // 2, 5, 2),
                               ("lrelu",), ("conv", M * 2, 3, 1)), N, device=self.device)
        self.entropy_bottleneck = EntropyBottleneck(N, device=self.device)
        self.gaussian_conditional = GaussianConditional()

    def reset_parameters(self, seed: int = 0) -> "VariationCNNPrior":
        """The flax initializers, drawn from a generator seeded with ``seed``."""
        return reset_seeded_(self, seed)

    def _medians(self) -> torch.Tensor:
        return self.entropy_bottleneck.medians().reshape(1, -1, 1, 1)

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        moments = self.g_a(x)
        return self.quant_conv(moments) if self.cfg.lower_dim else moments

    def encode_latent(self, x: torch.Tensor) -> torch.Tensor:
        moments = self.encode_moments(x)
        return DiagonalGaussian(moments).mode() if self.variational else moments

    def decode_y(self, y_hat: torch.Tensor) -> torch.Tensor:
        return self.g_s(self.post_quant_conv(y_hat) if self.cfg.lower_dim else y_hat)

    def hyper_params(self, z_hat: torch.Tensor):
        scales, means = torch.chunk(self.h_s(z_hat.float()), 2, dim=1)
        return scales, means

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """x_hat, the y/z likelihoods and the posterior's KL (zeros when not
        variational). With ``training`` the entropy side adds uniform noise
        from ``generator`` (the posterior sample when the config samples it,
        then EB and GC noise, in that order); h_a reads y detached."""
        moments = self.encode_moments(x)
        if self.variational:
            posterior = DiagonalGaussian(moments)
            y = (posterior.sample(generator) if self.cfg.sample_posterior and generator is not None
                 else posterior.mode())
            kl = posterior.kl()
        else:
            y = moments
            kl = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
        z = self.h_a(y.detach().float())
        z_hat, z_likelihoods = self.entropy_bottleneck(z, training=training, generator=generator)
        scales, means = self.hyper_params(z_hat)
        y_hat, y_likelihoods = self.gaussian_conditional(
            y, scales, means=means, training=training, generator=generator)
        return {"x_hat": self.decode_y(y_hat),
                "likelihoods": {"y": y_likelihoods, "z": z_likelihoods}, "kl": kl}

    # the VAEformerCodec device-method surface
    def encode_symbols(self, x: torch.Tensor) -> Dict[str, Any]:
        return self.symbols_from_latent(self.encode_latent(x))

    def symbols_from_latent(self, y: torch.Tensor) -> Dict[str, Any]:
        z = self.h_a(y.float())
        medians = self._medians()
        z_sym = torch.round(z - medians).to(torch.int32)
        scales, means = self.hyper_params(z_sym.to(z.dtype) + medians)
        y_sym = torch.round(y - means).to(torch.int32)
        return {"y_sym": y_sym, "z_sym": z_sym, "scales": scales, "means": means, "y": y}

    def scales_from_z_symbols(self, z_sym: torch.Tensor):
        # float32 as symbols_from_latent: bf16 holds integers exactly only
        # to 256, so a wider z symbol would give the decoder other scales
        return self.hyper_params(z_sym.float() + self._medians())

    def reconstruct_from_y_symbols(self, y_sym: torch.Tensor, means: torch.Tensor) -> torch.Tensor:
        return self.decode_y(y_sym.to(means.dtype) + means)

    def aux_loss(self) -> torch.Tensor:
        return self.entropy_bottleneck.loss()
