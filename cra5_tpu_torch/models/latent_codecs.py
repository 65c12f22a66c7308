"""Composable latent codecs: the building blocks that full entropy models
assemble from instead of re-implementing them.

Counterpart of ``cra5_tpu/models/latent_codecs.py``, built only from the
port's entropy modules. Each codec's ``forward`` is the training/eval
likelihood path ({"y_hat", "likelihoods": {...}}); noise comes from an
explicit ``torch.Generator``. Transforms handed to a codec (``h_a``,
``h_s``, ``context_prediction``, ``entropy_parameters``) are registered on
the outermost codec under those names first, as flax adopts them, so a
flax tree maps path by path (``convert.flax_layout``); an inner codec that
shares them lists them once.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..device import resolve_device
from ..entropy import EntropyBottleneck, GaussianConditional
from ..entropy.ops import quantize, quantize_ste


class EntropyBottleneckLatentCodec(nn.Module):
    """y coded by a learned factorized prior."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.entropy_bottleneck = EntropyBottleneck(channels, device=resolve_device(device))

    def forward(self, y: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        y_hat, lk = self.entropy_bottleneck(y, training=training, generator=generator)
        return {"y_hat": y_hat, "likelihoods": {"y": lk}}


class GaussianConditionalLatentCodec(nn.Module):
    """y coded by a Gaussian conditional; ctx_params -> (scales, means),
    optionally through an entropy-parameters net."""

    def __init__(self, quantizer: str = "ste", chunk: Tuple[str, str] = ("scales", "means"),
                 entropy_parameters: Optional[nn.Module] = None):
        super().__init__()
        self.quantizer, self.chunk = quantizer, tuple(chunk)
        self.entropy_parameters = entropy_parameters
        self.gaussian_conditional = GaussianConditional()

    def forward(self, y: torch.Tensor, ctx_params: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        if self.entropy_parameters is not None:
            ctx_params = self.entropy_parameters(ctx_params)
        a, b = torch.chunk(ctx_params, 2, dim=1)
        scales, means = (a, b) if self.chunk == ("scales", "means") else (b, a)
        _, lk = self.gaussian_conditional(y, scales, means=means, training=training,
                                          generator=generator)
        if self.quantizer == "ste":
            y_hat = quantize_ste(y - means) + means
        else:
            y_hat = quantize(y, "noise" if training else "dequantize", means=means,
                             generator=generator)
        return {"y_hat": y_hat, "likelihoods": {"y": lk}}


class HyperLatentCodec(nn.Module):
    """z = h_a(y) coded by an EntropyBottleneck; emits the entropy
    parameters h_s(z_hat)."""

    def __init__(self, z_channels: int, h_a: nn.Module = None, h_s: nn.Module = None,
                 quantizer: str = "ste", device=None):
        super().__init__()
        self.h_a = h_a
        self.entropy_bottleneck = EntropyBottleneck(z_channels, device=resolve_device(device))
        self.h_s = h_s
        self.quantizer = quantizer

    def forward(self, y: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        z = self.h_a(y)
        z_hat, lk = self.entropy_bottleneck(z, training=training, generator=generator)
        if self.quantizer == "ste" and not training:
            medians = self.entropy_bottleneck.medians().reshape(1, -1, 1, 1)
            z_hat = quantize_ste(z - medians) + medians
        return {"parameters": self.h_s(z_hat), "likelihoods": {"z": lk}}


class HyperpriorLatentCodec(nn.Module):
    """The full hyperprior: HyperLatentCodec's parameters feed a
    GaussianConditionalLatentCodec for y."""

    def __init__(self, z_channels: int, h_a: nn.Module = None, h_s: nn.Module = None,
                 device=None):
        super().__init__()
        self.h_a, self.h_s = h_a, h_s
        self.hyper = HyperLatentCodec(z_channels, h_a, h_s, device=device)
        self.y = GaussianConditionalLatentCodec()

    def forward(self, y: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        hyper_out = self.hyper(y, training=training, generator=generator)
        y_out = self.y(y, hyper_out["parameters"], training=training, generator=generator)
        return {"y_hat": y_out["y_hat"],
                "likelihoods": {"y": y_out["likelihoods"]["y"],
                                "z": hyper_out["likelihoods"]["z"]}}


class RasterScanLatentCodec(nn.Module):
    """PixelCNN context codec: the parallel training path through the
    masked conv; real coding is the serial loop of
    ``codec.AutoregressiveCodec``."""

    def __init__(self, M: int, context_prediction: nn.Module = None,
                 entropy_parameters: nn.Module = None):
        super().__init__()
        self.M = M
        self.context_prediction = context_prediction
        self.entropy_parameters = entropy_parameters
        self.gaussian_conditional = GaussianConditional()

    def forward(self, y: torch.Tensor, params: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        y_hat = quantize(y, "noise" if training else "dequantize", generator=generator)
        ctx = self.context_prediction(y_hat)
        gp = self.entropy_parameters(torch.cat([params, ctx], dim=1))
        scales, means = torch.chunk(gp, 2, dim=1)
        _, lk = self.gaussian_conditional(y, scales, means=means, training=training,
                                          generator=generator)
        return {"y_hat": y_hat, "likelihoods": {"y": lk}}


class GainHyperLatentCodec(nn.Module):
    """A gain-conditioned hyper codec: z is scaled by a per-quality learned
    gain vector before coding."""

    def __init__(self, z_channels: int, num_gains: int = 6, h_a: nn.Module = None,
                 h_s: nn.Module = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.gain = nn.Parameter(torch.ones(num_gains, z_channels, device=dev))
        self.inv_gain = nn.Parameter(torch.ones(num_gains, z_channels, device=dev))
        self.h_a = h_a
        self.entropy_bottleneck = EntropyBottleneck(z_channels, device=dev)
        self.h_s = h_s

    def forward(self, y: torch.Tensor, gain_index: int = 0, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        z = self.h_a(y)
        g = self.gain[gain_index].reshape(1, -1, 1, 1)
        ig = self.inv_gain[gain_index].reshape(1, -1, 1, 1)
        z_hat, lk = self.entropy_bottleneck(z * g, training=training, generator=generator)
        return {"parameters": self.h_s(z_hat * ig), "likelihoods": {"z": lk}}


class GainHyperpriorLatentCodec(nn.Module):
    """A gain-conditioned hyperprior: per-quality gains on both y and z give
    one model a rate ladder."""

    def __init__(self, z_channels: int, y_channels: int, num_gains: int = 6,
                 h_a: nn.Module = None, h_s: nn.Module = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.y_gain = nn.Parameter(torch.ones(num_gains, y_channels, device=dev))
        self.y_inv_gain = nn.Parameter(torch.ones(num_gains, y_channels, device=dev))
        self.h_a, self.h_s = h_a, h_s
        self.hyper = GainHyperLatentCodec(z_channels, num_gains, h_a, h_s, device=dev)
        self.y = GaussianConditionalLatentCodec()

    def forward(self, y: torch.Tensor, gain_index: int = 0, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        hyper_out = self.hyper(y, gain_index, training=training, generator=generator)
        g = self.y_gain[gain_index].reshape(1, -1, 1, 1)
        ig = self.y_inv_gain[gain_index].reshape(1, -1, 1, 1)
        y_out = self.y(y * g, hyper_out["parameters"], training=training, generator=generator)
        return {"y_hat": y_out["y_hat"] * ig,
                "likelihoods": {"y": y_out["likelihoods"]["y"],
                                "z": hyper_out["likelihoods"]["z"]}}
