"""The Ballé/Minnen image codecs: factorized prior, scale and mean-scale
hyperpriors, the sampled-y ablation and the joint autoregressive model.

Counterpart of ``cra5_tpu/models/google.py``, module by module and name by
name, so a flax variables tree loads into these models
(``convert.load_flax_variables``). Each model is an ``nn.Module`` on an
explicit device (the card unless the caller asks for the CPU); its
training forward draws noise from an explicit ``torch.Generator``, and its
device methods (``encode_symbols``, ``hyper_params_from_z``,
``reconstruct``; for the autoregressive model ``analysis``,
``hyper_synthesis``, ``synthesis``) are what the codecs of ``codec.py``
dispatch on, by ``CODEC_KIND``. Weights come from a flax tree or from
``reset_parameters(seed)``, the flax initializers with torch draws.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..entropy import EntropyBottleneck, GaussianConditional
from ..entropy.ops import quantize
from ..nn.conv import MaskedConv2d, conv2d, deconv2d, reset_parameters_
from ..nn.gdn import GDN


class _ConvStack(nn.Module):
    """A sequential conv/deconv stack described by (kind, args) specs;
    layer i is named ``l{i}`` as in flax (parameter-free kinds hold no
    module)."""

    def __init__(self, specs: Tuple[Tuple, ...], in_channels: int, device=None):
        super().__init__()
        self.specs = tuple(specs)
        ch = in_channels
        for i, spec in enumerate(self.specs):
            kind = spec[0]
            if kind in ("conv", "deconv"):
                _, out, k, s = spec
                layer = (conv2d if kind == "conv" else deconv2d)(ch, out, k, s, device=device)
                setattr(self, f"l{i}", layer)
                ch = out
            elif kind in ("gdn", "igdn"):
                setattr(self, f"l{i}", GDN(spec[1], inverse=kind == "igdn", device=device))
            elif kind not in ("relu", "lrelu", "gelu"):
                raise ValueError(f"unknown layer kind {kind}")
        self.out_channels = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, spec in enumerate(self.specs):
            kind = spec[0]
            if kind == "relu":
                x = F.relu(x)
            elif kind == "lrelu":
                x = F.leaky_relu(x, 0.01)
            elif kind == "gelu":
                x = F.gelu(x)
            else:
                x = getattr(self, f"l{i}")(x)
        return x


def _analysis_specs(N: int, M: int, act: str = "gdn") -> Tuple[Tuple, ...]:
    """conv 5x5/2 x 4 with ``act`` between: 3 -> N -> N -> N -> M."""
    a = (act, N) if act == "gdn" else (act,)
    return (("conv", N, 5, 2), a, ("conv", N, 5, 2), a, ("conv", N, 5, 2), a, ("conv", M, 5, 2))


def _synthesis_specs(N: int, C: int, act: str = "igdn") -> Tuple[Tuple, ...]:
    a = (act, N) if act == "igdn" else (act,)
    return (("deconv", N, 5, 2), a, ("deconv", N, 5, 2), a, ("deconv", N, 5, 2), a,
            ("deconv", C, 5, 2))


def _medians(eb: EntropyBottleneck) -> torch.Tensor:
    return eb.medians().reshape(1, -1, 1, 1)


class CompressionModel(nn.Module):
    """Shared base: the device, the seeded init, and ``aux_loss`` of the
    EntropyBottleneck."""

    N: int = 128
    M: int = 192

    def __init__(self, N: Optional[int] = None, M: Optional[int] = None, in_channel: int = 3,
                 device=None):
        super().__init__()
        self.N = type(self).N if N is None else N
        self.M = type(self).M if M is None else M
        self.in_channel = in_channel
        self.device = resolve_device(device)
        self._build()

    def _build(self) -> None:
        raise NotImplementedError

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> "CompressionModel":
        """The flax initializers, drawn from a generator seeded with
        ``seed`` on the model's device."""
        reset_parameters_(self, torch.Generator(device=self.device).manual_seed(seed))
        return self

    def aux_loss(self) -> torch.Tensor:
        return self.entropy_bottleneck.loss()


class FactorizedPrior(CompressionModel):
    """Ballé 2018 factorized-prior codec."""

    CODEC_KIND = "factorized"
    downsampling_factor = 16

    def _build(self) -> None:
        N, M, C, d = self.N, self.M, self.in_channel, self.device
        self.g_a = _ConvStack(_analysis_specs(N, M), C, d)
        self.g_s = _ConvStack(_synthesis_specs(N, C), M, d)
        self.entropy_bottleneck = EntropyBottleneck(M, device=d)

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        y = self.g_a(x)
        y_hat, y_likelihoods = self.entropy_bottleneck(y, training=training, generator=generator)
        return {"x_hat": self.g_s(y_hat), "likelihoods": {"y": y_likelihoods}}

    # device halves of compress/decompress (the coding is in ImageCodec)
    def encode_symbols(self, x: torch.Tensor) -> Dict[str, Any]:
        y = self.g_a(x)
        y_sym = torch.round(y - _medians(self.entropy_bottleneck)).to(torch.int32)
        return {"y_sym": y_sym, "y_shape": tuple(y.shape[-2:])}

    def reconstruct(self, y_sym: torch.Tensor, means=None) -> torch.Tensor:
        return self.g_s(y_sym.to(torch.float32) + _medians(self.entropy_bottleneck))


class FactorizedPriorReLU(FactorizedPrior):
    """The GDN-free variant."""

    def _build(self) -> None:
        N, M, C, d = self.N, self.M, self.in_channel, self.device
        self.g_a = _ConvStack(_analysis_specs(N, M, "relu"), C, d)
        self.g_s = _ConvStack(_synthesis_specs(N, C, "relu"), M, d)
        self.entropy_bottleneck = EntropyBottleneck(M, device=d)


class ScaleHyperprior(CompressionModel):
    """Ballé 2018 scale hyperprior: the hyper-latent z codes per-position
    Gaussian scales for y (no means)."""

    CODEC_KIND = "hyper"
    GC_HAS_MEANS = False
    downsampling_factor = 64

    def _build(self) -> None:
        self._build_g()
        self._build_h()
        self.entropy_bottleneck = EntropyBottleneck(self.N, device=self.device)
        self.gaussian_conditional = GaussianConditional()

    def _build_g(self) -> None:
        N, M, C, d = self.N, self.M, self.in_channel, self.device
        self.g_a = _ConvStack(_analysis_specs(N, M), C, d)
        self.g_s = _ConvStack(_synthesis_specs(N, C), M, d)

    def _build_h(self) -> None:
        N, M, d = self.N, self.M, self.device
        self.h_a = _ConvStack((("conv", N, 3, 1), ("relu",), ("conv", N, 5, 2), ("relu",),
                               ("conv", N, 5, 2)), M, d)
        self.h_s = _ConvStack((("deconv", N, 5, 2), ("relu",), ("deconv", N, 5, 2), ("relu",),
                               ("conv", M, 3, 1), ("relu",)), N, d)

    def _hyper_input(self, y: torch.Tensor) -> torch.Tensor:
        return y.abs()

    def _gaussian_params(self, z_hat: torch.Tensor):
        return self.h_s(z_hat), None

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        y = self.g_a(x)
        z = self.h_a(self._hyper_input(y))
        z_hat, z_likelihoods = self.entropy_bottleneck(z, training=training, generator=generator)
        scales, means = self._gaussian_params(z_hat)
        y_hat, y_likelihoods = self.gaussian_conditional(y, scales, means=means,
                                                         training=training, generator=generator)
        return {"x_hat": self.g_s(y_hat), "likelihoods": {"y": y_likelihoods, "z": z_likelihoods}}

    def _symbols(self, y: torch.Tensor) -> Dict[str, Any]:
        z = self.h_a(self._hyper_input(y))
        medians = _medians(self.entropy_bottleneck)
        z_sym = torch.round(z - medians).to(torch.int32)
        scales, means = self._gaussian_params(z_sym.to(z.dtype) + medians)
        y_sym = torch.round(y - means if means is not None else y).to(torch.int32)
        out = {"y_sym": y_sym, "z_sym": z_sym, "scales": scales, "z_shape": tuple(z.shape[-2:])}
        if means is not None:
            out["means"] = means
        return out

    def encode_symbols(self, x: torch.Tensor) -> Dict[str, Any]:
        return self._symbols(self.g_a(x))

    def hyper_params_from_z(self, z_sym: torch.Tensor):
        return self._gaussian_params(z_sym.to(torch.float32) + _medians(self.entropy_bottleneck))

    def reconstruct(self, y_sym: torch.Tensor, means: Optional[torch.Tensor] = None):
        y_hat = y_sym.to(torch.float32)
        if means is not None:
            y_hat = y_hat + means
        return self.g_s(y_hat)


class MeanScaleHyperprior(ScaleHyperprior):
    """Minnen 2018 mean-scale hyperprior."""

    GC_HAS_MEANS = True

    def _build_h(self) -> None:
        N, M, d = self.N, self.M, self.device
        self.h_a = _ConvStack((("conv", N, 3, 1), ("lrelu",), ("conv", N, 5, 2), ("lrelu",),
                               ("conv", N, 5, 2)), M, d)
        self.h_s = _ConvStack((("deconv", M, 5, 2), ("lrelu",), ("deconv", M * 3 // 2, 5, 2),
                               ("lrelu",), ("conv", M * 2, 3, 1)), N, d)

    def _hyper_input(self, y: torch.Tensor) -> torch.Tensor:
        return y

    def _gaussian_params(self, z_hat: torch.Tensor):
        scales, means = torch.chunk(self.h_s(z_hat), 2, dim=1)
        return scales, means


class SampledYInBmshj2018(MeanScaleHyperprior):
    """The sampled-y ablation: g_a emits 2M moments and y is the VAE
    posterior's sample (training, given a generator) or its mode; the
    entropy side is the mean-scale hyperprior."""

    def __init__(self, N: Optional[int] = None, M: Optional[int] = None, in_channel: int = 3,
                 sample_posterior: bool = True, device=None):
        self.sample_posterior = sample_posterior
        super().__init__(N, M, in_channel, device)

    def _build_g(self) -> None:
        N, M, C, d = self.N, self.M, self.in_channel, self.device
        out = 2 * M if self.sample_posterior else M
        self.g_a = _ConvStack(_analysis_specs(N, out), C, d)
        self.g_s = _ConvStack(_synthesis_specs(N, C), M, d)

    def _posterior_y(self, moments: torch.Tensor, generator: Optional[torch.Generator]):
        if not self.sample_posterior:
            return moments, None
        from .vaeformer import DiagonalGaussian

        posterior = DiagonalGaussian(moments)
        if generator is not None:
            return posterior.sample(generator), posterior
        return posterior.mode(), posterior

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        y, posterior = self._posterior_y(self.g_a(x), generator)
        z = self.h_a(self._hyper_input(y))
        z_hat, z_likelihoods = self.entropy_bottleneck(z, training=training, generator=generator)
        scales, means = self._gaussian_params(z_hat)
        y_hat, y_likelihoods = self.gaussian_conditional(y, scales, means=means,
                                                         training=training, generator=generator)
        out = {"x_hat": self.g_s(y_hat), "likelihoods": {"y": y_likelihoods, "z": z_likelihoods}}
        if posterior is not None:
            out["kl"] = posterior.kl()
        return out

    def encode_symbols(self, x: torch.Tensor) -> Dict[str, Any]:
        y, _ = self._posterior_y(self.g_a(x), None)  # the posterior's mode
        return self._symbols(y)


class JointAutoregressiveHierarchicalPriors(MeanScaleHyperprior):
    """mbt2018: the mean-scale hyperprior and a PixelCNN spatial context
    model. The training forward is parallel (the masked conv sees the
    quantized y); real coding is the serial raster scan of
    ``codec.AutoregressiveCodec``."""

    N = 192
    M = 192

    CODEC_KIND = "autoregressive"
    context_kernel = 5

    def _build(self) -> None:
        super()._build()
        M, d = self.M, self.device
        self.context_prediction = MaskedConv2d(M, 2 * M, kernel_size=self.context_kernel,
                                               mask_type="A", device=d)
        self.entropy_parameters = _ConvStack(
            (("conv", M * 10 // 3, 1, 1), ("lrelu",), ("conv", M * 8 // 3, 1, 1), ("lrelu",),
             ("conv", M * 6 // 3, 1, 1)), 4 * M, d)

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        y = self.g_a(x)
        z = self.h_a(y)
        z_hat, z_likelihoods = self.entropy_bottleneck(z, training=training, generator=generator)
        params = self.h_s(z_hat)
        y_hat = quantize(y, "noise" if training else "dequantize", generator=generator)
        ctx_params = self.context_prediction(y_hat)
        gaussian_params = self.entropy_parameters(torch.cat([params, ctx_params], dim=1))
        scales, means = torch.chunk(gaussian_params, 2, dim=1)
        _, y_likelihoods = self.gaussian_conditional(y, scales, means=means, training=training,
                                                     generator=generator)
        return {"x_hat": self.g_s(y_hat), "likelihoods": {"y": y_likelihoods, "z": z_likelihoods}}

    # device halves for the AR codec
    def analysis(self, x: torch.Tensor) -> Dict[str, Any]:
        """x -> (y, z_sym): everything encodable before the serial loop."""
        y = self.g_a(x)
        z = self.h_a(y)
        z_sym = torch.round(z - _medians(self.entropy_bottleneck)).to(torch.int32)
        return {"y": y, "z_sym": z_sym, "z_shape": tuple(z.shape[-2:])}

    def hyper_synthesis(self, z_sym: torch.Tensor) -> torch.Tensor:
        return self.h_s(z_sym.to(torch.float32) + _medians(self.entropy_bottleneck))

    def synthesis(self, y_hat: torch.Tensor) -> torch.Tensor:
        return self.g_s(y_hat)
