"""VAEformer: the ViT auto-encoder with a ViT hyperprior, and its codec.

Counterpart of ``cra5_tpu/models/vaeformer.py``: the training forward
(``VAEformer.forward``, with the entropy side's noise drawn from a
``torch.Generator``) and the compress -> bytes -> decompress path.
``VAEformer`` is an ``nn.Module`` whose weights come either from the JAX
package (``convert.load_flax_variables``) or from its own seeded init
(``reset_parameters``, mirroring the flax initializers);
``VAEformerCodec`` owns the CDF tables and the coders around it: the v2
lane rANS on the device, or the v1 serial rANS of the published archives
on the host.

dtype: in a bfloat16 model every tower computes in bfloat16, while every
parameter stays float32 and is cast where it is used, as in the JAX
package (flax's default ``param_dtype``). The promotions match too:
``z_sym.to(dtype) + medians`` is float32 on both the encode and the decode
side, so the hyper decoder sees identical inputs there, and the GC indexes
are built from float32 scales.

Tensor parallelism: ``parallel.parallelize_(model, mesh)`` places a whole
``VAEformer`` on the mesh's tp axis, and a ``VAEformerCodec`` of the placed
model runs ``compress`` and ``decompress`` on every rank of the tp group
together (their collectives pair up). After each row-parallel sum every
rank holds the same activations, so every rank writes byte-identical
streams; let only the primary write them to files.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..coder.lane_coder import LaneCoder
from ..device import resolve_device
from ..entropy import EntropyBottleneck, GaussianConditional
from ..entropy.ops import draw
from ..nn.conv import reset_parameters_
from ..nn.init import lecun_normal_
from ..nn.vit import HyperDecoder, HyperEncoder, ViTDecoder, ViTEncoder
from .codec import _CodecBase


@dataclasses.dataclass(frozen=True)
class VAEformerConfig:
    """Static hyper-parameters of a VAEformer variant."""

    in_chans: int
    img_size: Tuple[int, int]
    patch_size: Tuple[int, int]
    patch_stride: Tuple[int, int]
    embed_dim: int          # y channels after the quant_conv chunk (e.g. 256)
    y_channels: int         # ViT width (e.g. 1024)
    z_channels: int
    depth: int
    num_heads: int
    window_sizes: Tuple[Tuple[int, int], ...]
    interval: int
    hyper_embed_dim: int
    hyper_depth: int
    hyper_num_heads: int
    hyper_patch: Tuple[int, int]
    sample_posterior: bool = False
    # the 1x1 quant_conv / post_quant_conv between the ViT width and
    # embed_dim; without them y carries the ViT width (embed_dim must then
    # equal y_channels)
    lower_dim: bool = True
    # g_s ends in the exact ConvTranspose inverse; False ends it in the
    # linear un-patchify, which the reference uses for every geometry other
    # than the ERA5 721 x 1440
    use_conv_transpose: bool = True
    # recompute g_a and g_s blocks in the backward: False | True ("full") |
    # "dots" (nn/vit.py)
    remat: Union[bool, str] = False
    name: str = "vaeformer"

    @property
    def latent_grid(self) -> Tuple[int, int]:
        return (self.img_size[0] // self.patch_stride[0], self.img_size[1] // self.patch_stride[1])

    @property
    def hyper_grid(self) -> Tuple[int, int]:
        g = self.latent_grid
        return (g[0] // self.hyper_patch[0], g[1] // self.hyper_patch[1])


def vaeformer_268() -> VAEformerConfig:
    """The production 268-variable configuration."""
    return VAEformerConfig(
        in_chans=268, img_size=(721, 1440), patch_size=(11, 10), patch_stride=(10, 10),
        embed_dim=256, y_channels=1024, z_channels=256, depth=24, num_heads=16,
        window_sizes=((24, 24), (12, 48), (48, 12)), interval=4,
        hyper_embed_dim=360, hyper_depth=8, hyper_num_heads=5, hyper_patch=(4, 4),
        name="vaeformer_268",
    )


def vaeformer_159() -> VAEformerConfig:
    """159 variables (6 pressure variables x 25 levels + 9 surface); the
    same ViT-L towers."""
    return dataclasses.replace(vaeformer_268(), in_chans=159, name="vaeformer_159")


def vaeformer_tiny(in_chans: int = 8) -> VAEformerConfig:
    """Test geometry: 41x40 grid, 4x4 tokens, with the ERA5 relation
    H = (Hp - 1) * stride + kernel so the ConvTranspose inverts exactly."""
    return VAEformerConfig(
        in_chans=in_chans, img_size=(41, 40), patch_size=(11, 10), patch_stride=(10, 10),
        embed_dim=8, y_channels=16, z_channels=8, depth=4, num_heads=2,
        window_sizes=((2, 2), (1, 4), (4, 1)), interval=2,
        hyper_embed_dim=12, hyper_depth=2, hyper_num_heads=2, hyper_patch=(2, 2),
        name="vaeformer_tiny",
    )


class DiagonalGaussian:
    """Posterior over y: moments (B, 2C, H, W) -> mean / logvar clamped to
    [-30, 20]."""

    def __init__(self, moments: torch.Tensor):
        self.mean, logvar = torch.chunk(moments, 2, dim=1)
        self.logvar = torch.clamp(logvar, -30.0, 20.0)

    @property
    def std(self) -> torch.Tensor:
        return torch.exp(0.5 * self.logvar)

    @property
    def var(self) -> torch.Tensor:
        return torch.exp(self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        fill = lambda shape, g: torch.randn(shape, generator=g, dtype=self.mean.dtype,
                                            device=self.mean.device)
        eps = draw(self.mean.shape, generator, fill)
        return self.mean + self.std * eps

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        return 0.5 * torch.mean(self.mean.square() + self.var - 1.0 - self.logvar, dim=(1, 2, 3))

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        logtwopi = float(np.log(2.0 * np.pi))
        return 0.5 * torch.sum(
            logtwopi + self.logvar + (sample - self.mean).square() / self.var, dim=(1, 2, 3))


class Conv1x1(nn.Module):
    """A 1x1 convolution (Conv2d weight layout) computed as a matmul, with
    float32 parameters, computing in ``dtype``."""

    def __init__(self, in_ch: int, out_ch: int, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 1, 1, device=device))
        self.bias = nn.Parameter(torch.empty(out_ch, device=device))

    def reset_parameters(self, generator=None) -> None:
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).contiguous()  # NCHW, whatever the caller's strides
        y = x.permute(0, 2, 3, 1) @ self.weight[:, :, 0, 0].to(self.dtype).T + self.bias.to(self.dtype)
        return y.permute(0, 3, 1, 2)


@torch.no_grad()
def reset_seeded_(model: nn.Module, seed: int) -> nn.Module:
    """Seeded init of a ViT model (the VAEformer and its variants) mirroring
    the flax initializers: trunc_normal(0.02) Dense kernels (attention proj
    and fc2 scaled by 1/sqrt(2 (layer_id + 1))), lecun_normal conv kernels,
    zero biases, unit LayerNorm scales, sin-cos positional embeddings, the
    EB init; every module with a seeded ``reset_parameters`` but the
    Linears, which their owners init, then the torch convolutions (a conv
    hyperprior) as ``nn/conv.py`` inits them."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    convs = (nn.Conv2d, nn.ConvTranspose2d)
    for m in model.modules():
        if m is not model and hasattr(m, "reset_parameters") and not isinstance(
                m, (nn.Linear, *convs)):
            m.reset_parameters(gen)
    for m in model.modules():
        if isinstance(m, convs):
            reset_parameters_(m, gen)
    return model


class VAEformer(nn.Module):
    CODEC_KIND = "vaeformer"  # make_codec dispatches to VAEformerCodec

    def __init__(self, cfg: VAEformerConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.device = resolve_device(device)
        c, d = cfg, dict(dtype=dtype, device=self.device)
        self.g_a = ViTEncoder(c.img_size, c.patch_size, c.patch_stride, c.in_chans, c.y_channels,
                              c.depth, c.num_heads, c.window_sizes, c.interval,
                              remat=c.remat, **d)
        self.g_s = ViTDecoder(c.img_size, c.patch_size, c.patch_stride, c.in_chans, c.y_channels,
                              c.depth, c.num_heads, c.window_sizes, c.interval,
                              use_conv_transpose=c.use_conv_transpose, remat=c.remat, **d)
        if c.lower_dim:
            self.quant_conv = Conv1x1(2 * c.y_channels, 2 * c.embed_dim, **d)
            self.post_quant_conv = Conv1x1(c.embed_dim, c.y_channels, **d)
        self.h_a = HyperEncoder(c.latent_grid, c.hyper_patch, c.hyper_patch, c.embed_dim,
                                c.z_channels, c.hyper_embed_dim, c.hyper_depth,
                                c.hyper_num_heads, **d)
        self.h_s = HyperDecoder(c.hyper_patch, c.embed_dim, c.z_channels, c.hyper_embed_dim,
                                c.hyper_depth, c.hyper_num_heads, **d)
        self.entropy_bottleneck = EntropyBottleneck(c.z_channels, device=self.device)
        self.gaussian_conditional = GaussianConditional()

    def reset_parameters(self, seed: int = 0) -> "VAEformer":
        """Seeded init mirroring the flax initializers (``reset_seeded_``)."""
        return reset_seeded_(self, seed)

    # -- building blocks ---------------------------------------------------
    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        moments = self.g_a(x)
        return self.quant_conv(moments) if self.cfg.lower_dim else moments

    def posterior_latent(self, moments: torch.Tensor,
                         generator: Optional[torch.Generator] = None):
        """(y, posterior): the posterior's sample when the config samples
        it (which needs a generator), else its mode."""
        posterior = DiagonalGaussian(moments)
        if self.cfg.sample_posterior:
            if generator is None:
                raise ValueError("sample_posterior requires a generator")
            return posterior.sample(generator), posterior
        return posterior.mode(), posterior

    def encode_latent(self, x: torch.Tensor) -> torch.Tensor:
        return DiagonalGaussian(self.encode_moments(x)).mode()

    def _medians(self) -> torch.Tensor:
        return self.entropy_bottleneck.medians().reshape(1, -1, 1, 1)

    def hyper_params(self, z_hat: torch.Tensor):
        scales, means = torch.chunk(self.h_s(z_hat), 2, dim=1)
        return scales, means

    def decode_y(self, y_hat: torch.Tensor) -> torch.Tensor:
        return self.g_s(self.post_quant_conv(y_hat) if self.cfg.lower_dim else y_hat)

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Training/eval forward: x_hat, the y/z likelihoods and the
        posterior's statistics. With ``training`` the entropy side adds
        uniform noise drawn from ``generator`` (the posterior sample, EB
        and GC noise, in that order); h_a reads y detached."""
        moments = self.encode_moments(x)
        y, posterior = self.posterior_latent(moments, generator)
        z = self.h_a(y.detach())
        z_hat, z_likelihoods = self.entropy_bottleneck(z, training=training, generator=generator)
        scales, means = self.hyper_params(z_hat)
        y_hat, y_likelihoods = self.gaussian_conditional(
            y, scales, means=means, training=training, generator=generator)
        return {
            "x_hat": self.decode_y(y_hat),
            "likelihoods": {"y": y_likelihoods, "z": z_likelihoods},
            "posterior_mean": posterior.mean,
            "posterior_logvar": posterior.logvar,
            "kl": posterior.kl(),
        }

    def aux_loss(self) -> torch.Tensor:
        return self.entropy_bottleneck.loss()

    def entropy_rate(self, y: torch.Tensor, generator: torch.Generator) -> Dict[str, Any]:
        """Training-mode likelihoods of (y, z) under the current hyper and
        EB parameters, for fitting the entropy side on a frozen latent."""
        z = self.h_a(y)
        z_hat, z_lik = self.entropy_bottleneck(z, training=True, generator=generator)
        scales, means = self.hyper_params(z_hat)
        _, y_lik = self.gaussian_conditional(y, scales, means=means, training=True,
                                             generator=generator)
        return {"likelihoods": {"y": y_lik, "z": z_lik}, "aux": self.aux_loss()}

    def encode_symbols(self, x: torch.Tensor) -> Dict[str, Any]:
        """Device half of compress: y, z and their symbols."""
        return self.symbols_from_latent(self.encode_latent(x))

    def symbols_from_latent(self, y: torch.Tensor) -> Dict[str, Any]:
        z = self.h_a(y)
        medians = self._medians()
        z_sym = torch.round(z - medians).to(torch.int32)
        scales, means = self.hyper_params(z_sym.to(z.dtype) + medians)
        y_sym = torch.round(y - means).to(torch.int32)
        return {"y_sym": y_sym, "z_sym": z_sym, "scales": scales, "means": means, "y": y}

    def scales_from_z_symbols(self, z_sym: torch.Tensor):
        return self.hyper_params(z_sym.to(self.dtype) + self._medians())

    def reconstruct_from_y_symbols(self, y_sym: torch.Tensor, means: torch.Tensor) -> torch.Tensor:
        return self.decode_y(y_sym.to(means.dtype) + means)


class VAEformerCodec(_CodecBase):
    """compress / decompress around a VAEformer: owns the CDF tables and
    the coders, on the model's device. Strings come back in the
    [[y_string, ...], [z_string, ...]] nesting, one string per sample.

    ``coder="v2"`` writes the lane-rANS streams (CRX2) on the device;
    ``coder="v1"`` writes the serial rANS streams of the published CRA5
    archives with the host coder (``coder/native.py``): symbols and CDF
    indexes are made on the device, cross to the host, and are coded there
    sample by sample.

    Every stage of compress and decompress is a ``torch.profiler`` range
    named ``compress/<stage>`` or ``decompress/<stage>``. When
    ``stage_times`` is a dict, each stage also ends in a device synchronize
    and records its host seconds there under that name (stages then no
    longer overlap, so their sum exceeds an unsynchronised roundtrip). The
    tables, the coders, the stages and the v1 helpers are ``_CodecBase``'s,
    shared with the image codecs (``models/codec.py``)."""

    @classmethod
    def with_tables(cls, model, tables: Optional[Dict[str, Any]] = None,
                    coder: str = "v2") -> "VAEformerCodec":
        """The codec with a checkpoint's trained CDF tables installed (a
        reference .pth's ``"_cdf_tables"``): its scale table first, from
        which the GC indexes are built, then its EB and GC tables. Without
        both tables, a codec that builds them by ``update()``."""
        if not (tables and "eb" in tables and "gc" in tables):
            return cls(model, coder=coder)
        codec = cls(model, coder=coder, scale_table=tables.get("scale_table"))
        codec.set_tables(tables["eb"], tables["gc"])
        return codec

    @torch.inference_mode()
    def compress(self, x) -> Dict[str, Any]:
        self._require_tables()
        with self._stage("compress/h2d_input"):
            x = torch.as_tensor(x, device=self.device)
        with self._stage("compress/g_a"):  # g_a + quant_conv
            y = self.model.encode_latent(x)
        return self._compress_latent(y)

    @torch.inference_mode()
    def compress_from_latent(self, y) -> Dict[str, Any]:
        """compress from a (B, embed_dim, H/10, W/10) latent, as the
        archive writer of a latent that was stored or edited."""
        self._require_tables()
        return self._compress_latent(torch.as_tensor(y, device=self.device))

    def _compress_latent(self, y: torch.Tensor) -> Dict[str, Any]:
        with self._stage("compress/hyper"):  # h_a, z symbols, h_s, y symbols
            out = self.model.symbols_from_latent(y)
        z_sym = out["z_sym"]
        B = z_sym.shape[0]
        zs = tuple(int(s) for s in z_sym.shape[-2:])
        if self.coder == "v1":
            with self._stage("compress/encode_z"):  # to the host, serial rANS
                z_strings = self._v1_encode(self._eb_table, z_sym, self._channel_indexes(z_sym.shape))
            with self._stage("compress/encode_y"):  # GC indexes, to the host, serial rANS
                y_strings = self._v1_encode(self._gc_table, out["y_sym"],
                                            self._gc_indexes(out["scales"]))
            return {"strings": [y_strings, z_strings], "z_shape": zs, "shape": zs}
        with self._stage("compress/encode_z"):
            z_idx = self._channel_indexes(z_sym.shape)
            handles = self._eb_coder.encode_dispatch_batch(z_sym, z_idx)
        with self._stage("compress/encode_y"):  # GC indexes, sort, merge, K1
            gc_idx = self._gc_indexes(out["scales"])
            handles += self._gc_coder.encode_dispatch_batch(out["y_sym"], gc_idx)
        with self._stage("compress/finalize"):  # to the host, containers, varints
            streams = LaneCoder.encode_finalize_many(handles)
        return {"strings": [streams[B:], streams[:B]], "z_shape": zs, "shape": zs}

    @torch.inference_mode()
    def decompress(self, strings: Sequence, z_shape: Tuple[int, int],
                   return_format: str = "reconstructed"):
        """{"x_hat": (B, C, H, W)}, or with ``return_format="latent"`` the
        dequantized latent y_sym + means as a float32 tensor."""
        if return_format not in ("reconstructed", "latent"):
            raise ValueError(f"unknown return_format {return_format!r}")
        self._require_tables()
        y_strings, z_strings = strings[0], strings[1]
        B = len(z_strings)
        cfg = self.model.cfg
        g = cfg.latent_grid
        full_z = (B, cfg.z_channels, int(z_shape[0]), int(z_shape[1]))
        if self.coder == "v1":
            with self._stage("decompress/decode_z"):  # serial rANS, to the card
                z_sym = self._v1_decode(self._eb_table, z_strings, self._channel_indexes(full_z))
            with self._stage("decompress/h_s"):
                scales, means = self.model.scales_from_z_symbols(z_sym)
            with self._stage("decompress/decode_y"):  # GC indexes to the host, serial rANS
                y_sym = self._v1_decode(self._gc_table, y_strings, self._gc_indexes(scales))
        else:
            with self._stage("decompress/upload_y"):  # varints, to the card
                y_up = self._gc_coder.upload_batch(list(y_strings), cfg.embed_dim * g[0] * g[1])
            with self._stage("decompress/decode_z"):  # K2
                z_sym = self._eb_coder.decode_batch_to_device(
                    list(z_strings), self._channel_indexes(full_z))
            with self._stage("decompress/h_s"):
                scales, means = self.model.scales_from_z_symbols(z_sym)
            with self._stage("decompress/decode_y"):  # GC indexes, sort, merge, K3
                y_sym = self._gc_coder.decode_uploaded_batch(y_up, self._gc_indexes(scales))
        if return_format == "latent":
            return y_sym.to(torch.float32) + means
        with self._stage("decompress/g_s"):  # post_quant_conv + g_s
            x_hat = self.model.reconstruct_from_y_symbols(y_sym, means)
        return {"x_hat": x_hat}

    # the float paths, on the codec's device
    @torch.inference_mode()
    def forward(self, x) -> Dict[str, Any]:
        """The model's eval forward: x_hat, likelihoods, posterior."""
        return self.model(torch.as_tensor(x, device=self.device))

    @torch.inference_mode()
    def encode_latent(self, x) -> torch.Tensor:
        return self.model.encode_latent(torch.as_tensor(x, device=self.device))

    @torch.inference_mode()
    def decode_latent(self, y_hat) -> torch.Tensor:
        return self.model.decode_y(torch.as_tensor(y_hat, device=self.device))
