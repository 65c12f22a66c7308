"""STF 2022 (Zou et al., "The Devil Is in the Details"): a symmetrical
Swin-transformer codec with a charm-style channel-slice entropy model.

Counterpart of ``cra5_tpu/models/stf2022.py``, module by module and name
by name: a 2x2 patch embed and four Swin stages with patch merging
(analysis), four with patch splitting and a pixel shuffle (synthesis), a
GELU conv ``h_a``, separate ``h_mean_s`` / ``h_scale_s`` with subpel
upsampling, and ``charm``: per slice, mean and scale from the hyper
parameters and the decoded support slices, and a latent residual
prediction (``slice_residual``). ``CharmCodec`` serves TCM 2023 too.

``CharmCodec`` (a ``codec._SliceCodec``: v2 always, as the JAX package's)
codes each slice as one stream a sample and decodes it (K2, or K3 when
sorted) against the indexes the decoder derives from the slices before
it. Both sides add the symbols to the means in float32 and run the same
towers on the same tensors (``_slice_hat``), so the decoder's indexes
equal the encoder's bitwise.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..entropy import EntropyBottleneck, GaussianConditional
from ..entropy.ops import quantize_ste
from ..nn.conv import conv2d, native_conv, subpel_conv3x3
from ..nn.swin import SwinStage, reset_swin_parameters_
from ..utils.profiling import span
from .codec import _SliceCodec
from .google import CompressionModel, _ConvStack, _medians


def _cc_stack(widths: Sequence[int], out: int, cin: int, device) -> _ConvStack:
    """3x3 convs of ``widths`` with exact GELU between, then one to ``out``."""
    specs: List[Tuple] = []
    for w in widths:
        specs += [("conv", w, 3, 1), ("gelu",)]
    return _ConvStack(tuple(specs) + (("conv", out, 3, 1),), cin, device)


class CharmSlices(nn.Module):
    """Channel-autoregressive slice parameters (minnen2020-style, as STF
    and TCM use them): mean and scale of slice i from the hyper parameters
    and up to ``max_support`` decoded slices, and its latent residual
    prediction."""

    def __init__(self, M: int, num_slices: int, slice_size: int, max_support: int,
                 device=None):
        super().__init__()
        self.num_slices, self.max_support = num_slices, max_support
        s, widths = slice_size, (224, 176, 128, 64)
        for i in range(num_slices):
            sup = M + s * min(i, max_support)
            setattr(self, f"cc_mean_transforms_{i}", _cc_stack(widths, s, sup, device))
            setattr(self, f"cc_scale_transforms_{i}", _cc_stack(widths, s, sup, device))
            setattr(self, f"lrp_transforms_{i}",
                    _cc_stack(widths, s, M + s * min(i + 1, max_support + 1), device))

    def slice_entropy(self, latent_means: torch.Tensor, latent_scales: torch.Tensor,
                      y_hat_slices: Sequence[torch.Tensor], i: int):
        """(mu, sigma, lrp_in) of slice i: lrp_in is what ``slice_residual``
        reads besides the slice's y_hat (the means and the support)."""
        support = list(y_hat_slices[: self.max_support])
        mean_in = torch.cat([latent_means] + support, dim=1)
        mu = getattr(self, f"cc_mean_transforms_{i}")(mean_in)
        sigma = getattr(self, f"cc_scale_transforms_{i}")(
            torch.cat([latent_scales] + support, dim=1))
        return mu, sigma, mean_in

    def slice_residual(self, lrp_in: torch.Tensor, y_hat_slice: torch.Tensor,
                       i: int) -> torch.Tensor:
        x = torch.cat([lrp_in, y_hat_slice], dim=1)
        return 0.5 * torch.tanh(getattr(self, f"lrp_transforms_{i}")(x))


class _PatchEmbed2(nn.Module):
    """Non-overlapping 2x2 patch embed (a VALID strided conv)."""

    def __init__(self, in_channel: int, embed_dim: int, device=None):
        super().__init__()
        self.proj = nn.Conv2d(in_channel, embed_dim, 2, 2, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with native_conv():
            return self.proj(x)


class _HyperSynthesis(nn.Module):
    """conv 3x3 -> subpel x2 -> conv 3x3 -> subpel x2 -> conv 3x3 to M, GELU
    between."""

    def __init__(self, N: int, M: int, device=None):
        super().__init__()
        d = device
        self.c1 = conv2d(N, 240, 3, 1, d)
        self.up1 = subpel_conv3x3(240, 288, 2, d)
        self.c2 = conv2d(288, 336, 3, 1, d)
        self.up2 = subpel_conv3x3(336, 384, 2, d)
        self.c3 = conv2d(384, M, 3, 1, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in (self.c1, self.up1, self.c2, self.up2):
            x = F.gelu(layer(x))
        return self.c3(x)


class _CharmModel(CompressionModel):
    """The charm device surface shared by STF and TCM: analysis, the two
    hyper syntheses, synthesis, and the training forward; subclasses build
    g_a, g_s, h_a, h_mean_s, h_scale_s and the slice transforms, and give
    ``slice_entropy`` (mu, sigma and what the lrp reads) and
    ``slice_residual`` (the lrp)."""

    CODEC_KIND = "charm"
    downsampling_factor = 64

    @property
    def slice_size(self) -> int:
        return self.M // self.num_slices

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0):
        super().reset_parameters(seed)
        reset_swin_parameters_(self, torch.Generator(device=self.device).manual_seed(seed + 1))
        return self

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        y = self.g_a(x)
        z = self.h_a(y)
        z_hat, z_likelihoods = self.entropy_bottleneck(z, training=training, generator=generator)
        if not training:
            medians = _medians(self.entropy_bottleneck)
            z_hat = quantize_ste(z - medians) + medians
        latent_means, latent_scales = self.h_mean_s(z_hat), self.h_scale_s(z_hat)
        y_hat_slices: List[torch.Tensor] = []
        likelihoods: List[torch.Tensor] = []
        for i, y_slice in enumerate(torch.chunk(y, self.num_slices, dim=1)):
            mu, sigma, lrp_in = self.slice_entropy(latent_means, latent_scales, y_hat_slices, i)
            _, lk = self.gaussian_conditional(y_slice, sigma, means=mu, training=training,
                                              generator=generator)
            likelihoods.append(lk)
            y_hat_slice = quantize_ste(y_slice - mu) + mu
            y_hat_slices.append(y_hat_slice + self.slice_residual(lrp_in, y_hat_slice, i))
        x_hat = self.g_s(torch.cat(y_hat_slices, dim=1))
        return {"x_hat": x_hat,
                "likelihoods": {"y": torch.cat(likelihoods, dim=1), "z": z_likelihoods}}

    # ---- device halves for CharmCodec ----
    def analysis(self, x: torch.Tensor) -> Dict[str, Any]:
        y = self.g_a(x)
        z = self.h_a(y)
        z_sym = torch.round(z - _medians(self.entropy_bottleneck)).to(torch.int32)
        return {"y": y, "z_sym": z_sym, "z_shape": tuple(z.shape[-2:])}

    def hyper_params_from_z(self, z_sym: torch.Tensor):
        z_hat = z_sym.to(torch.float32) + _medians(self.entropy_bottleneck)
        return self.h_mean_s(z_hat), self.h_scale_s(z_hat)

    def synthesis(self, y_hat: torch.Tensor) -> torch.Tensor:
        return self.g_s(y_hat)


class SymmetricalTransFormer2022(_CharmModel):
    """stf2022 (the zoo's 'stf'): N = 4 embed_dim, M = 8 embed_dim."""

    def __init__(self, embed_dim: int = 48, depths: Tuple[int, ...] = (2, 2, 6, 2),
                 num_heads: Tuple[int, ...] = (3, 6, 12, 24), window_size: int = 4,
                 num_slices: int = 12, in_channel: int = 3, device=None):
        self.embed_dim, self.depths, self.num_heads = embed_dim, tuple(depths), tuple(num_heads)
        self.window_size, self.num_slices = window_size, num_slices
        super().__init__(embed_dim * 4, embed_dim * 8, in_channel, device)

    @property
    def max_support(self) -> int:
        return self.num_slices // 2

    def _build(self) -> None:
        ed, d, n = self.embed_dim, self.device, len(self.depths)
        N, M = self.N, self.M
        self.patch_embed = _PatchEmbed2(self.in_channel, ed, d)
        for i in range(n):
            setattr(self, f"layers_{i}", SwinStage(
                ed * 2 ** i, self.depths[i], self.num_heads[i], self.window_size,
                resample="merge" if i < n - 1 else None, device=d))
        for i in range(n):
            setattr(self, f"syn_layers_{i}", SwinStage(
                ed * 2 ** (n - 1 - i), self.depths[::-1][i], self.num_heads[::-1][i],
                self.window_size, resample="split" if i < n - 1 else None, device=d))
        self.end_conv_pre = _ConvStack((("conv", ed * 4, 5, 1),), ed, d)
        self.end_conv_out = conv2d(ed, self.in_channel, 3, 1, d)
        self.h_a = _ConvStack((("conv", 384, 3, 1), ("gelu",), ("conv", 336, 3, 1), ("gelu",),
                               ("conv", 288, 3, 2), ("gelu",), ("conv", 240, 3, 1), ("gelu",),
                               ("conv", N, 3, 2)), M, d)
        self.h_mean_s = _HyperSynthesis(N, M, d)
        self.h_scale_s = _HyperSynthesis(N, M, d)
        self.charm = CharmSlices(M, self.num_slices, self.slice_size, self.max_support, d)
        self.entropy_bottleneck = EntropyBottleneck(N, device=d)
        self.gaussian_conditional = GaussianConditional()

    def g_a(self, x: torch.Tensor) -> torch.Tensor:
        y = self.patch_embed(x)  # (B, ed, H/2, W/2)
        B, C, H, W = y.shape
        t = y.reshape(B, C, H * W).transpose(1, 2)
        for i in range(len(self.depths)):
            t, H, W = getattr(self, f"layers_{i}")(t, H, W)
        return t.transpose(1, 2).reshape(B, t.shape[-1], H, W)

    def g_s(self, y_hat: torch.Tensor) -> torch.Tensor:
        B, C, H, W = y_hat.shape
        t = y_hat.reshape(B, C, H * W).transpose(1, 2)
        for i in range(len(self.depths)):
            t, H, W = getattr(self, f"syn_layers_{i}")(t, H, W)
        ed = self.embed_dim
        x = self.end_conv_pre(t.transpose(1, 2).reshape(B, ed, H, W))  # (B, 4 ed, H, W)
        x = x.reshape(B, ed, 2, 2, H, W).permute(0, 1, 4, 2, 5, 3).reshape(B, ed, 2 * H, 2 * W)
        return self.end_conv_out(x)

    def slice_entropy(self, latent_means, latent_scales, y_hat_slices, i: int):
        return self.charm.slice_entropy(latent_means, latent_scales, y_hat_slices, i)

    def slice_residual(self, lrp_in, y_hat_slice, i: int):
        return self.charm.slice_residual(lrp_in, y_hat_slice, i)


class CharmCodec(_SliceCodec):
    """The channel-slice codec of STF and TCM: one v2 stream a slice and a
    sample. Each slice's towers are spans inside ``compress/encode_y`` and
    ``decompress/decode_y``: ``charm/params`` (the slice model: mu and
    sigma; args slice and support channels) and ``charm/lrp`` (the latent
    residual prediction), so those stages' own launches are the coder's."""

    def _symbols(self, y_slice: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
        return torch.round(y_slice - mu).to(torch.int32)

    def _indexes(self, sigma: torch.Tensor) -> torch.Tensor:
        """A slice's GC rows; the decoder's must equal the encoder's."""
        return self._gc_indexes(sigma)

    def _params(self, hyper, y_hat_slices, i: int):
        m, (latent_means, latent_scales) = self.model, hyper
        support = latent_means.shape[1] + sum(
            s.shape[1] for s in y_hat_slices[: m.max_support])
        with span("charm/params", slice=i, support=support):
            return m.slice_entropy(latent_means, latent_scales, y_hat_slices, i)

    def _slice_hat(self, sym, mu, lrp_in, i: int) -> torch.Tensor:
        """Slice i's y_hat from its symbols: + mu in float32, + lrp."""
        with span("charm/lrp", slice=i):
            y_hat_slice = sym.to(torch.float32) + mu
            return y_hat_slice + self.model.slice_residual(lrp_in, y_hat_slice, i)

    def _encode_slices(self, y: torch.Tensor, hyper) -> list:
        handles, y_hat_slices = [], []
        for i, y_slice in enumerate(torch.chunk(y, self.model.num_slices, dim=1)):
            mu, sigma, lrp_in = self._params(hyper, y_hat_slices, i)
            sym = self._symbols(y_slice, mu)
            handles += self._gc_coder.encode_dispatch_batch(sym, self._indexes(sigma))
            y_hat_slices.append(self._slice_hat(sym, mu, lrp_in, i))
        return handles

    def _decode_slices(self, ups: list, B: int, hyper, W: int) -> torch.Tensor:
        y_hat_slices: List[torch.Tensor] = []
        for i in range(self.model.num_slices):
            mu, sigma, lrp_in = self._params(hyper, y_hat_slices, i)
            sym = self._decode(ups[i * B:(i + 1) * B], self._indexes(sigma))
            y_hat_slices.append(self._slice_hat(sym, mu, lrp_in, i))
        return torch.cat(y_hat_slices, dim=1)
