"""ScaleSpaceFlow (Agustsson et al., CVPR 2020): the end-to-end video codec.

Counterpart of ``cra5_tpu/models/video.py``, module by module and name by
name, so a flax variables tree loads into it (``convert.load_flax_variables``):
an I-frame codec, a motion codec and a residual codec, each a mean/scale
``Hyperprior`` with separate mean and QReLU'd scale hyper-decoders, and
scale-space warping of the previous frame through a Gaussian volume and a
trilinear sampler.

  - ``gaussian_volume``: the blur pyramid as the JAX package computes it:
    depthwise separable blurs with zero 'same' padding, a 2 x 2 average
    pool that drops an odd last row or column, and the upsampling of each
    level back to full size as the contraction with ``jax.image.resize``'s
    bilinear weight matrices (``data/era5.py::_bilinear_weights``) on the
    caller's device.
  - ``warp_volume_3d``: the explicit gather of the JAX package (indexes
    clamped to the volume, weights as computed, each lerp ``a + (b - a) *
    w`` in the order x, y, then scale), with ``torch.gather``, so values and
    gradients follow JAX's arithmetic; not ``F.grid_sample``.
  - ``ScaleSpaceFlow.forward`` runs a (T, B, C, H, W) clip: the keyframe,
    then each inter frame predicted from the previous reconstruction. The
    training noise is drawn from an explicit ``torch.Generator``.

``ScaleSpaceFlowCodec`` codes every latent as one v2 lane-coder stream a
sample (K1 encodes; K2 decodes, or K3 a sorted kernel-safe stream) and
feeds the decoder's own frames back in: each inter frame is predicted from
the previous decoded frame. Encoder and decoder build the same reference
frames bitwise on one device, because both form ``y_hat = y_sym + means``
in float32 from the same int32 symbols, re-derive the GC indexes from the
z symbols alone, and run the towers on ``nn/conv.py``'s cuDNN-off
convolutions.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..coder.lane_coder import LaneCoder
from ..data.era5 import _bilinear_weights
from ..device import resolve_device
from ..entropy import (EntropyBottleneck, GaussianConditional, build_indexes, eb_update,
                       gc_update, get_scale_table)
from ..entropy.ops import quantize_ste
from ..nn.conv import deconv2d, native_conv, qrelu, reset_parameters_
from ..utils.profiling import stage_span
from .google import _ConvStack, _medians

WHICH = ("keyframe", "residual", "motion")


def _enc_spec(mid: int, out: int) -> Tuple[Tuple, ...]:
    return (
        ("conv", mid, 5, 2), ("relu",),
        ("conv", mid, 5, 2), ("relu",),
        ("conv", mid, 5, 2), ("relu",),
        ("conv", out, 5, 2),
    )


def _dec_spec(mid: int, out: int) -> Tuple[Tuple, ...]:
    return (
        ("deconv", mid, 5, 2), ("relu",),
        ("deconv", mid, 5, 2), ("relu",),
        ("deconv", mid, 5, 2), ("relu",),
        ("deconv", out, 5, 2),
    )


class _HyperDecoderQReLU(nn.Module):
    """The scale hyper-decoder: three deconvs, each followed by QReLU."""

    def __init__(self, in_channels: int, mid: int, out: int, device=None):
        super().__init__()
        self.d1 = deconv2d(in_channels, mid, 5, 2, device=device)
        self.d2 = deconv2d(mid, mid, 5, 2, device=device)
        self.d3 = deconv2d(mid, out, 5, 2, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = qrelu(self.d1(x))
        x = qrelu(self.d2(x))
        return qrelu(self.d3(x))


class Hyperprior(nn.Module):
    """The per-latent mean/scale hyperprior of ``planes`` channels."""

    def __init__(self, planes: int = 192, mid_planes: int = 192, device=None):
        super().__init__()
        p, m = planes, mid_planes
        self.hyper_encoder = _ConvStack(
            (("conv", m, 5, 2), ("relu",), ("conv", m, 5, 2), ("relu",), ("conv", p, 5, 2)),
            p, device)
        self.hyper_decoder_mean = _ConvStack(
            (("deconv", m, 5, 2), ("relu",), ("deconv", m, 5, 2), ("relu",),
             ("deconv", p, 5, 2)), p, device)
        self.hyper_decoder_scale = _HyperDecoderQReLU(p, m, p, device)
        self.entropy_bottleneck = EntropyBottleneck(m, device=device)
        self.gaussian_conditional = GaussianConditional()

    def params_from_zhat(self, z_hat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.hyper_decoder_scale(z_hat), self.hyper_decoder_mean(z_hat)

    def forward(self, y: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None):
        """(y_hat, {"y": likelihoods, "z": likelihoods}); when training, the
        EntropyBottleneck's noise and then the GaussianConditional's are
        drawn from ``generator``."""
        z = self.hyper_encoder(y)
        z_hat, z_likelihoods = self.entropy_bottleneck(z, training=training, generator=generator)
        scales, means = self.params_from_zhat(z_hat)
        _, y_likelihoods = self.gaussian_conditional(y, scales, means=means, training=training,
                                                     generator=generator)
        y_hat = quantize_ste(y - means) + means
        return y_hat, {"y": y_likelihoods, "z": z_likelihoods}

    # device halves for the codec
    def symbols(self, y: torch.Tensor) -> Dict[str, Any]:
        z = self.hyper_encoder(y)
        medians = _medians(self.entropy_bottleneck)
        z_sym = torch.round(z - medians).to(torch.int32)
        scales, means = self.params_from_zhat(z_sym.to(z.dtype) + medians)
        y_sym = torch.round(y - means).to(torch.int32)
        y_hat = y_sym.to(y.dtype) + means
        return {"y_sym": y_sym, "z_sym": z_sym, "scales": scales, "means": means,
                "y_hat": y_hat, "z_shape": tuple(z.shape[-2:])}

    def params_from_z_symbols(self, z_sym: torch.Tensor):
        z_hat = z_sym.to(torch.float32) + _medians(self.entropy_bottleneck)
        return self.params_from_zhat(z_hat)


@functools.lru_cache(maxsize=None)
def _gaussian_kernel1d(sigma: float) -> np.ndarray:
    ksize = 2 * int(math.ceil(3 * sigma)) + 1
    g = np.exp(-0.5 * ((np.arange(ksize) - ksize // 2) / sigma) ** 2)
    return (g / g.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _resize_weights(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """``jax.image.resize``'s (n_in, n_out) bilinear weights on ``device``,
    made once per geometry and device."""
    return torch.from_numpy(_bilinear_weights(n_in, n_out)).to(device)


def resize_bilinear(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(..., h, w) -> (..., H, W) as ``jax.image.resize(..., "bilinear")``:
    the contraction with one weight matrix an axis, rows then columns."""
    h, w = x.shape[-2:]
    if h != hw[0]:
        x = torch.matmul(_resize_weights(h, hw[0], x.device).t(), x)
    if w != hw[1]:
        x = torch.matmul(x, _resize_weights(w, hw[1], x.device))
    return x


def gaussian_blur(x: torch.Tensor, kernel1d: torch.Tensor) -> torch.Tensor:
    """Separable depthwise Gaussian blur with zero 'same' padding: along
    the rows, then along the columns."""
    C, k = x.shape[1], kernel1d.shape[0]
    pad = k // 2
    with native_conv():
        x = F.conv2d(x, kernel1d.reshape(1, 1, k, 1).expand(C, 1, k, 1), padding=(pad, 0),
                     groups=C)
        return F.conv2d(x, kernel1d.reshape(1, 1, 1, k).expand(C, 1, 1, k), padding=(0, pad),
                        groups=C)


def gaussian_volume(x: torch.Tensor, sigma: float, num_levels: int) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, L, H, W) blur pyramid, L = num_levels + 1:
    the input, its blur, then each level pooled 2 x 2 (an odd last row or
    column dropped), blurred and resized back to H x W."""
    kernel = torch.from_numpy(_gaussian_kernel1d(sigma)).to(x.device, x.dtype)
    volume = [x[:, :, None]]
    x = gaussian_blur(x, kernel)
    volume.append(x[:, :, None])
    H, W = x.shape[-2:]
    for _ in range(1, num_levels):
        x = F.avg_pool2d(x, 2, 2)
        x = gaussian_blur(x, kernel)
        volume.append(resize_bilinear(x, (H, W))[:, :, None])
    return torch.cat(volume, dim=2)


def warp_volume_3d(volume: torch.Tensor, flow: torch.Tensor,
                   scale_field: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of (N, C, L, H, W) at the normalized coordinates
    (grid + flow, scale_field), align_corners=False, the indexes clamped to
    the volume (border padding)."""
    N, C, L, H, W = volume.shape
    dev = volume.device
    ys = torch.linspace(-1.0 + 1.0 / H, 1.0 - 1.0 / H, H, dtype=torch.float32, device=dev)
    xs = torch.linspace(-1.0 + 1.0 / W, 1.0 - 1.0 / W, W, dtype=torch.float32, device=dev)
    base_y, base_x = torch.meshgrid(ys, xs, indexing="ij")  # (H, W)

    gx = base_x[None] + flow[:, 0]  # (N, H, W) normalized
    gy = base_y[None] + flow[:, 1]
    gz = scale_field[:, 0]

    # unnormalize (align_corners=False): p = ((g + 1) * S - 1) / 2
    px = ((gx + 1.0) * W - 1.0) * 0.5
    py = ((gy + 1.0) * H - 1.0) * 0.5
    pz = ((gz + 1.0) * L - 1.0) * 0.5

    def axis(p, size):
        p0 = torch.floor(p)
        i0 = p0.to(torch.int64)
        return i0.clamp(0, size - 1), (i0 + 1).clamp(0, size - 1), p - p0

    x0, x1, wx = axis(px, W)
    y0, y1, wy = axis(py, H)
    z0, z1, wz = axis(pz, L)
    flat = volume.reshape(N, C, L * H * W)

    def gather(zi, yi, xi):
        lin = ((zi * H + yi) * W + xi).reshape(N, 1, H * W)
        return torch.gather(flat, 2, lin.expand(N, C, H * W)).reshape(N, C, H, W)

    def lerp(a, b, w):
        return a + (b - a) * w[:, None]

    c00 = lerp(gather(z0, y0, x0), gather(z0, y0, x1), wx)
    c01 = lerp(gather(z0, y1, x0), gather(z0, y1, x1), wx)
    c10 = lerp(gather(z1, y0, x0), gather(z1, y0, x1), wx)
    c11 = lerp(gather(z1, y1, x0), gather(z1, y1, x1), wx)
    c0 = lerp(c00, c01, wy)
    c1 = lerp(c10, c11, wy)
    return lerp(c0, c1, wz)


class ScaleSpaceFlow(nn.Module):
    """The ScaleSpaceFlow video codec's towers on an explicit device (the
    card unless the caller asks for the CPU)."""

    def __init__(self, num_levels: int = 5, sigma0: float = 1.5, scale_field_shift: float = 1.0,
                 mid_planes: int = 128, planes: int = 192, in_channel: int = 3, device=None):
        super().__init__()
        self.num_levels, self.sigma0 = num_levels, sigma0
        self.scale_field_shift = scale_field_shift
        self.mid_planes, self.planes, self.in_channel = mid_planes, planes, in_channel
        self.device = d = resolve_device(device)
        m, p, c = mid_planes, planes, in_channel
        self.img_encoder = _ConvStack(_enc_spec(m, p), c, d)
        self.img_decoder = _ConvStack(_dec_spec(m, c), p, d)
        self.img_hyperprior = Hyperprior(p, p, d)
        self.res_encoder = _ConvStack(_enc_spec(m, p), c, d)
        self.res_decoder = _ConvStack(_dec_spec(m, c), 2 * p, d)
        self.res_hyperprior = Hyperprior(p, p, d)
        self.motion_encoder = _ConvStack(_enc_spec(m, p), 2 * c, d)
        self.motion_decoder = _ConvStack(_dec_spec(m, 3), p, d)
        self.motion_hyperprior = Hyperprior(p, p, d)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> "ScaleSpaceFlow":
        """The flax initializers, drawn from a generator seeded with
        ``seed`` on the model's device."""
        reset_parameters_(self, torch.Generator(device=self.device).manual_seed(seed))
        return self

    def forward_prediction(self, x_ref: torch.Tensor, motion_info: torch.Tensor) -> torch.Tensor:
        flow, scale_field = motion_info[:, :2], motion_info[:, 2:]
        volume = gaussian_volume(x_ref, self.sigma0, self.num_levels)
        return warp_volume_3d(volume, flow, scale_field + self.scale_field_shift - 1.0)

    def forward_keyframe(self, x, training: bool = False,
                         generator: Optional[torch.Generator] = None):
        y = self.img_encoder(x)
        y_hat, likelihoods = self.img_hyperprior(y, training=training, generator=generator)
        return self.img_decoder(y_hat), {"keyframe": likelihoods}

    def forward_inter(self, x_cur, x_ref, training: bool = False,
                      generator: Optional[torch.Generator] = None):
        y_motion = self.motion_encoder(torch.cat([x_cur, x_ref], dim=1))
        y_motion_hat, motion_lk = self.motion_hyperprior(y_motion, training=training,
                                                         generator=generator)
        x_pred = self.forward_prediction(x_ref, self.motion_decoder(y_motion_hat))
        y_res = self.res_encoder(x_cur - x_pred)
        y_res_hat, res_lk = self.res_hyperprior(y_res, training=training, generator=generator)
        x_res_hat = self.res_decoder(torch.cat([y_res_hat, y_motion_hat], dim=1))
        return x_pred + x_res_hat, {"motion": motion_lk, "residual": res_lk}

    def forward(self, frames: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """frames: (T, B, C, H, W) -> {"x_hat": (T, B, C, H, W), "likelihoods":
        one dict a frame}. The keyframe's reconstruction enters the first
        prediction without a gradient, as in the JAX package."""
        x_hat, lk = self.forward_keyframe(frames[0], training, generator)
        recs, lks = [x_hat], [lk]
        x_ref = x_hat.detach()
        for i in range(1, frames.shape[0]):
            x_ref, lk = self.forward_inter(frames[i], x_ref, training, generator)
            recs.append(x_ref)
            lks.append(lk)
        return {"x_hat": torch.stack(recs), "likelihoods": lks}

    def aux_loss(self) -> torch.Tensor:
        return (self.img_hyperprior.entropy_bottleneck.loss()
                + self.res_hyperprior.entropy_bottleneck.loss()
                + self.motion_hyperprior.entropy_bottleneck.loss())

    # ---- device halves for the codec ----
    def analyze(self, x: torch.Tensor, which: str) -> torch.Tensor:
        if which == "keyframe":
            return self.img_encoder(x)
        if which == "residual":
            return self.res_encoder(x)
        return self.motion_encoder(x)

    def hp(self, which: str) -> Hyperprior:
        return {"keyframe": self.img_hyperprior, "residual": self.res_hyperprior,
                "motion": self.motion_hyperprior}[which]

    def hp_symbols(self, y: torch.Tensor, which: str) -> Dict[str, Any]:
        return self.hp(which).symbols(y)

    def hp_params(self, z_sym: torch.Tensor, which: str):
        return self.hp(which).params_from_z_symbols(z_sym)

    def synthesize_keyframe(self, y_hat: torch.Tensor) -> torch.Tensor:
        return self.img_decoder(y_hat)

    def motion_to_pred(self, x_ref: torch.Tensor, y_motion_hat: torch.Tensor) -> torch.Tensor:
        return self.forward_prediction(x_ref, self.motion_decoder(y_motion_hat))

    def synthesize_res(self, y_res_hat: torch.Tensor, y_motion_hat: torch.Tensor) -> torch.Tensor:
        return self.res_decoder(torch.cat([y_res_hat, y_motion_hat], dim=1))


class ScaleSpaceFlowCodec:
    """Frame-serial compress/decompress: the keyframe, then per inter frame
    the motion latent and the residual latent, each coded through its
    hyperprior as a y and a z stream a sample (v2, on the model's device).

    ``compress(frames)`` takes a sequence of (B, C, H, W) frames and returns
    (strings, shapes) nested as the JAX package's: strings[0] = [y_strings,
    z_strings] of the keyframe, strings[i] = {"motion": [...], "residual":
    [...]}; shapes[0] the keyframe's z shape, shapes[i] {"motion": ...,
    "residual": ...}. ``decompress`` gives the list of decoded frames.

    The EntropyBottleneck tables come from each hyperprior's own parameters
    (``eb_update``), the GC table from the default scale table
    (``gc_update``). When ``stage_times`` is a dict, each stage ends in a
    device synchronize and adds its host seconds there under
    ``<compress|decompress>/<analysis|hyperprior|coder|motion|synthesis>``.
    ``_indexes``, ``_decode`` and ``_reference`` are the spy points of the
    gates (the GC indexes, the decoded symbols, each inter frame's
    reconstruction)."""

    def __init__(self, model: ScaleSpaceFlow):
        self.model = model
        self.device = model.device
        self.scale_table = get_scale_table()
        self._scale_table_dev = torch.as_tensor(self.scale_table, device=self.device)
        gc_table = gc_update(self.scale_table)
        gc_coder = LaneCoder(gc_table, device=self.device)
        self._tables, self._coders = {}, {}
        for which in WHICH:
            eb_table = eb_update(model.hp(which).entropy_bottleneck.params_numpy())
            self._tables[which] = {"eb": eb_table, "gc": gc_table}
            self._coders[which] = {"eb": LaneCoder(eb_table, device=self.device), "gc": gc_coder}
        self.stage_times: Optional[Dict[str, float]] = None

    def _stage(self, name: str):
        return stage_span(name, self.stage_times, self.device)

    def _indexes(self, scales: torch.Tensor) -> torch.Tensor:
        return build_indexes(scales.float(), self._scale_table_dev)

    def _channel_indexes(self, shape) -> torch.Tensor:
        B, C, H, W = (int(s) for s in shape)
        return torch.arange(C, dtype=torch.int32, device=self.device).reshape(
            1, C, 1, 1).expand(B, C, H, W)

    def _decode(self, coder: LaneCoder, strings, idx: torch.Tensor) -> torch.Tensor:
        return torch.stack([coder.decode_to_device(strings[i], idx[i])
                            for i in range(idx.shape[0])])

    def _reference(self, x_pred: torch.Tensor, y_res_hat: torch.Tensor,
                   y_motion_hat: torch.Tensor) -> torch.Tensor:
        return x_pred + self.model.synthesize_res(y_res_hat, y_motion_hat)

    def _code_hp(self, y: torch.Tensor, which: str):
        """One latent through hyperprior ``which`` -> (y_hat, [y_strings,
        z_strings], z shape)."""
        with self._stage("compress/hyperprior"):
            out = self.model.hp_symbols(y, which)
            gc_idx = self._indexes(out["scales"])
        coders = self._coders[which]
        z_sym, y_sym = out["z_sym"], out["y_sym"]
        z_idx = self._channel_indexes(z_sym.shape)
        with self._stage("compress/coder"):  # K1, one stream a sample
            z_strings = [coders["eb"].encode_from_device(z_sym[i], z_idx[i])
                         for i in range(z_sym.shape[0])]
            y_strings = [coders["gc"].encode_from_device(y_sym[i], gc_idx[i])
                         for i in range(y_sym.shape[0])]
        return out["y_hat"], [y_strings, z_strings], tuple(int(s) for s in z_sym.shape[-2:])

    def _decode_hp(self, strings, z_shape, which: str, batch: int) -> torch.Tensor:
        coders = self._coders[which]
        z_idx = self._channel_indexes((batch, self.model.planes, z_shape[0], z_shape[1]))
        with self._stage("decompress/coder"):  # K2
            z_sym = self._decode(coders["eb"], strings[1], z_idx)
        with self._stage("decompress/hyperprior"):
            scales, means = self.model.hp_params(z_sym, which)
            gc_idx = self._indexes(scales)
        with self._stage("decompress/coder"):  # K2, or K3 when sorted and kernel-safe
            y_sym = self._decode(coders["gc"], strings[0], gc_idx)
        return y_sym.to(torch.float32) + means

    @torch.inference_mode()
    def compress(self, frames: Sequence) -> Tuple[List, List]:
        m = self.model
        frame_strings, shape_infos = [], []
        as_t = lambda f: torch.as_tensor(f, dtype=torch.float32, device=self.device)  # noqa: E731
        x = as_t(frames[0])
        with self._stage("compress/analysis"):
            y = m.analyze(x, "keyframe")
        y_hat, strings, z_shape = self._code_hp(y, "keyframe")
        with self._stage("compress/synthesis"):
            x_ref = m.synthesize_keyframe(y_hat)
        frame_strings.append(strings)
        shape_infos.append(z_shape)
        for i in range(1, len(frames)):
            x_cur = as_t(frames[i])
            with self._stage("compress/analysis"):
                y_motion = m.analyze(torch.cat([x_cur, x_ref], dim=1), "motion")
            y_motion_hat, motion_strings, motion_shape = self._code_hp(y_motion, "motion")
            with self._stage("compress/motion"):
                x_pred = m.motion_to_pred(x_ref, y_motion_hat)
            with self._stage("compress/analysis"):
                y_res = m.analyze(x_cur - x_pred, "residual")
            y_res_hat, res_strings, res_shape = self._code_hp(y_res, "residual")
            with self._stage("compress/synthesis"):
                x_ref = self._reference(x_pred, y_res_hat, y_motion_hat)
            frame_strings.append({"motion": motion_strings, "residual": res_strings})
            shape_infos.append({"motion": motion_shape, "residual": res_shape})
        return frame_strings, shape_infos

    @torch.inference_mode()
    def decompress(self, strings: Sequence, shapes: Sequence) -> List[torch.Tensor]:
        m = self.model
        B = len(strings[0][1])
        y_hat = self._decode_hp(strings[0], shapes[0], "keyframe", B)
        with self._stage("decompress/synthesis"):
            x_ref = m.synthesize_keyframe(y_hat)
        frames = [x_ref]
        for i in range(1, len(strings)):
            y_motion_hat = self._decode_hp(strings[i]["motion"], shapes[i]["motion"], "motion", B)
            with self._stage("decompress/motion"):
                x_pred = m.motion_to_pred(x_ref, y_motion_hat)
            y_res_hat = self._decode_hp(strings[i]["residual"], shapes[i]["residual"],
                                        "residual", B)
            with self._stage("decompress/synthesis"):
                x_ref = self._reference(x_pred, y_res_hat, y_motion_hat)
            frames.append(x_ref)
        return frames
