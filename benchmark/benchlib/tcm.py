"""The TCM 2023 cell's own set-up: the seeded weights, the seeded images,
the entropy fit, and the program built from them.

Weights (``make``): every parameter of ``reference/tcm2023.py``'s
``param_shapes`` drawn on the device from one generator in two large calls
(one normal, one uniform), after the published inits: convolutions
N(0, 1/fan_in) with zero biases; GDN's beta 1 and gamma 0.1 I, stored
re-parameterised as the program stores them; the Swin blocks' linear
layers and relative-position tables N(0, 0.02), zero biases, unit
LayerNorms; the factorized prior's softplus-inverse matrices, U(-0.5, 0.5)
biases, zero factors and quantiles (-10, 0, 10). Two departures keep
the latent where a trained model's is: the first residual block's two
convolutions have kernels of zero sum (each output channel's mean over its
inputs and taps taken out), so that a flat grey frame maps to zero and y
carries the image's content rather than its mean level (with the plain
draws, y's per-channel offsets reached ~30 and set the code length at any
contrast); and g_a's last convolution is drawn at ``Y_GAIN`` times its
deviation, so that y's deviation at the base contrast is ~0.16, near the
Gaussian's smallest scale (0.11): the entropy side is fit there, and the
fitted models code 0.40 bpp near that contrast (at 0.1 of the deviation,
y read ~0.4, the fit's scales followed it, and coding near-zero latents
at those scales alone cost 470-540 kB an image, above the target).

Images (``field`` / ``frame``): a 3 x H x W field of three correlated
channels (a luminance and two weaker chroma fields, mixed as RGB is from
YCbCr), each a seeded normal draw shaped in the frequency domain to a 1/f^2
power spectrum (flat below 1/512 cycles a pixel, so that the frame's
lowest frequencies do not swing its clipped share from seed to seed),
scaled to the spectrum's expected unit deviation; ``frame`` takes
0.5 + contrast x field into [0, 1] and pads it with zeros, centred, to a
multiple of 64, as the program's ``tools/eval_model.py`` pads.

The fit (``fit_entropy``): ``benchlib/fit.py``'s recipe on the
reference's latents of seeded 512 x 512 crops: the noise-quantized bits
per latent element of (y, z) plus the quantile loss, the entropy side's
gradients (h_a, h_mean_s, h_scale_s, the SWAtten gates, the cc and lrp
transforms, the factorized prior) clipped to global norm 1 under Adam at
``lr``, the quantiles under their own Adam at ``lr``.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from reference import tcm2023 as ref
from reference.train import adam_, clip_, is_aux

from .seeds import sub_seed

EB_INIT_SCALE = 10.0
ZERO_SUM = ("g_a_in.conv1.conv.weight", "g_a_in.skip.conv.weight")
Y_GAIN = ("m_down3.resample.conv.weight", 0.04)
GDN_PEDESTAL = (2.0 ** -18) ** 2
F0 = 1.0 / 512  # cycles a pixel below which the spectrum is flat
# RGB from (luminance, blue-difference, red-difference), the chroma at half weight
MIX = ((1.0, 0.0, 0.701), (1.0, -0.172, -0.357), (1.0, 0.886, 0.0))
ENTROPY_SIDE = ("h_a_in", "ha_down1", "h_mean_in", "hs_up1", "h_scale_in", "hs_up2", "atten_",
                "cc_", "lrp_", "entropy_bottleneck")
CTOR = ("config", "head_dim", "N", "M", "num_slices", "max_support_slices", "in_channel",
        "window_size")


def _std(name: str, shape: tuple) -> float:
    """The normal draw's deviation of a random leaf (0: a fixed one)."""
    if name.endswith("conv.weight"):
        return 1.0 / math.sqrt(int(np.prod(shape[1:])))
    if name.endswith("relative_position_bias_table") or (
            name.endswith(".weight") and len(shape) == 2 and ".swin." in name):
        return 0.02
    return 0.0


@torch.no_grad()
def make(c: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter, float32 on ``device``, from ``seed``."""
    spec = ref.param_shapes(c)
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    random = {k: s for k, s in spec.items() if _std(k, s) > 0}
    flat = torch.randn(sum(int(np.prod(s)) for s in random.values()), generator=g, device=device)
    uniform = torch.rand(sum(int(np.prod(s)) for k, s in spec.items()
                             if k.startswith("entropy_bottleneck.bias")), generator=g,
                         device=device) - 0.5
    filters = ref.cfg_of(c)["eb_filters"]
    dims = (1,) + tuple(filters) + (1,)
    scale = EB_INIT_SCALE ** (1.0 / (len(filters) + 1))
    out, at, at_u = {}, 0, 0
    for name, shape in spec.items():
        n = int(np.prod(shape))
        if name in random:
            out[name] = flat[at:at + n].view(shape).mul_(_std(name, shape))
            at += n
            if name in ZERO_SUM:
                out[name].sub_(out[name].mean(dim=(1, 2, 3), keepdim=True))
            elif name == Y_GAIN[0]:
                out[name].mul_(Y_GAIN[1])
        elif name.startswith("entropy_bottleneck.matrix"):
            i = int(name[-1])
            out[name] = torch.full(shape, float(np.log(np.expm1(1.0 / scale / dims[i + 1]))),
                                   device=device)
        elif name.startswith("entropy_bottleneck.bias"):
            out[name] = uniform[at_u:at_u + n].view(shape)
            at_u += n
        elif name.endswith("quantiles"):
            out[name] = torch.tensor([-EB_INIT_SCALE, 0.0, EB_INIT_SCALE],
                                     device=device).expand(shape).contiguous()
        elif name.endswith(".beta"):
            out[name] = torch.full(shape, math.sqrt(1.0 + GDN_PEDESTAL), device=device)
        elif name.endswith(".gamma"):
            eye = 0.1 * torch.eye(shape[0], device=device)
            out[name] = torch.sqrt(torch.clamp(eye + GDN_PEDESTAL, min=GDN_PEDESTAL))
        elif name.endswith("norm1.weight") or name.endswith("norm2.weight"):
            out[name] = torch.ones(shape, device=device)
        else:  # biases, the prior's factors
            out[name] = torch.zeros(shape, device=device)
    return out


def _spectrum(H: int, W: int, device) -> torch.Tensor:
    fy = torch.fft.fftfreq(H, device=device, dtype=torch.float64)[:, None]
    fx = torch.fft.rfftfreq(W, device=device, dtype=torch.float64)[None, :]
    amp = 1.0 / torch.sqrt(fx ** 2 + fy ** 2).clamp(min=F0)
    amp[0, 0] = 0.0
    return amp


def _unit(H: int, W: int, amp: torch.Tensor) -> float:
    """The expected deviation of ``irfft2(rfft2(white) * amp)``."""
    full = amp[:, 1:(W + 1) // 2] if W % 2 == 0 else amp[:, 1:]
    total = (amp[:, :1] ** 2).sum() + 2 * (full ** 2).sum()
    if W % 2 == 0:
        total = total + (amp[:, -1:] ** 2).sum()
    return float(torch.sqrt(total / (H * W)))


def field(seed: int, index: int, H: int, W: int, device) -> torch.Tensor:
    """Pool image ``index`` of ``seed`` before its contrast: (3, H, W)."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "image", index))
    white = torch.randn((3, H, W), generator=g, device=device)
    amp = _spectrum(H, W, device)
    shaped = torch.fft.irfft2(torch.fft.rfft2(white.double()) * amp, s=(H, W))
    ycc = shaped / _unit(H, W, amp) * torch.tensor([1.0, 0.5, 0.5], device=device,
                                                   dtype=torch.float64)[:, None, None]
    mix = torch.tensor(MIX, device=device, dtype=torch.float64)
    return torch.einsum("ck,khw->chw", mix, ycc).float()


def frame(f: torch.Tensor, contrast: float, pad_to: int = 64) -> torch.Tensor:
    """(1, 3, Hp, Wp): 0.5 + contrast x field in [0, 1], zero-padded and
    centred to a multiple of ``pad_to``."""
    x = (0.5 + contrast * f).clamp_(0.0, 1.0)
    H, W = x.shape[-2:]
    ph, pw = -H % pad_to, -W % pad_to
    pad = (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2)
    return torch.nn.functional.pad(x[None], pad)


def fit_entropy(P: Dict[str, torch.Tensor], c: dict, seed: int, steps: int, lr: float,
                crop: int = 512, crops: int = 2, contrast: float = 0.1) -> Dict[str, torch.Tensor]:
    """The fitted entropy side, float32, from the float32 parameters ``P``
    (left as they are)."""
    dev = P["g_a_in.conv1.conv.weight"].device
    with torch.no_grad():
        R = ref.TCM(c, P)
        x = torch.cat([frame(field(seed, 1000 + i, crop, crop, dev), contrast)
                       for i in range(crops)])
        y = R.g_a(x)
    sub = {k: p.detach().clone().requires_grad_(True) for k, p in P.items()
           if k.startswith(ENTROPY_SIDE)}
    R = ref.TCM(c, {**P, **sub})
    names = list(sub)
    net = [k for k in names if not is_aux(k)]
    aux = [k for k in names if is_aux(k)]
    mu = {k: torch.zeros_like(p) for k, p in sub.items()}
    nu = {k: torch.zeros_like(p) for k, p in sub.items()}
    g = torch.Generator(device=dev).manual_seed(sub_seed(seed, "fit"))
    hc = ref.cfg_of(c)["hyper_channels"]
    z_shape = (y.shape[0], hc, -(-y.shape[2] // 4), -(-y.shape[3] // 4))
    for i in range(steps):
        eb_noise = torch.rand(z_shape, generator=g, device=dev) - 0.5
        gc_noise = torch.rand(y.shape, generator=g, device=dev) - 0.5
        loss = R.noisy_bits(y, eb_noise, gc_noise) / y.numel() + R.aux_loss()
        got = torch.autograd.grad(loss, [sub[k] for k in names], allow_unused=True)
        # the lrp of a slice no later slice reads has no rate gradient
        grads = {k: torch.zeros_like(sub[k]) if g is None else g for k, g in zip(names, got)}
        clip_([grads[k] for k in net], 1.0)
        for group in (net, aux):
            adam_([sub[k].data for k in group], [grads[k] for k in group],
                  [mu[k] for k in group], [nu[k] for k in group], i, lr)
    return {k: p.detach() for k, p in sub.items()}


def empty_program(c: dict, device):
    """The program's TCM, its parameters not yet set; raises at once if
    their names and shapes are not the configuration's."""
    from cra5_tpu_torch.models import TCM2023

    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in ref.cfg_of(c).items()
          if k in CTOR}
    model = TCM2023(**kw, device=device)
    own = {k: tuple(p.shape) for k, p in model.named_parameters()}
    want = ref.param_shapes(c)
    if own != want:
        extra, missing = sorted(set(own) - set(want)), sorted(set(want) - set(own))
        raise RuntimeError(f"the program's TCM parameters differ from the configuration's: "
                           f"{len(extra)} not in it (e.g. {extra[:3]}), {len(missing)} missing "
                           f"(e.g. {missing[:3]}), "
                           f"{sum(own[k] != want[k] for k in set(own) & set(want))} reshaped")
    return model


@torch.no_grad()
def fill(model, P: Dict[str, torch.Tensor]):
    for k, p in model.named_parameters():
        p.copy_(P[k])
    return model
