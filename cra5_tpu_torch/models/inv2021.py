"""InvCompress 2021 (Xie et al.): an invertible-network codec.

Counterpart of ``cra5_tpu/models/inv2021.py``, module by module and name
by name. The analysis transform is an invertible flow (three levels of
squeeze -> invertible 1x1 -> three affine couplings) between enhancement
blocks and attention; synthesis runs the same parameters in reverse (the
forward mean-reduces the flow's channels to M, the reverse repeats them;
the 1x1 mixes are inverted with ``torch.linalg.inv`` in float32). The
entropy side is mbt2018's joint autoregressive model, so the codec is
``codec.AutoregressiveCodec``.

The channel reduction is a mean over ``C // M`` groups of M, as the JAX
package writes it: it builds only when M divides the flow's
``in_channel * 64`` channels. The zoo's qualities 1-3 (N = M = 128 over
192 channels) raise ``ValueError`` here at construction; JAX's raise when
they first run (ROADMAP C11).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.conv import AttentionBlock, conv2d
from .google import JointAutoregressiveHierarchicalPriors


def squeeze2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // factor, factor, W // factor, factor).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(B, factor * factor * C, H // factor, W // factor)


def unsqueeze2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    B, C, H, W = x.shape
    f2 = factor * factor
    x = x.reshape(B, factor, factor, C // f2, H, W).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(B, C // f2, H * factor, W * factor)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class DenseBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, gc: int = 32, device=None):
        super().__init__()
        for i in range(4):
            setattr(self, f"conv{i + 1}", conv2d(in_channels + i * gc, gc, 3, 1, device))
        self.conv5 = conv2d(in_channels + 4 * gc, out_channels, 3, 1, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        for i in range(4):
            feats.append(_lrelu(getattr(self, f"conv{i + 1}")(torch.cat(feats, 1))))
        return self.conv5(torch.cat(feats, 1))


class EnhBlock(nn.Module):
    def __init__(self, nf: int, channels: int, device=None):
        super().__init__()
        d = device
        self.db1 = DenseBlock(channels, nf, device=d)
        self.c1 = conv2d(nf, nf, 1, 1, d)
        self.c2 = conv2d(nf, nf, 3, 1, d)
        self.c3 = conv2d(nf, nf, 1, 1, d)
        self.db2 = DenseBlock(nf, channels, device=d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.db2(self.c3(self.c2(self.c1(self.db1(x)))))
        return x + 0.2 * h


class _ZeroConv(conv2d):
    """A stride-1 'same' conv whose kernel starts at zero, so a coupling
    starts as the identity."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, device=None):
        super().__init__(in_channels, out_channels, kernel_size, 1, device)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.conv.weight.zero_()
        self.conv.bias.zero_()


class Bottleneck(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, device=None):
        super().__init__()
        k = kernel_size
        self.conv1 = conv2d(in_channels, out_channels, k, 1, device)
        self.conv2 = conv2d(out_channels, out_channels, 1, 1, device)
        self.conv3 = _ZeroConv(out_channels, out_channels, k, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv3(_lrelu(self.conv2(_lrelu(self.conv1(x)))))


class CouplingLayer(nn.Module):
    def __init__(self, split1: int, split2: int, kernel_size: int, clamp: float = 1.0,
                 device=None):
        super().__init__()
        self.split1, self.clamp = split1, clamp
        k, d = kernel_size, device
        self.G1 = Bottleneck(split1, split2, k, d)
        self.G2 = Bottleneck(split2, split1, k, d)
        self.H1 = Bottleneck(split1, split2, k, d)
        self.H2 = Bottleneck(split2, split1, k, d)

    def _scale(self, g: torch.Tensor) -> torch.Tensor:
        return torch.exp(self.clamp * (torch.sigmoid(g) * 2.0 - 1.0))

    def forward(self, x: torch.Tensor, rev: bool = False) -> torch.Tensor:
        x1, x2 = x[:, : self.split1], x[:, self.split1:]
        if not rev:
            y1 = x1 * self._scale(self.G2(x2)) + self.H2(x2)
            y2 = x2 * self._scale(self.G1(y1)) + self.H1(y1)
        else:
            y2 = (x2 - self.H1(x1)) / self._scale(self.G1(x1))
            y1 = (x1 - self.H2(y2)) / self._scale(self.G2(y2))
        return torch.cat([y1, y2], dim=1)


class InvertibleConv1x1(nn.Module):
    """A channel mix by a raw (C, C) matrix ("oc"), inverted on the
    reverse pass."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.eye(channels, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The flax init: the Q of a standard normal matrix's QR."""
        w = torch.empty_like(self.weight).normal_(generator=generator)
        self.weight.copy_(torch.linalg.qr(w)[0])

    def forward(self, x: torch.Tensor, rev: bool = False) -> torch.Tensor:
        w = torch.linalg.inv(self.weight.float()) if rev else self.weight
        return torch.einsum("oc,bchw->bohw", w, x)


class InvComp(nn.Module):
    """The 3-level flow: each level squeezes 2x, mixes channels, then runs
    3 affine couplings; forward mean-reduces to M channels, reverse
    repeats."""

    def __init__(self, M: int, in_channel: int, kernel_sizes: Tuple[int, int, int] = (5, 5, 3),
                 device=None):
        super().__init__()
        self.M = M
        self.ops = []
        nc = in_channel
        for level, k in enumerate(kernel_sizes):
            nc *= 4
            self.ops.append(("squeeze", None))
            setattr(self, f"mix_{level}", InvertibleConv1x1(nc, device))
            self.ops.append(("mix", f"mix_{level}"))
            for j in range(3):
                setattr(self, f"couple_{level}_{j}",
                        CouplingLayer(nc // 4, 3 * nc // 4, k, device=device))
                self.ops.append(("couple", f"couple_{level}_{j}"))
        self.total_nc = nc
        if nc % M:
            raise ValueError(
                f"InvComp: the flow's {nc} channels do not reduce to M={M} (a mean over groups "
                f"of M needs M to divide {nc}); the zoo's qualities 1-3 (M=128) cannot build, "
                f"in the JAX package as here")

    def forward(self, x: torch.Tensor, rev: bool = False) -> torch.Tensor:
        if not rev:
            for kind, name in self.ops:
                x = squeeze2d(x) if kind == "squeeze" else getattr(self, name)(x, rev=False)
            B, C, H, W = x.shape
            return x.reshape(B, C // self.M, self.M, H, W).mean(dim=1)
        x = x.repeat(1, self.total_nc // self.M, 1, 1)
        for kind, name in reversed(self.ops):
            x = unsqueeze2d(x) if kind == "squeeze" else getattr(self, name)(x, rev=True)
        return x


class InvCompress(JointAutoregressiveHierarchicalPriors):
    """The invertible codec over the mbt2018 joint autoregressive entropy
    model (N == M); g_a and g_s are methods over ``forw_enh``, ``inv``,
    ``forw_att`` and ``back_att``, ``inv`` (reversed), ``back_enh``."""

    N = 192
    M = 192

    def __init__(self, N: Optional[int] = None, M: Optional[int] = None, in_channel: int = 3,
                 enh_nf: int = 64, device=None):
        self.enh_nf = enh_nf
        super().__init__(N, M, in_channel, device)

    def _build_g(self) -> None:
        N, M, C, d = self.N, self.M, self.in_channel, self.device
        self.inv = InvComp(M, C, device=d)  # first: it refuses an M it cannot reduce to
        self.forw_enh = EnhBlock(self.enh_nf, C, d)
        self.back_enh = EnhBlock(self.enh_nf, C, d)
        self.forw_att = AttentionBlock(N, d)
        self.back_att = AttentionBlock(N, d)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> "InvCompress":
        super().reset_parameters(seed)
        gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        for m in self.modules():
            if isinstance(m, (_ZeroConv, InvertibleConv1x1)):
                m.reset_parameters(gen)
        return self

    def g_a(self, x: torch.Tensor) -> torch.Tensor:
        return self.forw_att(self.inv(self.forw_enh(x), rev=False))

    def g_s(self, y_hat: torch.Tensor) -> torch.Tensor:
        return self.back_enh(self.inv(self.back_att(y_hat), rev=True))
