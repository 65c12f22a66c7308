"""The VAEformer in plain PyTorch, float32, as functions of a flat dict of
parameters named as the program names them.

Written from the model's description (arXiv:2405.03376, CRA5
``cra5/models/vaeformer``): a ViT-L analysis tower over 11 x 10 patches
(stride 10) with rectangular windows and a global block every
``interval``-th block, twin final blocks for the posterior's mean and log
variance, a 1 x 1 projection to the latent, a ViT hyperprior (encoder and
decoder) over 4 x 4 latent patches, a factorized prior on z, a mean-scale
Gaussian on y, and a ViT synthesis tower ending in the transposed patch
convolution. Departures from a textbook ViT that the model has: window
attention pads the grid at the bottom and right with zero tokens that take
part in their windows' softmax; the encoder's dual heads read the same
activations. Patch convolutions are ``unfold`` / ``fold`` with one matrix
product; attention is matmul + softmax, computed in chunks of windows and
heads and recomputed in the backward so that the global blocks fit.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import lowp

Params = Dict[str, torch.Tensor]
ATTN_CHUNK_BYTES = 1 << 30  # float32 logits of one chunk of (window, head) pairs


def window_of(i: int, interval: int, sizes: Sequence[Sequence[int]]) -> Optional[Tuple[int, int]]:
    """The window of block i (None: global), by the tower's pattern."""
    if (i + 1) % interval == 0:
        return None
    return tuple(sizes[min(i % interval, len(sizes) - 1)])


def _softmax_rows(q, k, scale, prec):
    return torch.softmax(torch.matmul(lowp.rounded(q * scale, prec),
                                      lowp.rounded(k, prec).transpose(-1, -2)), dim=-1)


class _Attend(torch.autograd.Function):
    """softmax(q k^T * scale) v over (B, N, D) slices, in chunks; the
    backward recomputes each chunk's probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, scale, prec):
        ctx.save_for_backward(q, k, v)
        ctx.scale, ctx.prec = scale, prec
        out = torch.empty_like(q)
        for sl in _chunks(q):
            p = _softmax_rows(q[sl], k[sl], scale, prec)
            out[sl] = torch.matmul(lowp.rounded(p, prec), lowp.rounded(v[sl], prec))
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        scale, prec = ctx.scale, ctx.prec
        rd = lambda t: lowp.rounded(t, prec)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        for sl in _chunks(q):
            p = _softmax_rows(q[sl], k[sl], scale, prec)
            gs = g[sl]
            dv[sl] = torch.matmul(rd(p).transpose(-1, -2), rd(gs))
            dp = torch.matmul(rd(gs), rd(v[sl]).transpose(-1, -2))
            ds = p * (dp - (dp * p).sum(-1, keepdim=True))
            dq[sl] = torch.matmul(rd(ds), rd(k[sl])) * scale
            dk[sl] = torch.matmul(rd(ds).transpose(-1, -2), rd(q[sl])) * scale
        return dq, dk, dv, None, None


def _chunks(q: torch.Tensor):
    n = q.shape[-2]
    per = max(1, ATTN_CHUNK_BYTES // (4 * n * n))
    return [slice(i, min(i + per, q.shape[0])) for i in range(0, q.shape[0], per)]


class VAEformer:
    """The model on a parameter dict ``P``; ``cfg`` is the configuration
    file's ``model`` block; ``prec`` rounds every matrix product's operands
    (``lowp``)."""

    def __init__(self, cfg: dict, P: Params, prec: str = "fp32"):
        self.c, self.P, self.prec = cfg, P, prec

    # -- layers ---------------------------------------------------------
    def linear(self, x, name, bias=True):
        y = lowp.matmul(x, self.P[name + ".weight"].t(), self.prec)
        return y + self.P[name + ".bias"] if bias else y

    def norm(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.P[name + ".weight"], self.P[name + ".bias"], 1e-6)

    def mlp(self, x, name):
        return self.linear(F.gelu(self.linear(x, name + ".fc1")), name + ".fc2")

    def attention(self, x, name, heads, H, W, window):
        B, N, C = x.shape
        if window is not None:
            wh, ww = window
            pb, pr = -H % wh, -W % ww
            x = F.pad(x.reshape(B, H, W, C), (0, 0, 0, pr, 0, pb))
            Hp, Wp = H + pb, W + pr
            x = x.reshape(B, Hp // wh, wh, Wp // ww, ww, C).permute(0, 1, 3, 2, 4, 5)
            x = x.reshape(-1, wh * ww, C)
        Bw, n, _ = x.shape
        hd = C // heads
        qkv = self.linear(x, name + ".qkv").reshape(Bw, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = (t.reshape(Bw * heads, n, hd) for t in qkv)
        o = _Attend.apply(q, k, v, hd ** -0.5, self.prec)
        o = self.linear(o.reshape(Bw, heads, n, hd).transpose(1, 2).reshape(Bw, n, C), name + ".proj")
        if window is not None:
            o = o.reshape(B, Hp // wh, Wp // ww, wh, ww, C).permute(0, 1, 3, 2, 4, 5)
            o = o.reshape(B, Hp, Wp, C)[:, :H, :W].reshape(B, H * W, C)
        return o

    def block(self, x, name, heads, H, W, window):
        x = x + self.attention(self.norm(x, name + ".norm1"), name + ".attn", heads, H, W, window)
        return x + self.mlp(self.norm(x, name + ".norm2"), name + ".mlp")

    def patch_embed(self, x, name, patch, stride):
        w = self.P[name + ".weight"]
        cols = F.unfold(x, tuple(patch), stride=tuple(stride)).transpose(1, 2)
        return lowp.matmul(cols, w.reshape(w.shape[0], -1).t(), self.prec) + self.P[name + ".bias"]

    def conv1x1(self, x, name):
        w = self.P[name + ".weight"][:, :, 0, 0]
        y = lowp.matmul(x.permute(0, 2, 3, 1), w.t(), self.prec) + self.P[name + ".bias"]
        return y.permute(0, 3, 1, 2)

    @staticmethod
    def grid(tokens, H, W):
        return tokens.transpose(1, 2).reshape(tokens.shape[0], -1, H, W)

    # -- towers ---------------------------------------------------------
    def g_a(self, x):
        """(B, in_chans, H, W) -> the posterior's mean, (B, embed_dim, h, w)."""
        c = self.c
        H, W = (s // t for s, t in zip(c["img_size"], c["patch_stride"]))
        h = self.patch_embed(x, "g_a.patch_embed", c["patch_size"], c["patch_stride"])
        h = h + self.P["g_a.pos_embed"]
        n_seq = c["depth"] // 2
        win = lambda i: window_of(min(i, n_seq - 1), c["interval"], c["window_sizes"])
        for i in range(n_seq - 1):
            h = self.block(h, f"g_a.blocks.{i}", c["num_heads"], H, W, win(i))
        mean = self.block(h, f"g_a.blocks.{n_seq - 1}", c["num_heads"], H, W, win(n_seq - 1))
        logvar = self.block(h, f"g_a.blocks.{n_seq}", c["num_heads"], H, W, win(n_seq))
        moments = self.conv1x1(self.grid(torch.cat([mean, logvar], 2), H, W), "quant_conv")
        return moments[:, : c["embed_dim"]]

    def g_s(self, y_hat):
        c = self.c
        B, _, H, W = y_hat.shape
        h = self.conv1x1(y_hat, "post_quant_conv").reshape(B, c["y_channels"], H * W).transpose(1, 2)
        d = c["depth"]
        for j in range(d - d // 2):
            h = self.block(h, f"g_s.blocks.{j}", c["num_heads"], H, W,
                           window_of(d // 2 + j, c["interval"], c["window_sizes"]))
        h = self.norm(h, "g_s.norm")
        w = self.P["g_s.final.weight"]  # (D, C, kh, kw): the transposed conv
        cols = lowp.matmul(h, w.reshape(w.shape[0], -1), self.prec).transpose(1, 2)
        return F.fold(cols, tuple(c["img_size"]), tuple(c["patch_size"]), stride=tuple(c["patch_stride"]))

    def h_a(self, y):
        c = self.c
        H, W = y.shape[2] // c["hyper_patch"][0], y.shape[3] // c["hyper_patch"][1]
        h = self.patch_embed(y, "h_a.patch_embed", c["hyper_patch"], c["hyper_patch"])
        h = h + self.P["h_a.pos_embed"]
        for i in range(c["hyper_depth"] // 2):
            h = self.block(h, f"h_a.blocks.{i}", c["hyper_num_heads"], H, W, None)
        return self.grid(self.mlp(h, "h_a.quan_mlp"), H, W)

    def h_s(self, z_hat):
        """(B, z, h, w) -> (scales, means), each (B, embed_dim, 4h, 4w)."""
        c = self.c
        B, C, H, W = z_hat.shape
        h = self.mlp(z_hat.reshape(B, C, H * W).transpose(1, 2), "h_s.post_quan_mlp")
        d = c["hyper_depth"]
        for j in range(d - d // 2):
            h = self.block(h, f"h_s.blocks.{j}", c["hyper_num_heads"], H, W, None)
        h = self.linear(self.norm(h, "h_s.norm"), "h_s.final", bias=False)
        p1, p2 = c["hyper_patch"]
        out = h.reshape(B, H, W, p1, p2, -1).permute(0, 5, 1, 3, 2, 4).reshape(B, -1, H * p1, W * p2)
        return out.chunk(2, dim=1)

    # -- entropy models ---------------------------------------------------
    def medians(self):
        return self.P["entropy_bottleneck.quantiles"][:, 0, 1].reshape(1, -1, 1, 1)

    def eb_logits(self, v, detach=False):
        """The factorized prior's monotone MLP; v: (C, 1, N)."""
        x = v
        k = 4
        for i in range(k + 1):
            get = lambda n: (self.P[f"entropy_bottleneck.{n}{i}"].detach() if detach
                             else self.P[f"entropy_bottleneck.{n}{i}"])
            x = lowp.matmul(F.softplus(get("matrix")), x, self.prec) + get("bias")
            if i < k:
                x = x + torch.tanh(get("factor")) * torch.tanh(x)
        return x

    def codec_symbols(self, x, scale_table: torch.Tensor):
        """What the codec's encoder derives from a field: the latent y, z,
        their symbols, the Gaussian's scales and means, the y indexes."""
        return self.symbols_from_y(self.g_a(x), scale_table)

    def symbols_from_y(self, y, scale_table: torch.Tensor):
        """``codec_symbols`` from the latent y."""
        z = self.h_a(y)
        z_sym = torch.round(z - self.medians())
        scales, means = self.h_s(z_sym + self.medians())
        return {"y": y, "z": z - self.medians(), "z_sym": z_sym.to(torch.int32),
                "scales": scales, "means": means,
                "y_sym": torch.round(y - means).to(torch.int32),
                "idx": indexes(scales, scale_table)}

    def hyper_from_z(self, z_sym, scale_table):
        """(scales, means, y indexes) from z symbols, as the decoder sees them."""
        scales, means = self.h_s(z_sym.float() + self.medians())
        return scales, means, indexes(scales, scale_table)


def indexes(scales: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Each scale's table row: the entries (all but the last) strictly
    below the scale bounded at the table's first."""
    s = scales.float().clamp(min=float(table[0]))
    return torch.searchsorted(table[:-1].contiguous(), s.reshape(-1)).reshape(s.shape).to(torch.int32)


class _LowerBound(torch.autograd.Function):
    """max(x, bound); the gradient passes where x >= bound or where it
    pushes x up."""

    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return x.clamp(min=bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where((x >= ctx.bound) | (g < 0), g, torch.zeros_like(g)), None


def lower_bound(x, bound):
    return _LowerBound.apply(x, bound)


def _std_cum(v):
    return 0.5 * torch.special.erfc(-(2 ** -0.5) * v)


def _lik_z(m: VAEformer, v):
    """The factorized prior's likelihood of z values v, (C, 1, N)."""
    return lower_bound(torch.sigmoid(m.eb_logits(v + 0.5)) - torch.sigmoid(m.eb_logits(v - 0.5)), 1e-9)


def _lik_y(y_hat, scales, means):
    s = lower_bound(scales, 0.11)
    d = (y_hat - means).abs()
    return lower_bound(_std_cum((0.5 - d) / s) - _std_cum((-0.5 - d) / s), 1e-9)


def noisy_likelihoods(m: VAEformer, y, z, eb_noise, gc_noise):
    """The training-mode likelihoods of (y, z) and y_hat: ``eb_noise``
    (C, 1, B*h*w) and ``gc_noise`` (B, C, H, W) are uniform noise."""
    B, C = z.shape[:2]
    vals = z.permute(1, 0, 2, 3).reshape(C, 1, -1) + eb_noise
    lik_z = _lik_z(m, vals)
    z_hat = vals.reshape(C, B, *z.shape[2:]).permute(1, 0, 2, 3)
    scales, means = m.h_s(z_hat)
    y_hat = y + gc_noise
    return _lik_y(y_hat, scales, means), lik_z, y_hat


def rate_bits(m: VAEformer, syms: dict) -> float:
    """The ideal code length, in bits, of ``codec_symbols``' own symbols
    under the reference's own entropy models."""
    med = m.medians()
    C = syms["z_sym"].shape[1]
    v = (syms["z_sym"].float() + med).permute(1, 0, 2, 3).reshape(C, 1, -1)
    y_hat = syms["y_sym"].float() + syms["means"]
    lik = (_lik_y(y_hat, syms["scales"], syms["means"]), _lik_z(m, v))
    return float(-sum(torch.log2(l.double()).sum() for l in lik))


def train_terms(m: VAEformer, x, eb_noise, gc_noise, n_pixels: int, n_values: int,
                lmbda: float, bpp_weight: float):
    """The training forward of one sample and its rate-distortion terms:
    ``eb_noise`` (C, 1, h*w) and ``gc_noise`` (1, C, H, W) are its rows of
    the step's uniform noise; ``n_pixels`` and ``n_values`` are the whole
    batch's B*H*W and B*C*H*W, the means' denominators."""
    y = m.g_a(x)
    lik_y, lik_z, y_hat = noisy_likelihoods(m, y, m.h_a(y.detach()), eb_noise, gc_noise)
    x_hat = m.g_s(y_hat)
    bits = -(torch.log(lik_y).sum() + torch.log(lik_z).sum()) / math.log(2)
    bpp = bpp_weight * bits / n_pixels
    mse = lmbda * (x - x_hat).square().sum() / n_values
    return bpp, mse


def aux_loss(m: VAEformer):
    """The factorized prior's quantile loss (only the quantiles move)."""
    t = math.log(2 / 1e-9 - 1)
    q = m.P["entropy_bottleneck.quantiles"]
    target = torch.tensor([-t, 0.0, t], device=q.device)
    return (m.eb_logits(q, detach=True) - target).abs().sum()
