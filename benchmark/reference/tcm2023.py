"""TCM 2023 in plain PyTorch, float32, as functions of a flat dict of
parameters named as the PyTorch port names them.

Written from the published model (Liu, Sun, Katto, "Learned Image
Compression with Mixed Transformer-CNN Architectures", CVPR 2023,
arXiv:2303.14978; code github.com/jmliu206/LIC_TCM ``models/tcm.py``), at
its configuration: N 128, M 320, two ConvTransBlocks a stage (W then SW)
with head widths 8/16/32/32/16/8 at window 8, hyper stages of head width
32 at window 4, z of 192 channels, five slices of 64 channels each reading
up to five decoded slices, SWAtten gates of head width 16 on 128 channels.

Equations (conv_k: k x k, padding k // 2, a bias; LReLU slope 0.01; GELU
exact; LN eps 1e-5; RBS / RBU: CompressAI's residual blocks with stride
and upsampling, GDN / IGDN on the port's re-parameterised beta and gamma):

  WMSA(dim, d, w, shifted): dim / d heads over w x w windows; shifted: the
    grid rolled by (-w/2, -w/2) first and back after, pairs of tokens from
    different regions masked out; logits (q d^-1/2) k^T + B[rel(i, j)],
    softmax in float32, then linear(dim -> dim).
  Block = x + WMSA(LN x), then x + MLP(LN x), MLP = linear(dim -> 4 dim),
    GELU, linear(4 dim -> dim).
  ConvTransBlock: (c, t) = split(conv_1(x)); c <- ResidualBlock(c) + c;
    t <- Block(t); x + conv_1(cat(c, t)).
  SWAtten(in -> out): h = conv_1(x); a = U(U(U(h))); b = conv_1(U(U(U(
    SwinPair(h))))); conv_1(h + a sigmoid(b)); U(v) = ReLU(v + conv_1(ReLU(
    conv_3(ReLU(conv_1(v)))))), CompressAI's AttentionBlock unit.
  Slice i (S: the first min(i, max_support) decoded slices): m = SWAtten(
    cat(mu_lat, S)), s = SWAtten(cat(sigma_lat, S)); mu = cc(m), sigma =
    cc(s) (conv_3 -> 224, GELU, conv_3 -> 128, GELU, conv_3 -> 64); symbols
    round(y - mu); y_hat = symbols + mu + 0.5 tanh(lrp(cat(m, y_hat))).

Departures, each listed:
  - The shift mask is -inf, as published; the port adds -100, whose
    weight e^-100 is below float32's smallest normal number.
  - Every block pads its grid at the bottom and right after its first
    norm to a multiple of the window and crops after; the window and the
    shift hold at every input. LIC_TCM pads a grid not larger than the
    window by (w - H) // 2 above and one more below, which its window
    partition cannot split unless w - H is odd, and returns the padded
    grid (its ``resize`` flag is never set). Not exercised where the
    grids are multiples of the window larger than it.
  - (b) SWAtten as above, (c) the lrp reading the attended mean support m,
    (d) the conv branch's ResidualBlock(c) + c: per LIC_TCM ``models/tcm.py``,
    not checked against a copy here.
  - Attention is computed in chunks of windows (``ATTN_CHUNK_BYTES`` of
    float32 logits), so that a 4K frame fits. Convolutions run with cuDNN
    off (im2col and a matrix product): with TF32 off, cuDNN's float32
    algorithms ran the zoo's towers tens of times slower on the card.
  - The relative-position table is ((2w - 1)^2, heads), row (dr + w - 1)
    (2w - 1) + dc + w - 1, as the port stores it; LIC_TCM stores it
    (heads, 2w - 1, 2w - 1).
  - An SWAtten gate's input is M + 64 min(i, max_support) channels and its
    output M + 64 min(i, 5), as LIC_TCM writes both (it has max_support 5).

``prec`` rounds the operands of every product and convolution: "fp32"
leaves them (building a model switches TF32 off), "tf32" rounds them to
TF32's 10-bit mantissa (the control one precision down). This file imports
no JAX and nothing of the port; the benchmark holds an identical copy.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
ATTN_CHUNK_BYTES = 1 << 30
LN_EPS = 1e-5
SCALES_MIN, SCALES_MAX, SCALES_LEVELS = 0.11, 256.0, 64
LIKELIHOOD_BOUND = 1e-9
GDN_PEDESTAL = (2.0 ** -18) ** 2

PUBLISHED = {"in_channel": 3, "N": 128, "M": 320, "config": [2, 2, 2, 2, 2, 2],
             "head_dim": [8, 16, 32, 32, 16, 8], "window_size": 8, "num_slices": 5,
             "max_support_slices": 5, "hyper_channels": 192, "hyper_window": 4,
             "hyper_head_dim": 32, "atten_head_dim": 16, "atten_inter_dim": 128,
             "cc_widths": [224, 128], "mlp_ratio": 4, "eb_filters": [3, 3, 3, 3]}


def cfg_of(c: dict) -> dict:
    """The published configuration overridden by ``c``'s keys."""
    return {**PUBLISHED, **c}


# -- parameter names and shapes ---------------------------------------------
def _conv(name, cin, cout, k):
    return [(f"{name}.conv.weight", (cout, cin, k, k)), (f"{name}.conv.bias", (cout,))]


def _rbs(name, cin, cout):
    return (_conv(f"{name}.conv1", cin, cout, 3) + _conv(f"{name}.conv2", cout, cout, 3)
            + [(f"{name}.gdn.g.beta", (cout,)), (f"{name}.gdn.g.gamma", (cout, cout))]
            + _conv(f"{name}.skip", cin, cout, 1))


def _rbu(name, cin, cout):
    return (_conv(f"{name}.subpel.conv", cin, 4 * cout, 3) + _conv(f"{name}.conv", cout, cout, 3)
            + [(f"{name}.igdn.g.beta", (cout,)), (f"{name}.igdn.g.gamma", (cout, cout))]
            + _conv(f"{name}.upsample.conv", cin, 4 * cout, 3))


def _swin(name, dim, head_dim, w, ratio):
    heads, hid = max(1, dim // head_dim), dim * ratio
    p = f"{name}.swin"
    return [(f"{p}.norm1.weight", (dim,)), (f"{p}.norm1.bias", (dim,)),
            (f"{p}.attn.relative_position_bias_table", ((2 * w - 1) ** 2, heads)),
            (f"{p}.attn.qkv.weight", (3 * dim, dim)), (f"{p}.attn.qkv.bias", (3 * dim,)),
            (f"{p}.attn.proj.weight", (dim, dim)), (f"{p}.attn.proj.bias", (dim,)),
            (f"{p}.norm2.weight", (dim,)), (f"{p}.norm2.bias", (dim,)),
            (f"{p}.mlp.fc1.weight", (hid, dim)), (f"{p}.mlp.fc1.bias", (hid,)),
            (f"{p}.mlp.fc2.weight", (dim, hid)), (f"{p}.mlp.fc2.bias", (dim,))]


def _ctb(name, n, head_dim, w, ratio):
    return (_conv(f"{name}.conv1_1", 2 * n, 2 * n, 1) + _conv(f"{name}.conv_block.conv1", n, n, 3)
            + _conv(f"{name}.conv_block.conv2", n, n, 3)
            + _swin(f"{name}.trans_block", n, head_dim, w, ratio)
            + _conv(f"{name}.conv1_2", 2 * n, 2 * n, 1))


def _stage(name, c, depth, head_dim, w, resample):
    n = c["N"]
    out = []
    for i in range(depth):
        out += _ctb(f"{name}.ctb_{i}", n, head_dim, w, c["mlp_ratio"])
    kind, cout = resample
    r = f"{name}.resample"
    out += {"rbs": lambda: _rbs(r, 2 * n, cout), "rbu": lambda: _rbu(r, 2 * n, cout),
            "conv": lambda: _conv(r, 2 * n, cout, 3),
            "subpel": lambda: _conv(f"{r}.conv", 2 * n, 4 * cout, 3)}[kind]()
    return out


def _unit(name, ch):
    return (_conv(f"{name}.c1", ch, ch // 2, 1) + _conv(f"{name}.c2", ch // 2, ch // 2, 3)
            + _conv(f"{name}.c3", ch // 2, ch, 1))


def _swatten(name, c, cin, cout):
    d, w, r = c["atten_inter_dim"], c["window_size"], c["mlp_ratio"]
    out = _conv(f"{name}.in_conv", cin, d, 1)
    for i in range(3):
        out += _unit(f"{name}.trunk_{i}", d)
    out += _swin(f"{name}.mask_swin_0", d, c["atten_head_dim"], w, r)
    out += _swin(f"{name}.mask_swin_1", d, c["atten_head_dim"], w, r)
    for i in range(3):
        out += _unit(f"{name}.mask_{i}", d)
    return out + _conv(f"{name}.mask_conv", d, d, 1) + _conv(f"{name}.out_conv", d, cout, 1)


def _cc(name, c, cin, cout):
    (w1, w2) = c["cc_widths"]
    return _conv(f"{name}.l0", cin, w1, 3) + _conv(f"{name}.l2", w1, w2, 3) + _conv(
        f"{name}.l4", w2, cout, 3)


def _slice_dims(c: dict, i: int) -> Tuple[int, int, int]:
    """(SWAtten input, SWAtten output, slice) channels of slice i."""
    s = c["M"] // c["num_slices"]
    return c["M"] + s * min(i, c["max_support_slices"]), c["M"] + s * min(i, 5), s


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    """Every parameter's name and shape, in the port's order."""
    c = cfg_of(cfg)
    N, M, C, hc = c["N"], c["M"], c["in_channel"], c["hyper_channels"]
    k, hd, w = c["config"], c["head_dim"], c["window_size"]
    hw, hhd = c["hyper_window"], c["hyper_head_dim"]
    out = _rbs("g_a_in", C, 2 * N)
    for i in range(3):
        out += _stage(f"m_down{i + 1}", c, k[i], hd[i], w, ("rbs", 2 * N) if i < 2 else ("conv", M))
    out += _rbu("g_s_in", M, 2 * N)
    for i in range(3):
        out += _stage(f"m_up{i + 1}", c, k[3 + i], hd[3 + i], w,
                      ("rbu", 2 * N) if i < 2 else ("subpel", C))
    out += _rbs("h_a_in", M, 2 * N) + _stage("ha_down1", c, k[0], hhd, hw, ("conv", hc))
    out += _rbu("h_mean_in", hc, 2 * N) + _stage("hs_up1", c, k[3], hhd, hw, ("subpel", M))
    out += _rbu("h_scale_in", hc, 2 * N) + _stage("hs_up2", c, k[3], hhd, hw, ("subpel", M))
    for i in range(c["num_slices"]):
        sup, att, s = _slice_dims(c, i)
        for kind in ("mean", "scale"):
            out += _swatten(f"atten_{kind}_{i}", c, sup, att)
            out += _cc(f"cc_{kind}_transforms_{i}", c, att, s)
        out += _cc(f"lrp_transforms_{i}", c, att + s, s)
    dims = (1,) + tuple(c["eb_filters"]) + (1,)
    for i in range(len(c["eb_filters"]) + 1):
        out += [(f"entropy_bottleneck.matrix{i}", (hc, dims[i + 1], dims[i])),
                (f"entropy_bottleneck.bias{i}", (hc, dims[i + 1], 1))]
        if i < len(c["eb_filters"]):
            out.append((f"entropy_bottleneck.factor{i}", (hc, dims[i + 1], 1)))
    out.append(("entropy_bottleneck.quantiles", (hc, 1, 3)))
    return dict(out)


# -- precision ----------------------------------------------------------------
def _tf32(t: torch.Tensor) -> torch.Tensor:
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)  # 10-bit mantissa, ties away


def rounded(t: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "fp32":
        return t
    if prec == "tf32":
        return _tf32(t)
    raise ValueError(f"unknown precision {prec!r}")


def scale_table() -> torch.Tensor:
    return torch.from_numpy(np.exp(np.linspace(math.log(SCALES_MIN), math.log(SCALES_MAX),
                                               SCALES_LEVELS)).astype(np.float32))


def indexes(scales: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Each scale's table row: the entries (all but the last) strictly
    below the scale bounded at the table's first."""
    s = scales.float().clamp(min=float(table[0]))
    return torch.searchsorted(table[:-1].contiguous(), s.reshape(-1)).reshape(s.shape).to(
        torch.int32)


def _conv2d(x, w, b, stride=1, padding=0):
    """A convolution with cuDNN off: im2col and one matrix product."""
    with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
        return F.conv2d(x, w, b, stride, padding)


def _std_cum(v):
    return 0.5 * torch.special.erfc(-(2 ** -0.5) * v)


class TCM:
    """The model on a parameter dict ``P``; ``cfg`` overrides the published
    configuration (``PUBLISHED``); ``prec`` rounds every product's
    operands."""

    def __init__(self, cfg: dict, P: Params, prec: str = "fp32"):
        self.c, self.P, self.prec = cfg_of(cfg), P, prec
        # float32 products stay float32 on the card: TF32 is the control's, by rounding
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # -- layers -----------------------------------------------------------
    def conv(self, x, name, stride=1):
        w = self.P[name + ".conv.weight"]
        return _conv2d(rounded(x, self.prec), rounded(w, self.prec), self.P[name + ".conv.bias"],
                       stride, w.shape[-1] // 2)

    def linear(self, x, name):
        w = self.P[name + ".weight"]
        return torch.matmul(rounded(x, self.prec), rounded(w, self.prec).t()) + self.P[name + ".bias"]

    def gdn(self, x, name, inverse):
        bound = lambda r, lo: torch.clamp(r, min=(lo + GDN_PEDESTAL) ** 0.5) ** 2 - GDN_PEDESTAL
        beta = bound(self.P[name + ".beta"], 1e-6)
        gamma = bound(self.P[name + ".gamma"], 0.0)
        norm = _conv2d(rounded(x * x, self.prec), rounded(gamma, self.prec)[:, :, None, None], beta)
        norm = torch.sqrt(norm)
        return x * norm if inverse else x / norm

    def subpel(self, x, name):
        return F.pixel_shuffle(self.conv(x, name + ".conv"), 2)

    def rbs(self, x, name, stride=2):
        h = F.leaky_relu(self.conv(x, name + ".conv1", stride), 0.01)
        h = self.gdn(self.conv(h, name + ".conv2"), name + ".gdn.g", False)
        return self.conv(x, name + ".skip", stride) + h

    def rbu(self, x, name):
        h = F.leaky_relu(self.subpel(x, name + ".subpel"), 0.01)
        h = self.gdn(self.conv(h, name + ".conv"), name + ".igdn.g", True)
        return self.subpel(x, name + ".upsample") + h

    def residual_block(self, x, name):
        h = F.leaky_relu(self.conv(x, name + ".conv1"), 0.01)
        return x + F.leaky_relu(self.conv(h, name + ".conv2"), 0.01)

    def wmsa(self, t, name, heads, w, shifted):
        """Window attention over (B, H, W, C) normalized tokens."""
        B, H, W, C = t.shape
        Hp, Wp = -(-H // w) * w, -(-W // w) * w
        t = F.pad(t, (0, 0, 0, Wp - W, 0, Hp - H))
        sh = w // 2 if shifted else 0
        if sh:
            t = torch.roll(t, (-sh, -sh), (1, 2))
        nh, nw, n = Hp // w, Wp // w, w * w
        win = t.reshape(B, nh, w, nw, w, C).permute(0, 1, 3, 2, 4, 5).reshape(-1, n, C)
        d = C // heads
        qkv = self.linear(win, name + ".qkv").reshape(-1, n, 3, heads, d).permute(2, 0, 3, 1, 4)
        r, c = torch.arange(n) // w, torch.arange(n) % w
        rel = (r[:, None] - r[None, :] + w - 1) * (2 * w - 1) + (c[:, None] - c[None, :] + w - 1)
        table = self.P[name + ".relative_position_bias_table"]
        bias = table[rel.to(table.device)].permute(2, 0, 1)[None]  # (1, heads, n, n)
        apart = None
        if sh:
            band = lambda L: torch.bucketize(torch.arange(L), torch.tensor([L - w, L - sh]),
                                             right=True)
            lab = (3 * band(Hp)[:, None] + band(Wp)[None, :]).reshape(nh, w, nw, w)
            lab = lab.permute(0, 2, 1, 3).reshape(nh * nw, n).to(t.device)
            apart = lab[:, :, None] != lab[:, None, :]  # (nW, n, n)
        out = torch.empty(win.shape[0], heads, n, d, dtype=t.dtype, device=t.device)
        per = max(1, ATTN_CHUNK_BYTES // (4 * heads * n * n))
        for s in range(0, win.shape[0], per):
            e = min(s + per, win.shape[0])
            q, k, v = (rounded(qkv[j, s:e], self.prec) for j in range(3))
            logits = torch.matmul(rounded(q * d ** -0.5, self.prec), k.transpose(-1, -2)) + bias
            if apart is not None:
                m = apart[torch.arange(s, e, device=t.device) % apart.shape[0]][:, None]
                logits = logits.masked_fill(m, float("-inf"))
            out[s:e] = torch.matmul(rounded(torch.softmax(logits, -1), self.prec), v)
        o = self.linear(out.transpose(1, 2).reshape(-1, n, C), name + ".proj")
        o = o.reshape(B, nh, nw, w, w, C).permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
        if sh:
            o = torch.roll(o, (sh, sh), (1, 2))
        return o[:, :H, :W]

    def block(self, x, name, head_dim, w, shifted):
        """Block on an NCHW tensor."""
        t = x.permute(0, 2, 3, 1)
        C = t.shape[-1]
        p = name + ".swin"
        ln = lambda v, k: F.layer_norm(v, (C,), self.P[f"{p}.{k}.weight"], self.P[f"{p}.{k}.bias"],
                                       LN_EPS)
        t = t + self.wmsa(ln(t, "norm1"), p + ".attn", max(1, C // head_dim), w, shifted)
        h = F.gelu(self.linear(ln(t, "norm2"), p + ".mlp.fc1"))
        t = t + self.linear(h, p + ".mlp.fc2")
        return t.permute(0, 3, 1, 2)

    def ctb(self, x, name, head_dim, w, shifted):
        n = x.shape[1] // 2
        c, t = torch.split(self.conv(x, name + ".conv1_1"), [n, n], dim=1)
        c = self.residual_block(c, name + ".conv_block") + c
        t = self.block(t, name + ".trans_block", head_dim, w, shifted)
        return x + self.conv(torch.cat([c, t], 1), name + ".conv1_2")

    def stage(self, x, name, depth, head_dim, w, kind):
        for i in range(depth):
            x = self.ctb(x, f"{name}.ctb_{i}", head_dim, w, bool(i % 2))
        r = name + ".resample"
        if kind == "rbs":
            return self.rbs(x, r)
        if kind == "rbu":
            return self.rbu(x, r)
        if kind == "conv":
            return self.conv(x, r, 2)
        return self.subpel(x, r)

    def unit(self, v, name):
        h = F.relu(self.conv(F.relu(self.conv(v, name + ".c1")), name + ".c2"))
        return F.relu(v + self.conv(h, name + ".c3"))

    def swatten(self, x, name):
        c = self.c
        h = self.conv(x, name + ".in_conv")
        b = self.block(h, name + ".mask_swin_0", c["atten_head_dim"], c["window_size"], False)
        b = self.block(b, name + ".mask_swin_1", c["atten_head_dim"], c["window_size"], True)
        a = h
        for i in range(3):
            a, b = self.unit(a, f"{name}.trunk_{i}"), self.unit(b, f"{name}.mask_{i}")
        return self.conv(h + a * torch.sigmoid(self.conv(b, name + ".mask_conv")), name + ".out_conv")

    def cc(self, x, name):
        x = F.gelu(self.conv(x, name + ".l0"))
        return self.conv(F.gelu(self.conv(x, name + ".l2")), name + ".l4")

    # -- transforms ---------------------------------------------------------
    def g_a(self, x):
        c = self.c
        x = self.rbs(x, "g_a_in")
        for i in range(3):
            x = self.stage(x, f"m_down{i + 1}", c["config"][i], c["head_dim"][i], c["window_size"],
                           "rbs" if i < 2 else "conv")
        return x

    def g_s(self, y_hat):
        c = self.c
        x = self.rbu(y_hat, "g_s_in")
        for i in range(3):
            x = self.stage(x, f"m_up{i + 1}", c["config"][3 + i], c["head_dim"][3 + i],
                           c["window_size"], "rbu" if i < 2 else "subpel")
        return x

    def h_a(self, y):
        c = self.c
        return self.stage(self.rbs(y, "h_a_in"), "ha_down1", c["config"][0], c["hyper_head_dim"],
                          c["hyper_window"], "conv")

    def h_s(self, z_hat, which):
        """which: "mean" or "scale"."""
        c = self.c
        pre, st = ("h_mean_in", "hs_up1") if which == "mean" else ("h_scale_in", "hs_up2")
        return self.stage(self.rbu(z_hat, pre), st, c["config"][3], c["hyper_head_dim"],
                          c["hyper_window"], "subpel")

    def slice_entropy(self, latent_means, latent_scales, y_hat_slices: Sequence[torch.Tensor], i):
        """(mu, sigma, m) of slice i; m is the attended mean support."""
        support = list(y_hat_slices[: self.c["max_support_slices"]])
        m = self.swatten(torch.cat([latent_means] + support, 1), f"atten_mean_{i}")
        s = self.swatten(torch.cat([latent_scales] + support, 1), f"atten_scale_{i}")
        return self.cc(m, f"cc_mean_transforms_{i}"), self.cc(s, f"cc_scale_transforms_{i}"), m

    def slice_residual(self, m, y_hat_slice, i):
        return 0.5 * torch.tanh(self.cc(torch.cat([m, y_hat_slice], 1), f"lrp_transforms_{i}"))

    # -- entropy models -------------------------------------------------------
    def medians(self):
        return self.P["entropy_bottleneck.quantiles"][:, 0, 1].reshape(1, -1, 1, 1)

    def eb_logits(self, v, detach=False):
        """The factorized prior's monotone MLP; v: (C, 1, N)."""
        x = v
        k = len(self.c["eb_filters"])
        for i in range(k + 1):
            get = lambda n: (self.P[f"entropy_bottleneck.{n}{i}"].detach() if detach
                             else self.P[f"entropy_bottleneck.{n}{i}"])
            x = torch.matmul(rounded(F.softplus(get("matrix")), self.prec),
                             rounded(x, self.prec)) + get("bias")
            if i < k:
                x = x + torch.tanh(get("factor")) * torch.tanh(x)
        return x

    def lik_z(self, z_hat):
        """The factorized prior's likelihood of (B, C, h, w) values."""
        C = z_hat.shape[1]
        v = z_hat.transpose(0, 1).reshape(C, 1, -1)
        lik = torch.sigmoid(self.eb_logits(v + 0.5)) - torch.sigmoid(self.eb_logits(v - 0.5))
        return _lower_bound(lik, LIKELIHOOD_BOUND).reshape(C, z_hat.shape[0],
                                                           *z_hat.shape[2:]).transpose(0, 1)

    @staticmethod
    def lik_y(y_hat, sigma, mu):
        s = _lower_bound(sigma, SCALES_MIN)
        d = (y_hat - mu).abs()
        return _lower_bound(_std_cum((0.5 - d) / s) - _std_cum((-0.5 - d) / s), LIKELIHOOD_BOUND)

    def aux_loss(self):
        """The factorized prior's quantile loss (only the quantiles move)."""
        t = math.log(2 / LIKELIHOOD_BOUND - 1)
        q = self.P["entropy_bottleneck.quantiles"]
        target = torch.tensor([-t, 0.0, t], device=q.device)
        return (self.eb_logits(q, detach=True) - target).abs().sum()

    # -- the codec's chain ------------------------------------------------------
    def hyper(self, z_sym):
        """(latent means, latent scales) from z's symbols."""
        return self.hyper_from(z_sym.float() + self.medians())

    def hyper_from(self, z_hat):
        return self.h_s(z_hat, "mean"), self.h_s(z_hat, "scale")

    def slices(self, latent_means, latent_scales, y: Optional[torch.Tensor] = None,
               syms: Optional[List[torch.Tensor]] = None) -> dict:
        """The slice chain: with ``y``, its symbols round(y_i - mu_i); with
        ``syms``, the decoder's chain on those symbols. Per slice: mu,
        sigma, symbols and y_hat."""
        n = self.c["num_slices"]
        parts = torch.chunk(y, n, dim=1) if y is not None else [None] * n
        out = {"mu": [], "sigma": [], "sym": [], "y_hat": []}
        for i in range(n):
            mu, sigma, m = self.slice_entropy(latent_means, latent_scales, out["y_hat"], i)
            sym = torch.round(parts[i] - mu) if syms is None else syms[i].float()
            y_hat = sym + mu
            out["mu"].append(mu)
            out["sigma"].append(sigma)
            out["sym"].append(sym.to(torch.int32))
            out["y_hat"].append(y_hat + self.slice_residual(m, y_hat, i))
        return out

    def encode(self, x) -> dict:
        """What the encoder derives from an image: y, z less the medians,
        z's symbols, the hyper outputs and the slice chain."""
        y = self.g_a(x)
        z = self.h_a(y) - self.medians()
        z_sym = torch.round(z).to(torch.int32)
        lm, ls = self.hyper(z_sym)
        return {"y": y, "z": z, "z_sym": z_sym, "latent_means": lm, "latent_scales": ls,
                **self.slices(lm, ls, y=y)}

    def rate_bits(self, enc: dict) -> float:
        """The ideal code length of ``encode``'s symbols under the model's
        own entropy models, in bits."""
        bits = -torch.log2(self.lik_z(enc["z_sym"].float() + self.medians()).double()).sum()
        for sym, mu, sigma in zip(enc["sym"], enc["mu"], enc["sigma"]):
            bits = bits - torch.log2(self.lik_y(sym.float() + mu, sigma, mu).double()).sum()
        return float(bits)

    def forward(self, x) -> dict:
        """The eval forward: x_hat and the likelihoods of y and z."""
        enc = self.encode(x)
        z_hat = enc["z_sym"].float() + self.medians()
        lik_y = [self.lik_y(s.float() + mu, sg, mu)
                 for s, mu, sg in zip(enc["sym"], enc["mu"], enc["sigma"])]
        return {"x_hat": self.g_s(torch.cat(enc["y_hat"], 1)),
                "likelihoods": {"y": torch.cat(lik_y, 1), "z": self.lik_z(z_hat)}}

    def noisy_bits(self, y, eb_noise, gc_noise) -> torch.Tensor:
        """The training forward's bits of (y, z), as LIC_TCM trains: the
        likelihoods of z + ``eb_noise`` and of each slice + its part of
        ``gc_noise`` (uniform noise shaped like z and y), the hyper and the
        slice model fed straight-through rounded values."""
        z = self.h_a(y)
        bits = -torch.log2(self.lik_z(z + eb_noise)).sum()
        med = self.medians()
        lm, ls = self.hyper_from(_ste_round(z - med) + med)
        hats: List[torch.Tensor] = []
        n = self.c["num_slices"]
        for i, (y_i, u_i) in enumerate(zip(torch.chunk(y, n, 1), torch.chunk(gc_noise, n, 1))):
            mu, sigma, m = self.slice_entropy(lm, ls, hats, i)
            bits = bits - torch.log2(self.lik_y(y_i + u_i, sigma, mu)).sum()
            y_hat = _ste_round(y_i - mu) + mu
            hats.append(y_hat + self.slice_residual(m, y_hat, i))
        return bits


def _ste_round(v):
    return (torch.round(v) - v).detach() + v


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


def _lower_bound(x, bound):
    return _LowerBound.apply(x, bound)
