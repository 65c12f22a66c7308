"""Swin transformer blocks: window attention with a relative-position bias
and cyclic shifts, patch merging and splitting.

Counterpart of ``cra5_tpu/nn/swin.py``, module by module and name by name
(``attn/qkv``, ``attn/proj``, ``attn/relative_position_bias_table``,
``norm1``/``norm2`` (epsilon 1e-5), ``mlp``, ``downsample``/``upsample``
with ``norm`` and ``reduction``, ``blocks_{i}``), so a flax tree loads
into these modules. Windows shrink to ``min(window, H, W)``; the shift is
0 when ``min(H, W) <= window``; inputs are padded bottom and right to a
multiple of the window; the shifted mask is additive -100, the softmax
float32, GELU exact. ``SwinBlock(fixed_window=True)`` (TCM's blocks) keeps
its window and shift at every input, a grid smaller than the window padded
up to it. Windows hold window**2 tokens (16 or 64 at the codecs' windows
of 4 and 8), far below ``nn/blocks.py``'s flash route, so attention is the
plain matmul + softmax, as the JAX package leaves it to XLA, in chunks of
windows whose float32 logits stay within ``ATTN_CHUNK_BYTES`` (a 4K
frame's first TCM stage has 32 640 windows of 16 heads: 8.6 GB of logits
at once). The attention between the qkv and output projections is the
span ``swin/attn`` (args: windows, heads, tokens, head_dim).

The relative-position index and the shift regions are numpy arrays cached
by shape; each call makes its device copies on the caller's stream, so no
device tensor is shared across CUDA streams. The shifted mask is made on
the device a chunk at a time from each window's region labels (nW x N
int8), not copied over as the (nW, N, N) float mask.

A flax block sizes its bias table from the window its first input gives
it (``min(window, H, W)``). A PyTorch module is sized when it is built:
the table covers ``window_size``, and a block whose window shrinks on a
small input takes the table's rows of the offsets that window has (at
every input whose windows are full the two agree; ROADMAP C13).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import span
from .blocks import Dense, LayerNorm, Mlp, window_partition, window_reverse
from .init import lecun_normal_, trunc_normal_

LN_EPS = 1e-5
ATTN_CHUNK_BYTES = 1 << 30  # the float32 logits of one chunk of windows
MASKED = -100.0


@functools.lru_cache(maxsize=64)
def _relative_position_index(wh: int, ww: int, th: Optional[int] = None,
                             tw: Optional[int] = None) -> np.ndarray:
    """(N, N) rows of a (2 th - 1)(2 tw - 1) bias table for a wh x ww
    window (th, tw: the table's window, wh, ww by default)."""
    th, tw = th or wh, tw or ww
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, N, N)
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += th - 1
    rel[:, :, 1] += tw - 1
    rel[:, :, 0] *= 2 * tw - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=64)
def _shift_regions(Hp: int, Wp: int, window: int, shift: int) -> Optional[np.ndarray]:
    """(nW, N) int8 labels of the rolled-in regions each window's tokens
    come from; tokens of two labels do not attend to each other."""
    if shift == 0:
        return None
    img = np.zeros((1, Hp, Wp, 1), np.int8)
    cnt = 0
    for h in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for w in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[:, h, w, :] = cnt
            cnt += 1
    wins = img.reshape(1, Hp // window, window, Wp // window, window, 1)
    return wins.transpose(0, 1, 3, 2, 4, 5).reshape(-1, window * window)


def _lecun_dense_(lin: nn.Linear, generator: Optional[torch.Generator]) -> None:
    """flax ``nn.Dense``'s default init: lecun-normal kernel, zero bias."""
    lecun_normal_(lin.weight, lin.in_features, generator)
    if lin.bias is not None:
        lin.bias.zero_()


class SwinWindowAttention(nn.Module):
    """Multi-head attention within (B * nW, N, C) windows, with a learned
    bias per relative offset and head."""

    def __init__(self, dim: int, window_size: Tuple[int, int], num_heads: int,
                 qkv_bias: bool = True, device=None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.window_size = tuple(window_size)
        wh, ww = self.window_size
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * wh - 1) * (2 * ww - 1), num_heads, device=device))
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias, device=device)
        self.proj = Dense(dim, dim, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        trunc_normal_(self.relative_position_bias_table, 0.02, generator)
        _lecun_dense_(self.qkv, generator)
        _lecun_dense_(self.proj, generator)

    def forward(self, x: torch.Tensor, window: Tuple[int, int],
                regions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B * nW, N, C) windows of ``window`` (at most the table's);
        regions: (nW, N) labels of the shifted grid (``_shift_regions``),
        or None."""
        Bw, N, C = x.shape
        nH = self.num_heads
        hd = self.dim // nH
        qkv = self.qkv(x).reshape(Bw, N, 3, nH, hd).permute(2, 0, 3, 1, 4)
        with span("swin/attn", windows=Bw, heads=nH, tokens=N, head_dim=hd):
            idx = _relative_position_index(*window, *self.window_size)
            rel = torch.from_numpy(idx.reshape(-1)).to(x.device)
            bias = self.relative_position_bias_table[rel].reshape(N, N, nH)
            bias = bias.permute(2, 0, 1)[None].float()  # (1, nH, N, N)
            per = max(1, ATTN_CHUNK_BYTES // (4 * nH * N * N))
            out = torch.empty(Bw, N, C, dtype=x.dtype, device=x.device)
            for s in range(0, Bw, per):
                e = min(s + per, Bw)
                q, k, v = qkv[0, s:e], qkv[1, s:e], qkv[2, s:e]
                logits = torch.matmul(q * hd ** -0.5, k.transpose(-1, -2)).float() + bias
                if regions is not None:
                    lab = regions[torch.arange(s, e, device=x.device) % regions.shape[0]]
                    apart = (lab[:, None, :] != lab[:, :, None])[:, None]
                    logits = logits + torch.where(apart, MASKED, 0.0)
                probs = torch.softmax(logits, dim=-1).to(x.dtype)
                out[s:e] = torch.matmul(probs, v).transpose(1, 2).reshape(e - s, N, C)
        return self.proj(out)


class SwinBlock(nn.Module):
    """Pre-norm Swin block over (B, H*W, C) tokens: (shifted) window
    attention and an MLP, each residual. ``fixed_window``: the window and
    the shift hold at every input (the grid padded to a multiple of the
    window), where by default they shrink to a small input as the JAX
    package's do."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 4, shift_size: int = 0,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, fixed_window: bool = False,
                 device=None):
        super().__init__()
        self.dim, self.window_size, self.shift_size = dim, window_size, shift_size
        self.fixed_window = fixed_window
        self.norm1 = LayerNorm(dim, eps=LN_EPS, device=device)
        self.attn = SwinWindowAttention(dim, (window_size, window_size), num_heads, qkv_bias,
                                        device=device)
        self.norm2 = LayerNorm(dim, eps=LN_EPS, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, device=device)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, N, C = x.shape
        win = self.window_size
        if self.fixed_window:
            shift, win_eff = self.shift_size, win
        else:
            shift = self.shift_size if min(H, W) > win else 0
            win_eff = min(win, H, W)

        shortcut = x
        x = self.norm1(x).reshape(B, H, W, C)
        pad_b = (win_eff - H % win_eff) % win_eff
        pad_r = (win_eff - W % win_eff) % win_eff
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r

        regions = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            regions = torch.from_numpy(_shift_regions(Hp, Wp, win_eff, shift)).to(x.device)
        xw = self.attn(window_partition(x, win_eff, win_eff), (win_eff, win_eff), regions)
        x = window_reverse(xw, win_eff, win_eff, Hp, Wp)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        if pad_b or pad_r:
            x = x[:, :H, :W]
        x = shortcut + x.reshape(B, N, C)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """2x downsample: concat 2x2 neighbours -> LayerNorm -> linear 4C -> 2C."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=LN_EPS, device=device)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.norm.reset_parameters()
        _lecun_dense_(self.reduction, generator)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, N, C = x.shape
        x = x.reshape(B, H, W, C)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1).reshape(B, (H // 2) * (W // 2), 4 * C)
        return self.reduction(self.norm(x))


class PatchSplit(nn.Module):
    """2x upsample: LayerNorm -> linear C -> 2C -> C/2 a position of each
    2x2 (reshape (B, H, W, 2, 2, C/2), then (0, 1, 3, 2, 4, 5))."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.norm = LayerNorm(dim, eps=LN_EPS, device=device)
        self.reduction = Dense(dim, 2 * dim, bias=False, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.norm.reset_parameters()
        _lecun_dense_(self.reduction, generator)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, N, C = x.shape
        x = self.reduction(self.norm(x)).reshape(B, H, W, 2, 2, C // 2)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(B, 2 * H * 2 * W, C // 2)


class SwinStage(nn.Module):
    """``depth`` Swin blocks with alternating shifts, then an optional
    resample ("merge" | "split" | None)."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int = 4,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, resample: Optional[str] = None,
                 device=None):
        super().__init__()
        self.depth, self.resample = depth, resample
        for i in range(depth):
            setattr(self, f"blocks_{i}", SwinBlock(
                dim, num_heads, window_size, 0 if i % 2 == 0 else window_size // 2,
                mlp_ratio, qkv_bias, device=device))
        if resample == "merge":
            self.downsample = PatchMerging(dim, device=device)
        elif resample == "split":
            self.upsample = PatchSplit(dim, device=device)

    def forward(self, x: torch.Tensor, H: int, W: int) -> Tuple[torch.Tensor, int, int]:
        for i in range(self.depth):
            x = getattr(self, f"blocks_{i}")(x, H, W)
        if self.resample == "merge":
            return self.downsample(x, H, W), H // 2, W // 2
        if self.resample == "split":
            return self.upsample(x, H, W), H * 2, W * 2
        return x, H, W


@torch.no_grad()
def reset_swin_parameters_(module: nn.Module, generator: Optional[torch.Generator] = None):
    """The flax initializers of every Swin piece inside ``module``: the
    attention's bias table (truncated normal, 0.02) and lecun-normal
    ``qkv``/``proj``, the resamples' lecun-normal ``reduction``, the MLPs'
    truncated normal (0.02), unit LayerNorms."""
    for m in module.modules():
        if isinstance(m, (SwinWindowAttention, PatchMerging, PatchSplit, Mlp, LayerNorm)):
            m.reset_parameters(generator)
    return module
