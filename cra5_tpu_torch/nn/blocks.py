"""ViT building blocks: MLP, global and window attention, the pre-norm block.

Counterpart of ``cra5_tpu/nn/blocks.py``. Every layer keeps float32
parameters and computes in the model dtype, as flax does (the JAX package
sets no ``param_dtype``): ``Dense`` casts its input, weight and bias to
that dtype where it computes, and LayerNorm keeps float32 statistics and
casts its output. Attention logits and softmax are float32.

``_attend`` routes by the flash mode, the JAX package's
``set_flash_attention`` ("auto" | "on" | "off", read from
``CRA5_TPU_FLASH`` at import). Under "auto", the default, it routes to the
flash kernels exactly where the JAX package routes to its Pallas kernels on
its accelerator: on the card, for sequences of 2048 tokens or more, or when
the (B*H, N, N) float32 logits would reach 1 GiB. On the 268v main path
that selects the seven global blocks and no window or hyperprior block.
"on" sends every attention to ``flash_attention``: K4-K6 on the card, their
plain versions on the CPU (JAX's interpret mode on its CPU). "off" sends
every attention to the plain matmul + softmax, on the card too, as JAX's
"off" does; it is a mode the caller chose, not the main path. The route
is the differentiable ``flash_attention`` (K4 forward, K5/K6 backward), so
the global blocks' weights get their gradients. Elsewhere attention is plain matmul +
softmax, as the JAX package leaves it to XLA. The route looks at the shape
only, as the JAX package's does: its Pallas kernels take the head dim
from the operands, and so do the port's (``ops/attention.py`` picks the
kernel by dtype and head dim: tensor-core kernels at head dim 64 in bf16
and float32 and, for K4 and K6, at the other head dims of
``anydim_supports``; SIMT kernels for the rest), so nothing the TPU
kernels compute is computed plainly on the card.

Tensor parallelism (``parallel/tensor_parallel.py::parallelize_``) gives
a ``Dense`` its shard (column- or row-parallel by the dim it is cut over)
and an ``Attention`` its local head count: each rank then attends over
its own heads at the fixed head dim,
and ``_use_flash`` decides on the local ``batch_heads`` (the 268v global
blocks, 10 368 tokens, still take K4/K5/K6, at 8 heads of 64 when
tp = 2).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import flash_attention
from ..parallel.sharding import full_shape, shard_tensor
from ..parallel.tensor_parallel import CopyToTP, ReduceFromTP
from .init import init_linear_

FLASH_MIN_SEQ = 2048
FLASH_MIN_LOGIT_BYTES = 1 << 30
FLASH_MODES = ("auto", "on", "off")


def _check_flash_mode(mode: str) -> str:
    if mode not in FLASH_MODES:
        raise ValueError(f"invalid flash mode {mode!r}")
    return mode


_FLASH_MODE = _check_flash_mode(os.environ.get("CRA5_TPU_FLASH", "auto"))


def set_flash_attention(mode: str) -> None:
    """mode: "auto" | "on" | "off"."""
    global _FLASH_MODE
    _FLASH_MODE = _check_flash_mode(mode)


def flash_attention_mode() -> str:
    """The mode ``set_flash_attention`` (or ``CRA5_TPU_FLASH``) set."""
    return _FLASH_MODE


def _use_flash(n: int, batch_heads: int, device: torch.device) -> bool:
    if _FLASH_MODE != "auto":
        return _FLASH_MODE == "on"
    if device.type != "cuda":
        return False
    return n >= FLASH_MIN_SEQ or batch_heads * n * n * 4 >= FLASH_MIN_LOGIT_BYTES


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """q, k, v: (B, H, N, D)."""
    if _use_flash(q.shape[2], q.shape[0] * q.shape[1], q.device):
        return flash_attention(q, k, v, scale)
    logits = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


class Dense(nn.Linear):
    """A linear layer with float32 parameters that computes in ``dtype``.

    Under tensor parallelism (``parallel_``) it holds one rank's shard of a
    weight cut by a ``sharding.Split``. Cut over dim 0, its output features,
    it is column-parallel: the input passes ``CopyToTP``, whose backward
    sums the input gradient over the tp group. Cut over dim 1, its input
    features, it is row-parallel: its products are partial sums, taken in
    float32 and summed over the group (``ReduceFromTP``), and the bias is
    added once, after the sum, before the cast to ``dtype``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = dtype
        self.tp = None  # parallel.tensor_parallel.TPGroup under tensor parallelism
        self.split = None  # the weight's sharding.Split under tensor parallelism

    def parallel_(self, tp, split) -> None:
        """Hold rank ``tp.rank``'s shard of the weight cut by ``split``;
        the parameters are cut by the caller."""
        self.tp, self.split = tp, split
        if split[0] == 0:
            self.out_features //= tp.size
        else:
            self.in_features //= tp.size

    @torch.no_grad()
    def init_(self, generator=None, scale: float = 1.0) -> None:
        """``init_linear_``; a Dense that holds a shard draws the full
        weight and keeps its shard, so every rank holds its part of the
        one-device init."""
        if self.tp is None:
            init_linear_(self, generator, scale)
            return
        out_f, in_f = full_shape(self.weight.shape, self.split, self.tp.size)
        full = Dense(in_f, out_f, bias=False, device=self.weight.device)
        init_linear_(full, generator, scale)
        self.weight.copy_(shard_tensor(full.weight, self.split, self.tp.rank, self.tp.size))
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        bias = self.bias.to(d) if self.bias is not None else None
        if self.tp is not None and self.split[0] == 1:
            partial = F.linear(x.to(d).float(), self.weight.to(d).float())
            total = ReduceFromTP.apply(partial, self.tp)
            return (total if bias is None else total + bias.float()).to(d)
        if self.tp is not None:
            x = CopyToTP.apply(x, self.tp)
        return F.linear(x.to(d), self.weight.to(d), bias)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.float32, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias, self.eps).to(self.dtype)


class Mlp(nn.Module):
    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 out_init_scale: float = 1.0, dtype=torch.float32, device=None):
        super().__init__()
        self.out_init_scale = out_init_scale
        self.fc1 = Dense(in_features, hidden_features, dtype=dtype, device=device)
        self.fc2 = Dense(hidden_features, out_features, dtype=dtype, device=device)

    def reset_parameters(self, generator=None) -> None:
        self.fc1.init_(generator)
        self.fc2.init_(generator, self.out_init_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class DropPath(nn.Module):
    """Stochastic depth per sample, as the JAX package's ``DropPath``: in
    training mode with ``rate`` > 0 each sample's residual branch is kept
    with probability 1 - rate (a uniform draw below 1 - rate, from the
    ``torch.Generator`` the caller passes) and the kept ones are scaled by
    1 / (1 - rate); the identity in eval mode or at rate 0, which draw
    nothing. ``draw`` and the ``keep`` argument let a caller draw the mask
    outside a rematerialised block, so that its recompute sees the same
    mask."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def draw(self, batch: int, generator: Optional[torch.Generator],
             device) -> Optional[torch.Tensor]:
        """The (batch,) bool keep mask, or None when the layer is inactive."""
        if self.rate == 0.0 or not self.training:
            return None
        if generator is None:
            raise ValueError("DropPath in training mode with a rate above 0 needs a generator")
        u = torch.rand(batch, generator=generator, device=device)
        return u < 1.0 - self.rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        if keep is None:
            keep = self.draw(x.shape[0], generator, x.device)
        if keep is None:
            return x
        mask = keep.reshape((x.shape[0],) + (1,) * (x.dim() - 1))
        return torch.where(mask, x / (1.0 - self.rate), 0.0)


class Attention(nn.Module):
    """Global multi-head self attention over all tokens."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 proj_init_scale: float = 1.0, dtype=torch.float32, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.local_heads = num_heads  # this rank's heads (num_heads / tp when split)
        self.head_dim = dim // num_heads
        self.proj_init_scale = proj_init_scale
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias, dtype=dtype, device=device)
        self.proj = Dense(dim, dim, dtype=dtype, device=device)

    def reset_parameters(self, generator=None) -> None:
        self.qkv.init_(generator)
        self.proj.init_(generator, self.proj_init_scale)

    def _mha(self, x: torch.Tensor) -> torch.Tensor:
        B, N, _ = x.shape
        h, hd = self.local_heads, self.head_dim
        qkv = self.qkv(x).reshape(B, N, 3, h, hd).permute(2, 0, 3, 1, 4)
        out = _attend(qkv[0], qkv[1], qkv[2], hd ** -0.5)
        return self.proj(out.transpose(1, 2).reshape(B, N, h * hd))

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        return self._mha(x)


def window_partition(x: torch.Tensor, wh: int, ww: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nWh * nWw, wh*ww, C); H % wh == 0, W % ww == 0."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // wh, wh, W // ww, ww, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, wh * ww, C)


def window_reverse(windows: torch.Tensor, wh: int, ww: int, H: int, W: int) -> torch.Tensor:
    """(B * nW, wh*ww, C) -> (B, H, W, C)."""
    C = windows.shape[-1]
    B = windows.shape[0] // ((H // wh) * (W // ww))
    x = windows.reshape(B, H // wh, W // ww, wh, ww, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


class WindowAttention(Attention):
    """Rectangular-window attention: zero-pad bottom/right to a window
    multiple, attend within each window, crop. The padded tokens are not
    masked: they carry qkv = bias and take part in every softmax of their
    window, exactly as in the JAX package."""

    def __init__(self, dim: int, num_heads: int, window_size: Tuple[int, int],
                 qkv_bias: bool = True, proj_init_scale: float = 1.0,
                 dtype=torch.float32, device=None):
        super().__init__(dim, num_heads, qkv_bias, proj_init_scale, dtype, device)
        self.window_size = tuple(window_size)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, N, C = x.shape
        wh, ww = self.window_size
        x = x.reshape(B, H, W, C)
        pad_b, pad_r = (wh - H % wh) % wh, (ww - W % ww) % ww
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        out = self._mha(window_partition(x, wh, ww))
        x = window_reverse(out, wh, ww, H + pad_b, W + pad_r)[:, :H, :W]
        return x.reshape(B, H * W, C)


class Block(nn.Module):
    """Pre-norm transformer block; window attention when ``window_size``
    is set, global attention otherwise. At init the attention projection
    and fc2 are scaled by 1/sqrt(2 * (layer_id + 1)). ``drop_path`` is the
    rate of the ``DropPath`` on both residual branches, which draw their
    masks apart (the attention's first) from ``generator``, or take the
    ``keep`` pair that ``drop_masks`` drew."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 window_size: Optional[Tuple[int, int]] = None, layer_id: Optional[int] = None,
                 drop_path: float = 0.0, dtype=torch.float32, device=None):
        super().__init__()
        rescale = (2.0 * (layer_id + 1)) ** -0.5 if layer_id is not None else 1.0
        self.window_size = window_size
        if window_size is not None:
            self.attn = WindowAttention(dim, num_heads, window_size, qkv_bias, rescale, dtype, device)
        else:
            self.attn = Attention(dim, num_heads, qkv_bias, rescale, dtype, device)
        self.norm1 = LayerNorm(dim, dtype=dtype, device=device)
        self.norm2 = LayerNorm(dim, dtype=dtype, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, rescale, dtype, device)
        self.drop_path = DropPath(drop_path)

    def drop_masks(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """The two branches' keep masks for input ``x`` (None each when the
        drop path is inactive)."""
        dp = self.drop_path
        return dp.draw(x.shape[0], generator, x.device), dp.draw(x.shape[0], generator, x.device)

    def forward(self, x: torch.Tensor, H: int, W: int,
                generator: Optional[torch.Generator] = None, keep=None) -> torch.Tensor:
        keep_attn, keep_mlp = keep if keep is not None else self.drop_masks(x, generator)
        x = x + self.drop_path(self.attn(self.norm1(x), H, W), keep=keep_attn)
        return x + self.drop_path(self.mlp(self.norm2(x)), keep=keep_mlp)
