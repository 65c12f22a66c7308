"""VAEformer ViT towers: encoder, decoder, hyperprior encoder/decoder.

Counterpart of ``cra5_tpu/nn/vit.py``; token layout is row-major (H-major)
NLC inside, NCHW at the module boundaries.

  - Block i uses window ``window_sizes[min(i % interval, len - 1)]`` and
    goes global every ``interval``-th block ((i + 1) % interval == 0).
  - The encoder's dual final block: ``blocks[n_seq - 1]`` (mean) and
    ``blocks[n_seq]`` (logvar) both read the same activations.
  - The decoder's window pattern uses i = depth // 2 + j, while its block
    index and layer_id use j.
  - The JAX towers' options, with their defaults: ``window=False`` makes
    every block global; ``z_dim`` puts the quantization MLPs inside the
    towers (the encoder's ``quan_mlp`` after the dual heads, 2 * z_dim
    out; the decoder's ``post_quan_mlp`` before its blocks);
    ``use_conv_transpose=False`` ends the decoder in the linear
    un-patchify, a bias-free ``Dense`` named ``final`` whose (B, N,
    out * p1 * p2) output is laid out as (B, out, Hp * p1, Wp * p2);
    ``qkv_bias``; ``drop_path_rate``, the stochastic depth of block i at
    ``np.linspace(0, rate, depth)[i]`` (the encoder's dual heads both at
    i = depth // 2 - 1), whose masks are drawn from the ``generator``
    passed to ``forward`` before a rematerialised block runs, so its
    recompute keeps them.
  - ``remat=True`` (or "full") recomputes each block of g_a and g_s in
    the backward (``torch.utils.checkpoint``, non-reentrant), as the JAX
    package's ``nn.remat`` does; the hyperprior towers are never
    rematerialized. Each recompute runs inside a ``train/recompute`` span
    (``utils/profiling.py``) on the thread that reruns the block.
    ``remat="dots"`` is the JAX package's
    ``dots_with_no_batch_dims_saveable`` policy as selective activation
    checkpointing: the outputs of matmuls without batch dims are saved and
    everything else is recomputed. A ``Dense`` (``F.linear``) on the
    blocks' 3-D tokens lowers to ``aten.addmm`` on the flattened tokens
    (``aten.mm`` without a bias), and those are the ops saved: qkv, proj,
    fc1 and fc2, four a block. The attention logits and their product with
    v are ``aten.bmm`` (a batch dim, as the einsum has in JAX), the global
    blocks' flash kernels run inside an ``autograd.Function``, and the
    norms and elementwise work are all recomputed.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..utils.profiling import span
from .blocks import Block, Dense, LayerNorm, Mlp
from .init import init_linear_
from .patch_embed import PatchEmbed, PatchUnembed
from .pos_embed import get_2d_sincos_pos_embed


def _win_for_block(i: int, window: bool, interval: int,
                   window_sizes: Sequence[Tuple[int, int]]) -> Optional[Tuple[int, int]]:
    """None -> global attention; else the rectangular window for block i."""
    if not window or (i + 1) % interval == 0:
        return None
    return tuple(window_sizes[min(i % interval, len(window_sizes) - 1)])


Remat = Union[bool, str]
# matmuls without batch dims: what dots_with_no_batch_dims_saveable saves
DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _check_remat(remat) -> Remat:
    """False, True (the whole block recomputed) or "dots"."""
    if remat not in (False, True, "full", "dots"):
        raise ValueError(f"remat must be False, True, 'full' or 'dots', got {remat!r}")
    return "dots" if remat == "dots" else bool(remat)


def dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Save the outputs of the matmuls without batch dims, recompute the rest."""
    return CheckpointPolicy.MUST_SAVE if op in DOTS_SAVED else CheckpointPolicy.PREFER_RECOMPUTE


class _RecomputeSpan:
    """A checkpoint's recompute context: a ``train/recompute`` span around
    ``inner`` (the selective policy's dispatch mode, or nothing). The
    checkpoint enters it only when the backward reruns the block, on the
    thread that reruns it; the span opens outside the policy's mode, which
    would take the range's own operator for one of the block's."""

    def __init__(self, inner=None):
        self.inner = inner

    def __enter__(self):
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(span("train/recompute"))
        if self.inner is not None:
            self._stack.enter_context(self.inner)
        return self

    def __exit__(self, *exc):
        return self._stack.__exit__(*exc)


def _full_contexts():
    return contextlib.nullcontext(), _RecomputeSpan()


def _dots_contexts():
    forward, recompute = create_selective_checkpoint_contexts(dots_policy)
    return forward, _RecomputeSpan(recompute)


def _run_block(blk: nn.Module, x: torch.Tensor, H: int, W: int, remat: Remat,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    keep = blk.drop_masks(x, generator)  # drawn once, outside any recompute
    if remat and torch.is_grad_enabled():
        return checkpoint(blk, x, H, W, None, keep, use_reentrant=False,
                          context_fn=_dots_contexts if remat == "dots" else _full_contexts)
    return blk(x, H, W, None, keep)


def _mlp_hidden(embed_dim: int, z_dim: int) -> int:
    return int(np.sqrt(embed_dim // z_dim)) * z_dim


def unpatchify(x: torch.Tensor, grid: Tuple[int, int], patch: Tuple[int, int]) -> torch.Tensor:
    """(B, Hp * Wp, C * p1 * p2) tokens -> (B, C, Hp * p1, Wp * p2): each
    token's vector read as (p1, p2, C), as the JAX towers lay it out."""
    (Hp, Wp), (p1, p2) = grid, patch
    B = x.shape[0]
    x = x.reshape(B, Hp, Wp, p1, p2, -1).permute(0, 5, 1, 3, 2, 4)
    return x.reshape(B, -1, Hp * p1, Wp * p2)


class _PosEmbed(nn.Module):
    """Holds a float32 ``pos_embed`` parameter (1, N, D), initialised to
    the 2-D sin-cos table and cast to the tokens' dtype where it is added."""

    def __init__(self, grid: Tuple[int, int], dim: int, device=None):
        super().__init__()
        self.grid, self.dim = tuple(grid), dim
        self.pos_embed = nn.Parameter(torch.empty(1, grid[0] * grid[1], dim, device=device))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.pos_embed.copy_(torch.from_numpy(get_2d_sincos_pos_embed(self.dim, self.grid))[None])


class ViTEncoder(_PosEmbed):
    """g_a: patch embed + windowed ViT with dual mean/logvar final blocks.
    Output: (B, 2*embed_dim, Hp, Wp) moments, or (B, 2*z_dim, Hp, Wp)
    through ``quan_mlp`` when ``z_dim`` is set."""

    def __init__(self, img_size, patch_size, patch_stride, in_chans: int, embed_dim: int,
                 depth: int, num_heads: int, window_sizes, interval: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, window: bool = True,
                 z_dim: Optional[int] = None, drop_path_rate: float = 0.0, remat=False,
                 dtype=torch.float32, device=None):
        grid = (img_size[0] // patch_stride[0], img_size[1] // patch_stride[1])
        super().__init__(grid, embed_dim, device)
        self.remat = _check_remat(remat)
        self.patch_embed = PatchEmbed(in_chans, embed_dim, patch_size, patch_stride, dtype, device)
        self.n_seq = depth // 2
        dpr = np.linspace(0.0, drop_path_rate, depth)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias,
                  window_size=_win_for_block(min(i, self.n_seq - 1), window, interval,
                                             window_sizes),
                  layer_id=i, drop_path=float(dpr[min(i, self.n_seq - 1)]), dtype=dtype,
                  device=device)
            for i in range(self.n_seq + 1)
        )
        if z_dim is not None:
            self.quan_mlp = Mlp(2 * embed_dim, 2 * _mlp_hidden(embed_dim, z_dim), 2 * z_dim,
                                dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        tokens, (Hp, Wp) = self.patch_embed(x)
        h = tokens + self.pos_embed.to(tokens.dtype)
        for blk in self.blocks[: self.n_seq - 1]:
            h = _run_block(blk, h, Hp, Wp, self.remat, generator)
        mean = _run_block(self.blocks[self.n_seq - 1], h, Hp, Wp, self.remat, generator)
        logvar = _run_block(self.blocks[self.n_seq], h, Hp, Wp, self.remat, generator)
        out = torch.cat([mean, logvar], dim=2)
        if hasattr(self, "quan_mlp"):
            out = self.quan_mlp(out)
        B, N, C = out.shape
        return out.reshape(B, Hp, Wp, C).permute(0, 3, 1, 2)


class ViTDecoder(nn.Module):
    """g_s: ViT decoder ending in LayerNorm + the exact ConvTranspose, or
    the linear un-patchify with ``use_conv_transpose=False``; with
    ``z_dim`` its input passes ``post_quan_mlp`` first."""

    def __init__(self, img_size, patch_size, patch_stride, out_chans: int, embed_dim: int,
                 depth: int, num_heads: int, window_sizes, interval: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, window: bool = True,
                 z_dim: Optional[int] = None, use_conv_transpose: bool = True,
                 drop_path_rate: float = 0.0, remat=False, dtype=torch.float32, device=None):
        super().__init__()
        self.remat = _check_remat(remat)
        self.patch_size = tuple(patch_size)
        if z_dim is not None:
            self.post_quan_mlp = Mlp(z_dim, _mlp_hidden(embed_dim, z_dim), embed_dim,
                                     dtype=dtype, device=device)
        dpr = np.linspace(0.0, drop_path_rate, depth)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias,
                  window_size=_win_for_block(depth // 2 + j, window, interval, window_sizes),
                  layer_id=j, drop_path=float(dpr[depth // 2 + j]), dtype=dtype, device=device)
            for j in range(depth - depth // 2)
        )
        self.norm = LayerNorm(embed_dim, dtype=dtype, device=device)
        if use_conv_transpose:
            self.final = PatchUnembed(embed_dim, out_chans, patch_size, patch_stride, dtype, device)
        else:
            p1, p2 = self.patch_size
            self.final = Dense(embed_dim, out_chans * p1 * p2, bias=False, dtype=dtype,
                               device=device)

    def reset_parameters(self, generator=None) -> None:
        if isinstance(self.final, Dense):  # the linear un-patchify; PatchUnembed inits itself
            init_linear_(self.final, generator)

    def forward(self, feat: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """feat: (B, C, Hp, Wp) -> (B, out_chans, H, W)."""
        B, C, Hp, Wp = feat.shape
        x = feat.contiguous().reshape(B, C, Hp * Wp).transpose(1, 2)
        if hasattr(self, "post_quan_mlp"):
            x = self.post_quan_mlp(x)
        for blk in self.blocks:
            x = _run_block(blk, x, Hp, Wp, self.remat, generator)
        x = self.norm(x)
        if isinstance(self.final, PatchUnembed):
            return self.final(x, (Hp, Wp))
        return unpatchify(self.final(x), (Hp, Wp), self.patch_size)


class HyperEncoder(_PosEmbed):
    """h_a: global-attention ViT over the latent grid + quantization MLP."""

    def __init__(self, img_size, patch_size, patch_stride, in_chans: int, z_dim: int,
                 embed_dim: int, depth: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path_rate: float = 0.0, dtype=torch.float32,
                 device=None):
        grid = (img_size[0] // patch_stride[0], img_size[1] // patch_stride[1])
        super().__init__(grid, embed_dim, device)
        self.patch_embed = PatchEmbed(in_chans, embed_dim, patch_size, patch_stride, dtype, device)
        dpr = np.linspace(0.0, drop_path_rate, depth)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, layer_id=i,
                  drop_path=float(dpr[i]), dtype=dtype, device=device)
            for i in range(depth // 2)
        )
        self.quan_mlp = Mlp(embed_dim, _mlp_hidden(embed_dim, z_dim), z_dim, dtype=dtype, device=device)

    def forward(self, y: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        tokens, (Hp, Wp) = self.patch_embed(y)
        x = tokens + self.pos_embed.to(tokens.dtype)
        for blk in self.blocks:
            x = blk(x, Hp, Wp, generator)
        x = self.quan_mlp(x)
        B, N, C = x.shape
        return x.reshape(B, Hp, Wp, C).permute(0, 3, 1, 2)


class HyperDecoder(nn.Module):
    """h_s: ViT over the hyper-latent grid; a final linear expands to
    2*out_chans per pixel (scales, means)."""

    def __init__(self, patch_size, out_chans: int, z_dim: int, embed_dim: int, depth: int,
                 num_heads: int, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path_rate: float = 0.0, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.patch_size = tuple(patch_size)
        self.post_quan_mlp = Mlp(z_dim, _mlp_hidden(embed_dim, z_dim), embed_dim,
                                 dtype=dtype, device=device)
        dpr = np.linspace(0.0, drop_path_rate, depth)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, layer_id=j,
                  drop_path=float(dpr[depth // 2 + j]), dtype=dtype, device=device)
            for j in range(depth - depth // 2)
        )
        self.norm = LayerNorm(embed_dim, dtype=dtype, device=device)
        p1, p2 = self.patch_size
        self.final = Dense(embed_dim, 2 * out_chans * p1 * p2, bias=False,
                           dtype=dtype, device=device)

    def reset_parameters(self, generator=None) -> None:
        init_linear_(self.final, generator)

    def forward(self, z_hat: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """z_hat: (B, z_dim, Hz, Wz) -> (B, 2*out_chans, Hz*p1, Wz*p2)."""
        B, C, Hp, Wp = z_hat.shape
        # one memory layout whatever the caller's strides: the decoder
        # re-derives the GC indexes from this tower, and a layout-dependent
        # matmul kernel would break their bit-equality with the encoder's
        x = z_hat.contiguous().reshape(B, C, Hp * Wp).transpose(1, 2).to(self.dtype)
        x = self.post_quan_mlp(x)
        for blk in self.blocks:
            x = blk(x, Hp, Wp, generator)
        return unpatchify(self.final(self.norm(x)), (Hp, Wp), self.patch_size)
