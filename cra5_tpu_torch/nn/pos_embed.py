"""2D sine-cosine positional embeddings (numpy; counterpart of
``cra5_tpu/nn/pos_embed.py``).

For a (H, W) token grid, the first half of the
embedding channels encodes the column coordinate and the second half the
row coordinate, each as [sin(pos*omega), cos(pos*omega)] with
omega_k = 1/10000^(2k/d). Tokens are flattened row-major (H-major).
"""

from __future__ import annotations

import numpy as np


def _1d_sincos(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size) -> np.ndarray:
    """Returns (H*W, embed_dim) float32."""
    if isinstance(grid_size, int):
        grid_size = (grid_size, grid_size)
    h, w = grid_size
    grid_h = np.arange(h, dtype=np.float64)
    grid_w = np.arange(w, dtype=np.float64)
    # (H, W) grids of the column (w) and row (h) coordinate of each token
    wmesh, hmesh = np.meshgrid(grid_w, grid_h)
    emb_w = _1d_sincos(embed_dim // 2, wmesh)
    emb_h = _1d_sincos(embed_dim // 2, hmesh)
    return np.concatenate([emb_w, emb_h], axis=1).astype(np.float32)
