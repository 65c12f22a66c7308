"""Model FLOPs of the VAEformer from its configuration's shapes: every
matrix product, counted as 2 m n k, as the model computes it.

Counted: the patch embed, every ViT block's GEMMs (qkv and proj on the
window grid with its padding, the MLP on the tokens), Q K^T and P V at the
block's window layout with its padding (global blocks over the whole grid),
the 1x1 projections, the hyperprior towers, the factorized prior's
per-channel MLP where the step evaluates it, and the transposed patch
convolution. Not counted: norms, softmax, activations, the coder.
"""

from __future__ import annotations

import math

from .params import mlp_hidden


def _window(i: int, c: dict):
    if (i + 1) % c["interval"] == 0:
        return None
    return c["window_sizes"][min(i % c["interval"], len(c["window_sizes"]) - 1)]


def block(d: int, grid, window) -> int:
    """One pre-norm block of width d on a (h, w) token grid."""
    n = grid[0] * grid[1]
    if window is None:
        n_pad, seq = n, n
    else:
        wh, ww = window
        n_pad = math.ceil(grid[0] / wh) * wh * math.ceil(grid[1] / ww) * ww
        seq = wh * ww
    gemms = 2 * n_pad * d * 3 * d + 2 * n_pad * d * d + 2 * n * d * 4 * d * 2
    return gemms + 2 * 2 * n_pad * seq * d


def towers(c: dict) -> dict:
    """FLOPs of each tower's forward for one timestep."""
    D, E, Z, hD = c["y_channels"], c["embed_dim"], c["z_channels"], c["hyper_embed_dim"]
    kh, kw = c["patch_size"]
    g = (c["img_size"][0] // c["patch_stride"][0], c["img_size"][1] // c["patch_stride"][1])
    n = g[0] * g[1]
    p1, p2 = c["hyper_patch"]
    hg = (g[0] // p1, g[1] // p2)
    hn = hg[0] * hg[1]
    hid = mlp_hidden(hD, Z)
    n_seq = c["depth"] // 2
    patch = 2 * n * c["in_chans"] * kh * kw * D
    g_a = patch + sum(block(D, g, _window(min(i, n_seq - 1), c)) for i in range(n_seq + 1))
    g_a += 2 * n * 2 * D * 2 * E  # quant_conv
    g_s = 2 * n * E * D + patch  # post_quant_conv, the transposed patch conv
    g_s += sum(block(D, g, _window(c["depth"] // 2 + j, c)) for j in range(c["depth"] - n_seq))
    h_a = 2 * hn * E * p1 * p2 * hD + sum(block(hD, hg, None) for _ in range(c["hyper_depth"] // 2))
    h_a += 2 * hn * (hD * hid + hid * Z)
    h_s = 2 * hn * (Z * hid + hid * hD) + 2 * hn * hD * 2 * E * p1 * p2
    h_s += sum(block(hD, hg, None) for _ in range(c["hyper_depth"] - c["hyper_depth"] // 2))
    eb_mlp = 2 * (1 * 3 + 3 * 3 * 3 + 3 * 1)  # one value through the prior's MLP
    return {"g_a": g_a, "g_s": g_s, "h_a": h_a, "h_s": h_s,
            "eb_train": 2 * eb_mlp * Z * hn, "eb_aux": eb_mlp * Z * 3}


def roundtrip(c: dict) -> int:
    """compress (g_a, h_a, h_s) then decompress (h_s, g_s) of one timestep."""
    t = towers(c)
    return t["g_a"] + t["h_a"] + 2 * t["h_s"] + t["g_s"]


def train_forward(c: dict) -> int:
    """The training forward of one timestep (the quantile loss apart)."""
    t = towers(c)
    return t["g_a"] + t["h_a"] + t["eb_train"] + t["h_s"] + t["g_s"]


def train_step(c: dict, batch: int) -> int:
    """Three times the forward, the backward's recompute left out."""
    return 3 * (batch * train_forward(c) + towers(c)["eb_aux"])
