"""The VAEformer's parameters by name and shape, made from the seed.

``shapes(model_cfg)`` lists every parameter under the program's names, from
the configuration alone; ``make(model_cfg, seed, device)`` draws them on the
device from one generator in two large calls (one normal, one uniform) and
cuts the leaves out of them. Rules, after the model's published init: dense
weights N(0, 0.02), the attention projection and fc2 of block i scaled by
1/sqrt(2 (i + 1)); patch, 1x1 and transposed-patch convolutions
N(0, 1/fan_in); biases 0; LayerNorm scales 1; sin-cos position tables; the
factorized prior's softplus-inverse matrices, U(-0.5, 0.5) biases, zero
factors and quantiles (-10, 0, 10).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from .seeds import sub_seed

EB_FILTERS = (3, 3, 3, 3)
EB_INIT_SCALE = 10.0


def _block(prefix: str, d: int) -> List[Tuple[str, tuple]]:
    return [(f"{prefix}.attn.qkv.weight", (3 * d, d)), (f"{prefix}.attn.qkv.bias", (3 * d,)),
            (f"{prefix}.attn.proj.weight", (d, d)), (f"{prefix}.attn.proj.bias", (d,)),
            (f"{prefix}.norm1.weight", (d,)), (f"{prefix}.norm1.bias", (d,)),
            (f"{prefix}.norm2.weight", (d,)), (f"{prefix}.norm2.bias", (d,)),
            (f"{prefix}.mlp.fc1.weight", (4 * d, d)), (f"{prefix}.mlp.fc1.bias", (4 * d,)),
            (f"{prefix}.mlp.fc2.weight", (d, 4 * d)), (f"{prefix}.mlp.fc2.bias", (d,))]


def mlp_hidden(width: int, z: int) -> int:
    return int(math.sqrt(width // z)) * z


def shapes(c: dict) -> Dict[str, tuple]:
    D, E, Z, hD = c["y_channels"], c["embed_dim"], c["z_channels"], c["hyper_embed_dim"]
    kh, kw = c["patch_size"]
    (H, W), (sh, sw) = c["img_size"], c["patch_stride"]
    g = (H // sh, W // sw)
    p1, p2 = c["hyper_patch"]
    hg = (g[0] // p1, g[1] // p2)
    hid = mlp_hidden(hD, Z)
    depth, hdepth = c["depth"], c["hyper_depth"]
    out = [("g_a.pos_embed", (1, g[0] * g[1], D)),
           ("g_a.patch_embed.weight", (D, c["in_chans"], kh, kw)), ("g_a.patch_embed.bias", (D,))]
    for i in range(depth // 2 + 1):
        out += _block(f"g_a.blocks.{i}", D)
    for j in range(depth - depth // 2):
        out += _block(f"g_s.blocks.{j}", D)
    out += [("g_s.norm.weight", (D,)), ("g_s.norm.bias", (D,)),
            ("g_s.final.weight", (D, c["in_chans"], kh, kw)),
            ("quant_conv.weight", (2 * E, 2 * D, 1, 1)), ("quant_conv.bias", (2 * E,)),
            ("post_quant_conv.weight", (D, E, 1, 1)), ("post_quant_conv.bias", (D,)),
            ("h_a.pos_embed", (1, hg[0] * hg[1], hD)),
            ("h_a.patch_embed.weight", (hD, E, p1, p2)), ("h_a.patch_embed.bias", (hD,))]
    for i in range(hdepth // 2):
        out += _block(f"h_a.blocks.{i}", hD)
    out += [("h_a.quan_mlp.fc1.weight", (hid, hD)), ("h_a.quan_mlp.fc1.bias", (hid,)),
            ("h_a.quan_mlp.fc2.weight", (Z, hid)), ("h_a.quan_mlp.fc2.bias", (Z,)),
            ("h_s.post_quan_mlp.fc1.weight", (hid, Z)), ("h_s.post_quan_mlp.fc1.bias", (hid,)),
            ("h_s.post_quan_mlp.fc2.weight", (hD, hid)), ("h_s.post_quan_mlp.fc2.bias", (hD,))]
    for j in range(hdepth - hdepth // 2):
        out += _block(f"h_s.blocks.{j}", hD)
    out += [("h_s.norm.weight", (hD,)), ("h_s.norm.bias", (hD,)),
            ("h_s.final.weight", (2 * E * p1 * p2, hD))]
    dims = (1,) + EB_FILTERS + (1,)
    for i in range(len(EB_FILTERS) + 1):
        out += [(f"entropy_bottleneck.matrix{i}", (Z, dims[i + 1], dims[i])),
                (f"entropy_bottleneck.bias{i}", (Z, dims[i + 1], 1))]
        if i < len(EB_FILTERS):
            out.append((f"entropy_bottleneck.factor{i}", (Z, dims[i + 1], 1)))
    out.append(("entropy_bottleneck.quantiles", (Z, 1, 3)))
    return dict(out)


def sincos(dim: int, grid) -> np.ndarray:
    """(h*w, dim): the first half encodes the column, the second the row,
    each as [sin(pos w_k), cos(pos w_k)], w_k = 10000^(-2k/(dim/2))."""
    def one(d, pos):
        omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64) / (d / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)
    wm, hm = np.meshgrid(np.arange(grid[1], dtype=np.float64), np.arange(grid[0], dtype=np.float64))
    return np.concatenate([one(dim // 2, wm), one(dim // 2, hm)], axis=1).astype(np.float32)


def _std(name: str, shape: tuple) -> float:
    """The normal draw's standard deviation of a random leaf (0: none)."""
    if name.endswith("pos_embed") or name.startswith("entropy_bottleneck") or len(shape) < 2:
        return 0.0
    if len(shape) == 4:  # patch, 1x1 and transposed-patch convolutions
        fan = shape[0] * shape[2] * shape[3] if name.endswith("final.weight") else int(np.prod(shape[1:]))
        return 1.0 / math.sqrt(fan)
    std = 0.02
    parts = name.split(".")
    if "blocks" in parts and (name.endswith("attn.proj.weight") or name.endswith("mlp.fc2.weight")):
        std *= (2.0 * (int(parts[parts.index("blocks") + 1]) + 1)) ** -0.5
    return std


@torch.no_grad()
def make(c: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter, float32 on ``device``, from ``seed``."""
    spec = shapes(c)
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    random = {k: s for k, s in spec.items() if _std(k, s) > 0}
    flat = torch.randn(sum(int(np.prod(s)) for s in random.values()), generator=g, device=device)
    uniform = torch.rand(sum(int(np.prod(s)) for k, s in spec.items()
                             if k.startswith("entropy_bottleneck.bias")), generator=g,
                         device=device) - 0.5
    out, at, at_u = {}, 0, 0
    scale = EB_INIT_SCALE ** (1.0 / (len(EB_FILTERS) + 1))
    dims = (1,) + EB_FILTERS + (1,)
    for name, shape in spec.items():
        n = int(np.prod(shape))
        if name in random:
            out[name] = flat[at:at + n].view(shape).mul_(_std(name, shape))
            at += n
        elif name.endswith("pos_embed"):
            grid = (c["img_size"][0] // c["patch_stride"][0], c["img_size"][1] // c["patch_stride"][1])
            if name.startswith("h_a"):
                grid = (grid[0] // c["hyper_patch"][0], grid[1] // c["hyper_patch"][1])
            out[name] = torch.from_numpy(sincos(shape[2], grid))[None].to(device)
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
        elif name.endswith("norm1.weight") or name.endswith("norm2.weight") or name.endswith("norm.weight"):
            out[name] = torch.ones(shape, device=device)
        else:  # biases, the prior's factors
            out[name] = torch.zeros(shape, device=device)
    return out
