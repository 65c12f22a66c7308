"""Copy the JAX package's VAEformer variables into the port's modules.

``load_flax_variables(model, variables)`` takes the flax variables as nested
dicts of numpy arrays (``jax.device_get`` output, or a checkpoint read
without JAX) and fills every parameter of the port's ``VAEformer``:

  - Dense ``kernel`` (in, out) -> ``nn.Linear.weight`` (out, in);
  - conv ``kernel`` in HWIO -> Conv2d layout (out, in, kh, kw) for the
    patch embeds and the 1x1 quant convs;
  - the ConvTranspose ``g_s/final/final/kernel`` (kh, kw, in, out) ->
    ConvTranspose2d layout (in, out, kh, kw), spatially flipped, because
    flax applies its ConvTranspose kernel flipped;
  - LayerNorm ``scale``/``bias``, ``pos_embed``, and the entropy
    bottleneck's ``matrix{i}``/``bias{i}``/``factor{i}``/``quantiles`` as
    they are.

It is strict: every flax leaf must be consumed and every torch parameter
filled, with matching shapes, or it raises ValueError.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch
from torch import nn

from .entropy import EntropyBottleneck
from .models.vaeformer import Conv1x1
from .nn.blocks import LayerNorm
from .nn.patch_embed import PatchEmbed, PatchUnembed
from .nn.vit import _PosEmbed


def _flatten(tree: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(_flatten(v, path))
        else:
            flat[path] = np.asarray(v)
    return flat


def _flax_path(torch_name: str) -> str:
    """'g_a.blocks.3.attn.qkv' -> 'g_a/blocks_3/attn/qkv'."""
    return re.sub(r"blocks\.(\d+)", r"blocks_\1", torch_name).replace(".", "/")


@torch.no_grad()
def load_flax_variables(model: nn.Module, variables: dict) -> nn.Module:
    params = variables.get("params", variables)
    flat = _flatten(params)
    used, filled = set(), set()

    def take(path: str) -> np.ndarray:
        path = path.lstrip("/")  # the root module's own leaves
        if path not in flat:
            raise ValueError(f"flax variables lack {path}")
        used.add(path)
        return flat[path]

    def put(param: torch.Tensor, value: np.ndarray, path: str) -> None:
        value = np.ascontiguousarray(value)
        if tuple(param.shape) != value.shape:
            raise ValueError(f"{path}: flax {value.shape} vs torch {tuple(param.shape)}")
        param.copy_(torch.from_numpy(value.astype(np.float32)).to(param.dtype))
        filled.add(id(param))

    for name, mod in model.named_modules():
        p = _flax_path(name)
        if isinstance(mod, nn.Linear):
            put(mod.weight, take(f"{p}/kernel").T, f"{p}/kernel")
            if mod.bias is not None:
                put(mod.bias, take(f"{p}/bias"), f"{p}/bias")
        elif isinstance(mod, LayerNorm):
            put(mod.weight, take(f"{p}/scale"), f"{p}/scale")
            put(mod.bias, take(f"{p}/bias"), f"{p}/bias")
        elif isinstance(mod, PatchEmbed):
            put(mod.weight, take(f"{p}/proj/kernel").transpose(3, 2, 0, 1), f"{p}/proj/kernel")
            put(mod.bias, take(f"{p}/proj/bias"), f"{p}/proj/bias")
        elif isinstance(mod, PatchUnembed):
            k = take(f"{p}/final/kernel")[::-1, ::-1]
            put(mod.weight, k.transpose(2, 3, 0, 1), f"{p}/final/kernel")
        elif isinstance(mod, Conv1x1):
            put(mod.weight, take(f"{p}/kernel").transpose(3, 2, 0, 1), f"{p}/kernel")
            put(mod.bias, take(f"{p}/bias"), f"{p}/bias")
        elif isinstance(mod, EntropyBottleneck):
            for pname, param in mod.named_parameters():
                put(param, take(f"{p}/{pname}"), f"{p}/{pname}")
        if isinstance(mod, _PosEmbed):
            put(mod.pos_embed, take(f"{p}/pos_embed"), f"{p}/pos_embed")

    missing = [n for n, prm in model.named_parameters() if id(prm) not in filled]
    unused = sorted(set(flat) - used)
    if missing or unused:
        raise ValueError(f"conversion incomplete: torch params unfilled {missing}, "
                         f"flax leaves unused {unused}")
    return model
