"""Copy the JAX package's variables into the port's modules.

``load_flax_variables(model, variables)`` takes the flax variables as nested
dicts of numpy arrays (``jax.device_get`` output, or a checkpoint read
without JAX) and fills every parameter of the port's model: the
``VAEformer`` and its variants (``models/baseline.py``'s
``VariationCNNPrior`` with its ``_ConvStack`` hyperprior, the former
baseline without quant convs, ``models/vit_vae.py``'s
``VITAutoencoderKL`` with its ``encoder`` / ``decoder``), the image-codec
zoo (``models/google.py``, ``waseda.py``, ``elic2022.py``, ``stf2022.py``
with ``nn/swin.py``, ``tcm2023.py``, ``inv2021.py``) and the latent codecs. Module
names are the flax names, so a torch name is its flax path with dots for
slashes:

  - Dense ``kernel`` (in, out) -> ``nn.Linear.weight`` (out, in);
  - conv ``kernel`` in HWIO -> Conv2d layout (out, in, kh, kw): the patch
    embeds, the 1x1 quant convs, every ``nn.Conv2d`` (``conv2d``'s) and
    the masked convs' raw kernels (the mask is applied at call time on
    both sides);
  - every ConvTranspose ``kernel`` (kh, kw, in, out) -> ConvTranspose2d
    layout (in, out, kh, kw), spatially flipped, because flax applies its
    ConvTranspose kernel flipped: ``g_s/final/final`` of the VAEformer and
    each ``deconv2d`` (``.../l{i}/conv`` in a ``_ConvStack``);
  - LayerNorm ``scale``/``bias``, ``pos_embed``, GDN's re-parameterised
    ``beta``/``gamma``, the gain vectors, the entropy bottleneck's
    ``matrix{i}``/``bias{i}``/``factor{i}``/``quantiles``, the Swin
    attention's ``relative_position_bias_table`` and the invertible 1x1's
    ``weight`` (an "oc" matrix in an einsum on both sides) as they are.

It is strict: every flax leaf must be consumed and every torch parameter
filled, with matching shapes, or it raises ValueError. ``flax_layout``
is the one table of that correspondence; ``to_flax_params`` is its
inverse (port tensors -> the flax ``params`` tree), which the ``.msgpack``
checkpoints write through.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from .entropy import EntropyBottleneck
from .models.inv2021 import InvertibleConv1x1
from .models.latent_codecs import GainHyperLatentCodec, GainHyperpriorLatentCodec
from .models.vaeformer import Conv1x1
from .nn.blocks import LayerNorm
from .nn.conv import _MaskedConv
from .nn.gdn import GDN
from .nn.patch_embed import PatchEmbed, PatchUnembed
from .nn.swin import SwinWindowAttention
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


# how a port parameter's layout maps to its flax leaf: (to flax, from flax)
_LAYOUTS = {
    "as_is": (lambda a: a, lambda a: a),
    "dense": (lambda a: a.T, lambda a: a.T),  # (out, in) <-> (in, out)
    "conv": (lambda a: a.transpose(2, 3, 1, 0), lambda a: a.transpose(3, 2, 0, 1)),  # OIHW <-> HWIO
    # ConvTranspose2d (in, out, kh, kw) <-> flax's flipped (kh, kw, in, out)
    "conv_t": (lambda a: a.transpose(2, 3, 0, 1)[::-1, ::-1],
               lambda a: a[::-1, ::-1].transpose(2, 3, 0, 1)),
}


def flax_layout(model: nn.Module) -> Dict[str, Tuple[str, str]]:
    """Every parameter of the port's model: port name -> (flax path under
    ``params``, layout name in ``_LAYOUTS``), in the model's order."""
    out: Dict[str, Tuple[str, str]] = {}

    def add(name: str, path: str, layout: str) -> None:
        out[name] = (path.lstrip("/"), layout)  # the root module's own leaves

    for name, mod in model.named_modules():
        p, pre = _flax_path(name), f"{name}." if name else ""
        if isinstance(mod, nn.Linear):
            add(f"{pre}weight", f"{p}/kernel", "dense")
            if mod.bias is not None:
                add(f"{pre}bias", f"{p}/bias", "as_is")
        elif isinstance(mod, LayerNorm):
            add(f"{pre}weight", f"{p}/scale", "as_is")
            add(f"{pre}bias", f"{p}/bias", "as_is")
        elif isinstance(mod, PatchEmbed):
            add(f"{pre}weight", f"{p}/proj/kernel", "conv")
            add(f"{pre}bias", f"{p}/proj/bias", "as_is")
        elif isinstance(mod, PatchUnembed):
            add(f"{pre}weight", f"{p}/final/kernel", "conv_t")
        elif isinstance(mod, (Conv1x1, nn.Conv2d, _MaskedConv, nn.ConvTranspose2d)):
            kind = "conv_t" if isinstance(mod, nn.ConvTranspose2d) else "conv"
            add(f"{pre}weight", f"{p}/kernel", kind)
            add(f"{pre}bias", f"{p}/bias", "as_is")
        elif isinstance(mod, (EntropyBottleneck, GDN, GainHyperLatentCodec,
                              GainHyperpriorLatentCodec, SwinWindowAttention,
                              InvertibleConv1x1)):
            for pname, _ in mod.named_parameters(recurse=False):
                add(f"{pre}{pname}", f"{p}/{pname}", "as_is")
        if isinstance(mod, _PosEmbed):
            add(f"{pre}pos_embed", f"{p}/pos_embed", "as_is")
    return out


def to_flax_leaf(layout: str, value) -> np.ndarray:
    """A port tensor (or array) in its flax leaf's layout, float32."""
    if isinstance(value, torch.Tensor):
        value = value.detach().float().cpu().numpy()
    return np.ascontiguousarray(_LAYOUTS[layout][0](np.asarray(value, np.float32)))


def from_flax_leaf(layout: str, value) -> np.ndarray:
    return np.ascontiguousarray(_LAYOUTS[layout][1](np.asarray(value)))


def to_flax_params(model: nn.Module, tensors: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The flax ``params`` tree (nested dicts, keys sorted at every level,
    as ``jax.tree.map`` leaves them) of port tensors named as the model's
    parameters (the parameters themselves, Adam moments or an EMA)."""
    layout = flax_layout(model)
    if set(tensors) != set(layout):
        raise ValueError(f"tensor names differ from the model's parameters: "
                         f"{sorted(set(tensors) ^ set(layout))[:5]}")
    tree: Dict[str, Any] = {}
    for name, (path, kind) in layout.items():
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = to_flax_leaf(kind, tensors[name])
    return _sorted(tree)


def _sorted(tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _sorted(v) if isinstance(v, dict) else v for k, v in sorted(tree.items())}


def from_flax_params(model: nn.Module, variables: dict) -> Dict[str, np.ndarray]:
    """Port name -> array in the port's layout, for every parameter of the
    model, from a flax ``params`` tree (or a variables dict holding one).
    Strict: every flax leaf is consumed and every parameter found, with
    matching shapes, or it raises ValueError."""
    flat = _flatten(variables.get("params", variables))
    layout = flax_layout(model)
    params = dict(model.named_parameters())
    out, missing = {}, []
    for name, (path, kind) in layout.items():
        if path not in flat:
            missing.append(path)
            continue
        value = from_flax_leaf(kind, flat[path])
        if tuple(params[name].shape) != value.shape:
            raise ValueError(f"{path}: flax {value.shape} vs torch {tuple(params[name].shape)}")
        out[name] = value
    unfilled = [n for n in params if n not in layout]
    unused = sorted(set(flat) - {path for path, _ in layout.values()})
    if missing or unfilled or unused:
        raise ValueError(f"conversion incomplete: flax variables lack {missing}, torch params "
                         f"unfilled {unfilled}, flax leaves unused {unused}")
    return out


@torch.no_grad()
def load_flax_variables(model: nn.Module, variables: dict) -> nn.Module:
    for name, value in from_flax_params(model, variables).items():
        param = model.get_parameter(name)
        param.copy_(torch.from_numpy(value.astype(np.float32)).to(param.dtype))
    return model
