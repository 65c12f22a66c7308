"""The reference CRA5 ``.pth`` state dict into the port's parameters, with
the trained CDF tables that ride in it.

Counterpart of ``cra5_tpu/tools/convert_torch.py``, step for step. The key
surgery is the reference's own:
  - ``module.`` (DataParallel) and ``model.`` prefixes are dropped,
    ``downsample`` becomes ``skip``, and the EntropyBottleneck's
    ParameterList forms ``_biases.N`` / ``_matrices.N`` / ``_factors.N``
    become ``_biasN`` / ``_matrixN`` / ``_factorN``;
  - the towers g_a, g_s, h_a, h_s: ``patch_embed.proj``, ``pos_embed``,
    ``blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}``,
    ``quan_mlp`` / ``post_quan_mlp``, ``norm``, ``final`` (the decoders'
    blocks are numbered from 0 in the published checkpoint);
  - the 1x1 ``quant_conv`` / ``post_quant_conv``, the EntropyBottleneck's
    ``_matrixN`` / ``_biasN`` / ``_factorN`` / ``quantiles``;
  - the CDF buffers ``entropy_bottleneck._quantized_cdf`` / ``_cdf_length``
    / ``_offset``, the same of ``gaussian_conditional`` and its
    ``scale_table`` (``extract_cdf_tables``).

``convert_vaeformer_state_dict`` gives the JAX package's flax tree, the
one ``main`` writes; ``convert_checkpoint`` maps that tree onto a port
model through ``convert.from_flax_params``, which holds every layout (the
exact-721 ConvTranspose ``g_s.final`` among them) and checks every name and
shape. The layouts are torch's on both ends, so every value arrives
unchanged, bit for bit. The converter is one-way.

``verify_268_manifest`` checks a state dict's names and shapes against
the published 268v model's (``assets/cra5_268v_state_manifest.json``, a
byte-for-byte copy of the JAX package's); ``main`` refuses a mismatch
unless ``--no-verify`` is given.

Usage:
  python -m cra5_tpu_torch.tools.convert_torch cra5_268v_300k.pth -o out.msgpack

``out.msgpack`` is ``{"variables": {"params": <flax tree>}, "cdf": {...}}``
in flax's bytes (``utils/msgpack.py``), read alike by the JAX package's
``flax.serialization.msgpack_restore`` and the port's ``msgpack.loads``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..entropy.cdf import CdfTable

MANIFEST = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                        "cra5_268v_state_manifest.json")


def _to_numpy(t) -> np.ndarray:
    try:
        return t.detach().cpu().numpy()
    except AttributeError:
        return np.asarray(t)


def rename_key(key: str) -> str:
    """The reference's key surgery: prefixes, ``downsample``, ParameterLists."""
    if key.startswith("module."):
        key = key[7:]
    if key.startswith("model."):
        key = key[6:]
    if ".downsample." in key:
        key = key.replace("downsample", "skip")
    m = re.match(r"^(.*entropy_bottleneck\._)(biases|matrices|factors)\.(\d+)$", key)
    if m:
        singular = {"biases": "bias", "matrices": "matrix", "factors": "factor"}[m.group(2)]
        key = f"{m.group(1)}{singular}{m.group(3)}"
    return key


def _set(tree: Dict[str, Any], path, value: np.ndarray) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _kernel_or_bias(kind: str, v: np.ndarray) -> Tuple[str, np.ndarray]:
    """A Linear's (out, in) weight as flax's (in, out) kernel, or its bias."""
    return ("kernel", v.T) if kind == "weight" else ("bias", v)


def convert_vit_tower(sd: Dict[str, np.ndarray], prefix: str,
                      n_blocks_offset: int = 0) -> Dict[str, Any]:
    """One ViT tower (g_a, g_s, h_a, h_s) of a renamed state dict as a flax
    params subtree: the encoders' patch_embed, pos_embed, blocks and
    quan_mlp, the decoders' post_quan_mlp, blocks, norm and final.
    Reference block i becomes ``blocks_{i - n_blocks_offset}``."""
    tree: Dict[str, Any] = {}
    for k in [k for k in sd if k.startswith(prefix + ".")]:
        sub, v = k[len(prefix) + 1:], sd[k]
        if sub == "pos_embed":
            _set(tree, ("pos_embed",), v)
        elif sub == "patch_embed.proj.weight":
            _set(tree, ("patch_embed", "proj", "kernel"), v.transpose(2, 3, 1, 0))
        elif sub == "patch_embed.proj.bias":
            _set(tree, ("patch_embed", "proj", "bias"), v)
        elif sub in ("norm.weight", "norm.bias"):
            _set(tree, ("norm", "scale" if sub.endswith("weight") else "bias"), v)
        elif sub == "final.weight":
            if v.ndim == 4:  # ConvTranspose2d (in, out, kh, kw), flax applies it flipped
                _set(tree, ("final", "final", "kernel"),
                     v.transpose(2, 3, 0, 1)[::-1, ::-1].copy())
            else:
                _set(tree, ("final", "kernel"), v.T)
        elif sub == "final.bias":
            conv_t = sd[prefix + ".final.weight"].ndim == 4
            _set(tree, ("final", "final", "bias") if conv_t else ("final", "bias"), v)
        elif sub.startswith(("quan_mlp.", "post_quan_mlp.")):
            mlp_name, layer, kind = sub.split(".")
            name, value = _kernel_or_bias(kind, v)
            _set(tree, (mlp_name, layer, name), value)
        else:
            m = re.match(r"^blocks\.(\d+)\.(.+)$", sub)
            if not m:
                continue  # buffers and aux entries are the caller's
            bpath = (f"blocks_{int(m.group(1)) - n_blocks_offset}",)
            rest = m.group(2)
            if rest in ("norm1.weight", "norm1.bias", "norm2.weight", "norm2.bias"):
                ln, kind = rest.split(".")
                _set(tree, bpath + (ln, "scale" if kind == "weight" else "bias"), v)
            elif rest.startswith(("attn.", "mlp.")):
                mod, layer, kind = rest.split(".")
                name, value = _kernel_or_bias(kind, v)
                _set(tree, bpath + (mod, layer, name), value)
    return tree


def convert_entropy_bottleneck(sd: Dict[str, np.ndarray],
                               prefix: str = "entropy_bottleneck") -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for k in sd:
        if not k.startswith(prefix + "."):
            continue
        sub = k[len(prefix) + 1:]
        m = re.match(r"^_(matrix|bias|factor)(\d+)$", sub)
        if m:
            tree[f"{m.group(1)}{m.group(2)}"] = sd[k]
        elif sub == "quantiles":
            tree["quantiles"] = sd[k]
    return tree


def extract_cdf_tables(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """The trained CDF buffers as ``{"eb": CdfTable, "gc": CdfTable,
    "scale_table": float32 array}``; empty buffers are left out."""
    tables: Dict[str, Any] = {}
    for name, prefix in (("eb", "entropy_bottleneck"), ("gc", "gaussian_conditional")):
        q = sd.get(f"{prefix}._quantized_cdf")
        if q is not None and np.asarray(q).size:
            tables[name] = CdfTable(
                quantized_cdf=np.asarray(q, np.int32),
                cdf_length=np.asarray(sd[f"{prefix}._cdf_length"], np.int32),
                offset=np.asarray(sd[f"{prefix}._offset"], np.int32),
            )
    st = sd.get("gaussian_conditional.scale_table")
    if st is not None and np.asarray(st).size:
        tables["scale_table"] = np.asarray(st, np.float32)
    return tables


def convert_conv1x1(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, Any]:
    out = {"kernel": sd[prefix + ".weight"].transpose(2, 3, 1, 0)}  # (O, I, 1, 1) -> HWIO
    if prefix + ".bias" in sd:
        out["bias"] = sd[prefix + ".bias"]
    return out


def convert_vaeformer_state_dict(raw_sd: Dict[str, Any],
                                 depth: int) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A reference state dict as ({"params": <flax tree>}, cdf tables), the
    JAX package's conversion. ``depth`` is the ViT depth (24 for 268v)."""
    sd = {rename_key(k): _to_numpy(v) for k, v in raw_sd.items()}
    params: Dict[str, Any] = {}
    for tower in ("g_a", "g_s", "h_a", "h_s"):
        params[tower] = convert_vit_tower(sd, tower)
    for conv in ("quant_conv", "post_quant_conv"):
        if conv + ".weight" in sd:
            params[conv] = convert_conv1x1(sd, conv)
    params["entropy_bottleneck"] = convert_entropy_bottleneck(sd)
    return {"params": params}, extract_cdf_tables(sd)


def verify_268_manifest(sd, manifest_path: Optional[str] = None) -> dict:
    """Names and shapes of a state dict against the published 268v
    model's: {"missing", "extra", "shape_mismatch"}, all empty when it
    converts cleanly. Both sides pass through ``rename_key``, so every
    form the converter takes passes; entries without a shape (epoch
    counters, config dicts) show up as missing or extra."""
    with open(manifest_path or MANIFEST) as f:
        manifest = json.load(f)
    want = {rename_key(k): tuple(v) for k, v in manifest["keys"].items()}
    have = {rename_key(k): tuple(v.shape) for k, v in sd.items() if hasattr(v, "shape")}
    return {
        "missing": sorted(set(want) - set(have)),
        "extra": sorted(set(have) - set(want)),
        "shape_mismatch": sorted(k for k in set(want) & set(have) if want[k] != have[k]),
    }


def _load_state_dict(path: str):
    import torch

    # the published checkpoints may hold non-tensor entries (epochs, configs)
    raw = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "model", "net"):
        if isinstance(raw, dict) and key in raw and isinstance(raw[key], dict):
            raw = raw[key]
            break
    return raw


def convert_checkpoint(path: str, depth: int = 24, state_dict=None, *, model) -> Dict[str, Any]:
    """A reference ``.pth`` (or its already loaded ``state_dict``) as the
    port's parameters of ``model`` by name, float32 CPU tensors, plus
    ``"_cdf_tables"`` (``extract_cdf_tables``; ``train.checkpoints``
    routes ``.pth`` files here)."""
    import torch

    from ..convert import from_flax_params

    raw = _load_state_dict(path) if state_dict is None else state_dict
    variables, tables = convert_vaeformer_state_dict(raw, depth)
    out: Dict[str, Any] = {name: torch.from_numpy(np.array(v, np.float32))
                           for name, v in from_flax_params(model, variables).items()}
    out["_cdf_tables"] = tables
    return out


def cdf_payload(tables: Dict[str, Any]) -> Dict[str, Any]:
    """CDF tables as the ``"cdf"`` entry of a checkpoint payload."""
    return {k: ({"quantized_cdf": t.quantized_cdf, "cdf_length": t.cdf_length,
                 "offset": t.offset} if isinstance(t, CdfTable) else t)
            for k, t in tables.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("checkpoint", type=str)
    parser.add_argument("-o", "--output", type=str, required=True)
    parser.add_argument("--depth", type=int, default=24)
    parser.add_argument("--no-verify", action="store_true",
                        help="skip the 268v state-manifest check (non-268 checkpoints)")
    args = parser.parse_args(argv)

    raw = _load_state_dict(args.checkpoint)
    if not args.no_verify and args.depth == 24:
        report = verify_268_manifest(raw)
        if any(report.values()):
            print("manifest mismatch vs the published 268v structure "
                  f"(pass --no-verify to force): {report}", file=sys.stderr)
            return 1
        print(f"manifest OK: {len(raw)} keys match the committed 268v "
              "full-geometry fingerprint", file=sys.stderr)

    from ..convert import _sorted  # keys sorted at every level, as flax writes them
    from ..utils import msgpack

    variables, tables = convert_vaeformer_state_dict(raw, args.depth)
    payload = {"variables": variables}
    if tables:
        payload["cdf"] = cdf_payload(tables)
    with open(args.output, "wb") as f:
        f.write(msgpack.dumps(_sorted(payload)))
    print(args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
