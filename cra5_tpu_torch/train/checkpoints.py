"""Checkpoints of the port: ``torch.save`` files, the JAX package's
``.msgpack`` files, and pointer files.

Counterpart of ``cra5_tpu/train/checkpoints.py``. The port's own format
(any path not ending in ``.msgpack``, ``.pt`` by default) is a params-only
file (``{"params": {name: tensor}}``) and a full train-state file (params,
both Adam moments and their count, the EMA shadow and its count, the
step), all on the CPU. A path ending in ``.msgpack`` is read and written
in the JAX package's single-file format (``utils/msgpack.py``, flax's
bytes), which needs the model to map the port's names and layouts to the
flax tree (``convert.flax_layout``):

  - variables: ``{"params": <flax params tree>}``, keys sorted;
  - a train state: ``{"__n_leaves__": n, "l0": ..., "l<n-1>": ...}``, the
    leaves of the JAX ``TrainState`` in ``jax.tree_util`` order
    (``jax_state_leaves``). Orbax directories are not read.

A path ending in ``.pth`` is a reference checkpoint (the published CRA5
model's state dict), read only: ``load_variables`` converts it through
``tools/convert_torch.py`` (the model gives the names and layouts) and
returns its trained CDF tables beside the params under ``"_cdf_tables"``,
as the JAX package's does. The port's own files are never written there.

The ``last_checkpoint`` / ``last_state`` pointer files hold the newest path.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils import msgpack
from .optim import is_aux

MSGPACK = ".msgpack"
PTH = ".pth"  # a reference checkpoint, read through tools/convert_torch.py


def _cpu(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in tree.items()}


def _need_model(path: str, model) -> Any:
    if model is None:
        raise ValueError(f"{path}: a .msgpack or .pth checkpoint needs the model, to map its "
                         f"names and layouts to the port's parameters")
    return model


def _writable(path: str) -> None:
    if path.endswith(PTH):
        raise ValueError(f"{path}: a .pth path names a reference checkpoint, which the port "
                         f"reads only; save to a .pt or .msgpack path")


def _write(path: str, data: bytes) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def _read(path: str) -> Any:
    with open(path, "rb") as f:
        return msgpack.loads(f.read())


def save_variables(path: str, params: Dict[str, torch.Tensor], model=None) -> str:
    """The params by name; a ``.msgpack`` path gets the JAX package's
    ``{"params": ...}`` file of the model's flax tree."""
    _writable(path)
    if path.endswith(MSGPACK):
        from ..convert import to_flax_params

        _write(path, msgpack.dumps({"params": to_flax_params(_need_model(path, model), params)}))
        return path
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"params": _cpu(params)}, path)
    return path


def load_variables(path: str, model=None) -> Dict[str, Any]:
    """The params of a ``save_variables`` file by port name, on the CPU; a
    ``.msgpack`` file (the JAX package's, or the port's) is mapped through
    the model's layout, strictly. A reference ``.pth`` gives the params
    plus ``"_cdf_tables"``: {"eb", "gc", "scale_table"}, those it holds."""
    if path.endswith(PTH):
        from ..tools.convert_torch import convert_checkpoint

        return convert_checkpoint(path, model=_need_model(path, model))
    if path.endswith(MSGPACK):
        from ..convert import from_flax_params

        arrays = from_flax_params(_need_model(path, model), _read(path))
        return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in arrays.items()}
    return torch.load(path, map_location="cpu", weights_only=True)["params"]


def resolve_last_checkpoint(ckpt_dir: str, pointer_name: str = "last_checkpoint") -> str:
    pointer = os.path.join(ckpt_dir, pointer_name)
    if os.path.exists(pointer):
        with open(pointer) as f:
            return f.read().strip()
    raise ValueError(f"no {pointer_name} pointer under {ckpt_dir}")


def write_last_checkpoint(ckpt_dir: str, path: str, pointer_name: str = "last_checkpoint") -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, pointer_name), "w") as f:
        f.write(path)


def jax_state_leaves(model, use_ema: bool, scheduled: bool) -> List[Tuple[str, Optional[str]]]:
    """The leaves of the JAX package's ``TrainState`` in ``jax.tree_util``
    order, as (kind, port name): the step; the params (flax paths sorted);
    the opt_state, ``optax.multi_transform`` over the labels "aux" then
    "net", each an Adam (count, mu, nu over its own parameters; masked
    leaves give none), the net one behind the clip (no leaves) and followed
    by the schedule's count when the net rate is scheduled; then the EMA's
    params and steps. Derived from the model's names, so it holds for any
    model the layout covers."""
    from ..convert import flax_layout

    layout = flax_layout(model)
    names = sorted(layout, key=lambda n: tuple(layout[n][0].split("/")))
    aux = [n for n in names if is_aux(n)]
    net = [n for n in names if not is_aux(n)]
    leaves: List[Tuple[str, Optional[str]]] = [("step", None)]
    leaves += [("params", n) for n in names]
    for label, group in (("aux", aux), ("net", net)):
        leaves += [("count", label)] + [("mu", n) for n in group] + [("nu", n) for n in group]
    if scheduled:
        leaves.append(("count", "schedule"))
    if use_ema:
        leaves += [("ema", n) for n in names] + [("ema_steps", None)]
    return leaves


def _save_jax_train_state(path: str, state: Any, model, scheduled: bool) -> str:
    from ..convert import flax_layout, to_flax_leaf

    layout = flax_layout(model)
    scalar = lambda v: np.asarray(v, np.int32)
    count = scalar(state.opt_state.count)
    tensors = {"params": state.params, "mu": state.opt_state.mu, "nu": state.opt_state.nu,
               "ema": state.ema.params if state.ema is not None else None}
    leaves = jax_state_leaves(model, state.ema is not None, scheduled)
    payload: Dict[str, Any] = {"__n_leaves__": np.int64(len(leaves))}
    for i, (kind, name) in enumerate(leaves):
        if kind == "step":
            payload[f"l{i}"] = scalar(state.step)
        elif kind == "count":
            payload[f"l{i}"] = count
        elif kind == "ema_steps":
            payload[f"l{i}"] = scalar(state.ema.steps)
        else:
            payload[f"l{i}"] = to_flax_leaf(layout[name][1], tensors[kind][name])
    _write(path, msgpack.dumps(payload))
    return path


@torch.no_grad()
def _load_jax_train_state(path: str, template: Any, model, scheduled: bool) -> Any:
    from ..convert import flax_layout, from_flax_leaf

    layout = flax_layout(model)
    data = _read(path)
    leaves = jax_state_leaves(model, template.ema is not None, scheduled)
    n = int(data["__n_leaves__"])
    if n != len(leaves):
        raise ValueError(f"checkpoint {path} has {n} leaves but the template has {len(leaves)} "
                         f"(model/optimizer/EMA/schedule config mismatch)")
    tensors = {"params": template.params, "mu": template.opt_state.mu,
               "nu": template.opt_state.nu,
               "ema": template.ema.params if template.ema is not None else None}
    counts = []
    for i, (kind, name) in enumerate(leaves):
        value = np.asarray(data[f"l{i}"])
        if kind == "step":
            template.step = int(value)
        elif kind == "count":
            counts.append(int(value))
        elif kind == "ema_steps":
            template.ema.steps = int(value)
        else:
            dst = tensors[kind][name]
            value = from_flax_leaf(layout[name][1], value)
            if value.shape != tuple(dst.shape):
                raise ValueError(f"checkpoint {path} leaf {i} ({kind} {name}): shape "
                                 f"{value.shape} != template {tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(value.astype(np.float32)))
    if len(set(counts)) != 1:
        raise ValueError(f"checkpoint {path}: the optimizer counts differ {counts}; the port "
                         f"keeps one count for net and aux")
    template.opt_state.count = counts[0]
    return template


def save_train_state(path: str, state: Any, model=None, scheduled: bool = False) -> str:
    """The full train state, so a resumed run continues exactly where the
    saved one stopped. A ``.msgpack`` path gets the JAX package's file
    (``scheduled``: whether the net rate follows a schedule, whose count
    the JAX state holds), which its ``load_train_state`` restores with a
    template."""
    _writable(path)
    if path.endswith(MSGPACK):
        return _save_jax_train_state(path, state, _need_model(path, model), scheduled)
    payload = {
        "step": int(state.step),
        "params": _cpu(state.params),
        "opt_state": {"mu": _cpu(state.opt_state.mu), "nu": _cpu(state.opt_state.nu),
                      "count": int(state.opt_state.count)},
        "ema": None if state.ema is None else {"params": _cpu(state.ema.params),
                                               "steps": int(state.ema.steps)},
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(payload, path)
    return path


@torch.no_grad()
def load_train_state(path: str, template: Any, model=None, scheduled: bool = False) -> Any:
    """Copy a saved state into ``template`` (a fresh ``Trainer.init_state``)
    in place: every tensor keeps its device and dtype, and the model's
    parameters, which the template's params are, take the saved values.
    Names and shapes must match. A ``.msgpack`` path is read as the JAX
    package's train state (``save_train_state``)."""
    if path.endswith(MSGPACK):
        return _load_jax_train_state(path, template, _need_model(path, model), scheduled)
    data = torch.load(path, map_location="cpu", weights_only=True)

    def fill(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor], what: str) -> None:
        if set(dst) != set(src):
            raise ValueError(f"checkpoint {path}: {what} names differ from the template's "
                             f"(model/optimizer/EMA config mismatch)")
        for k, t in dst.items():
            if tuple(src[k].shape) != tuple(t.shape):
                raise ValueError(f"checkpoint {path}: {what} {k} has shape "
                                 f"{tuple(src[k].shape)}, the template {tuple(t.shape)}")
            t.copy_(src[k])

    fill(template.params, data["params"], "params")
    fill(template.opt_state.mu, data["opt_state"]["mu"], "first moments")
    fill(template.opt_state.nu, data["opt_state"]["nu"], "second moments")
    template.opt_state.count = data["opt_state"]["count"]
    if (template.ema is None) != (data["ema"] is None):
        raise ValueError(f"checkpoint {path}: EMA presence differs from the template's")
    if template.ema is not None:
        fill(template.ema.params, data["ema"]["params"], "EMA")
        template.ema.steps = data["ema"]["steps"]
    template.step = data["step"]
    return template
