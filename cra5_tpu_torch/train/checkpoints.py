"""Checkpoints of the port: ``torch.save`` files and pointer files.

Counterpart of ``cra5_tpu/train/checkpoints.py`` in the port's own format:
a params-only file (``{"params": {name: tensor}}``) and a full train-state
file (params, both Adam moments and their count, the EMA shadow and its
count, the step), all on the CPU. The ``last_checkpoint`` / ``last_state``
pointer files hold the newest path. Reading the JAX package's flax
msgpack checkpoints is not ported (ROADMAP.md queue A).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch


def _cpu(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in tree.items()}


def save_variables(path: str, params: Dict[str, torch.Tensor]) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"params": _cpu(params)}, path)
    return path


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


def save_train_state(path: str, state: Any) -> str:
    """The full train state, so a resumed run continues exactly where the
    saved one stopped."""
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
def load_train_state(path: str, template: Any) -> Any:
    """Copy a saved state into ``template`` (a fresh ``Trainer.init_state``)
    in place: every tensor keeps its device and dtype, and the model's
    parameters, which the template's params are, take the saved values.
    Names and shapes must match."""
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
