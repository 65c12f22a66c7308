"""Config-driven training CLI, on one device or data-parallel over ranks.

Counterpart of ``cra5_tpu/tools/train.py``: a Python-file config
(``utils/config.py``: ``_base_`` inheritance, ``{{$ENV:default}}``
substitution) selects the model, the dataset, the trainer settings and the
mesh; training runs through ``train.loop.Trainer`` (EMA, checkpoints in the
port's own ``torch.save`` format).

Usage:
  python -m cra5_tpu_torch.tools.train CONFIG.py [--steps N] [--ckpt-dir DIR]
      [--resume PATH] [--seed S] [--device cuda|cpu]

Config keys (all optional except model):
  model      = dict(type="VAEformer", cfg="tiny" | "268" | "159")
  dataset    = dict(type="ERA5NpyDataset", ..., batch_size=...) |
               dict(type="synthetic", shape=(B, C, H, W))
  trainer    = dict(learning_rate=..., lmbda=..., use_ema=..., ...)
  mesh       = dict(dp=-1) | dict(dp=2, tp=2) | dict(tp=-1)
  steps      = the run's whole step budget (the schedule's horizon)

It runs on the card unless ``--device cpu``. Under torchrun (or
``CRA5_TPU_COORDINATOR`` / ``CRA5_TPU_NUM_PROCESSES`` /
``CRA5_TPU_PROCESS_ID``) it joins the world first
(``parallel.init_distributed``), one device a rank:

  torchrun --nproc-per-node N -m cra5_tpu_torch.tools.train CONFIG.py ...

A mesh is resolved over the world's ranks as the JAX package resolves it
over its devices (-1: the axis takes what the others leave), and a mesh
of more devices than the world raises the JAX package's ValueError. A dp
axis of several ranks trains data-parallel (each dp rank reads its own
batches, seeded by seed + its dp index), a tp axis of several ranks
splits the attention and MLP weights over them (the ranks of a tp group
read the same batches; ``train/loop.py``), and a mesh of one device is
the one-device trainer. ``--resume`` takes a directory with a ``last_state`` pointer, a
``state_*`` file (parameters, moments, EMA and step) or a ``step_*``
parameters file (optimizer and EMA start fresh), each ``.pt`` or the JAX
package's ``.msgpack``.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
from typing import Callable, Dict, Optional

import numpy as np
import torch


def build_model(model_cfg, device=None):
    from ..models.vaeformer import VAEformer, vaeformer_159, vaeformer_268, vaeformer_tiny
    from ..registry import MODELS

    cfg = dict(model_cfg)
    kind = cfg.pop("type")
    if isinstance(cfg.get("dtype"), str):
        cfg["dtype"] = getattr(torch, cfg["dtype"])
    if kind == "VAEformer":
        named = {"tiny": vaeformer_tiny, "268": vaeformer_268, "159": vaeformer_159}
        vcfg = cfg.pop("cfg", "tiny")
        vcfg = named[vcfg]() if isinstance(vcfg, str) else vcfg
        return VAEformer(vcfg, device=device, **cfg)
    return MODELS.build({"type": kind, **cfg}, device=device)


def build_data(data_cfg, seed: int = 0, device=None):
    """An iterator of batches: a synthetic N(0, 0.5^2) stream, or a registered
    dataset through ``batch_iterator`` and a ``PrefetchLoader`` that moves
    each batch to ``device`` (default: the card) ahead of the step."""
    from ..data import PrefetchLoader, batch_iterator, device_put
    from ..registry import DATASETS

    cfg = dict(data_cfg or {"type": "synthetic"})
    kind = cfg.pop("type")
    batch_size = cfg.pop("batch_size", 2)
    epochs = cfg.pop("epochs", None)
    if kind == "synthetic":
        shape = tuple(cfg.get("shape", (batch_size, 8, 41, 40)))
        rng = np.random.default_rng(seed)

        def gen():
            while True:
                yield rng.normal(size=shape).astype(np.float32) * 0.5

        return gen()
    ds = DATASETS.build({"type": kind, **cfg})
    return PrefetchLoader(batch_iterator(ds, batch_size, shuffle=True, seed=seed, epochs=epochs),
                          to_device=device_put(device))


def mesh_devices(axes: Dict[str, int], visible: int) -> int:
    """The devices a mesh of ``axes`` takes out of ``visible``, resolved as
    ``cra5_tpu/parallel/mesh.py::make_mesh`` resolves it."""
    from ..parallel.mesh import mesh_axes

    return int(np.prod(list(mesh_axes(axes, visible).values())))


def run(argv=None, log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None):
    """The CLI's work: returns (trainer, final state, params checkpoint
    path)."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("config", type=str)
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--ckpt-dir", type=str, default=None)
    parser.add_argument("--resume", type=str, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu; the card unless asked")
    args = parser.parse_args(argv)

    from ..device import resolve_device
    from ..parallel import init_distributed, make_mesh, process_count, shard_variables
    from ..parallel.mesh import axis_group
    from ..parallel.tensor_parallel import placement_of
    from ..train import Trainer, TrainerConfig
    from ..train.checkpoints import load_variables, resolve_last_checkpoint
    from ..utils.config import Config

    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    init_distributed(device=device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = None
    if "mesh" in cfg:
        axes = dict(cfg["mesh"])
        if mesh_devices(axes, process_count()) > 1:
            mesh = make_mesh(axes, device_type=device.type)
    model = build_model(cfg["model"], device=device)
    trainer_cfg = dict(cfg.get("trainer", {}))
    if trainer_cfg.get("scheduler") is not None:
        trainer_cfg["scheduler"] = dict(trainer_cfg["scheduler"])
    tc = TrainerConfig(**trainer_cfg)
    # the schedule's horizon is the run's whole budget (the config's
    # `steps`), never this invocation's --steps: a resumed run passes the
    # remaining count and keeps decaying on the first run's horizon
    if tc.total_steps is None:
        cfg_steps = cfg.get("steps")
        tc.total_steps = cfg_steps if cfg_steps is not None else args.steps
    if args.ckpt_dir:
        tc.ckpt_dir = args.ckpt_dir

    trainer = Trainer(model, tc, mesh=mesh, seed=args.seed)
    # the ranks of a tp group train on the same batches
    data = build_data(cfg.get("dataset"), seed=args.seed + axis_group(mesh, "dp")[2],
                      device=device)

    state = None
    if args.resume:
        # peek one batch from the one live iterator and chain it back: a
        # second iter(data) would start a second producer on the same
        # generator and drop the peeked batch
        it = iter(data)
        first = next(it)
        data = itertools.chain([first], it)
        resume = args.resume
        if os.path.isdir(resume) and os.path.exists(os.path.join(resume, "last_state")):
            state = trainer.restore(first, path=resolve_last_checkpoint(resume, "last_state"))
        elif os.path.basename(resume).startswith("state_"):
            state = trainer.restore(first, path=resume)
        else:  # parameters only: the optimizer and the EMA start fresh
            params = load_variables(resume, model=model)
            state = trainer.init_state(trainer.shard_batch(first))
            if set(params) != set(state.params):
                raise ValueError(f"{resume}: parameter names differ from the model's")
            params = shard_variables(mesh, params, placement_of(model))
            with torch.no_grad():
                for k, p in state.params.items():
                    p.copy_(params[k])

    steps = args.steps if args.steps is not None else cfg.get("steps", 100)
    state = trainer.fit(data, state=state, num_steps=steps, log_fn=log_fn)
    return trainer, state, trainer.save(state)


def main(argv=None) -> int:
    _, _, path = run(argv)
    print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
