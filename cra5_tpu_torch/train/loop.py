"""The training loop: one step of loss, backward, net/aux Adam and EMA,
with checkpointed resume, on one device or data-parallel over ranks.

Counterpart of ``cra5_tpu/train/loop.py``. ``make_train_step`` returns
``train_step(state, batch, rng) -> (state, metrics)``; ``Trainer`` wraps
it with init, logging and checkpoints. Differences from the JAX package,
each forced by the framework:

  - ``TrainState.params`` are the model's own parameters, and a step
    updates them, the Adam moments and the EMA in place (the JAX step
    returns new trees);
  - the step's noise comes from a ``torch.Generator`` seeded from
    ``(rng, step)`` (``step_generator``, the counterpart of
    ``jax.random.fold_in(rng, step)``), so a resumed run repeats an
    uninterrupted one exactly;
  - under a mesh with a dp axis of several ranks (``parallel/``), each
    rank computes the loss of its local batch; the gradients are averaged
    over dp (an all-reduce) before the net clip, so the clip sees the
    global gradient, and the metrics are averaged too. Each rank draws the
    global batch's noise from ``step_generator(rng, step)`` and keeps its
    own rows (``entropy.ops.BatchRows``), so the dp step is the
    single-device step at the global batch. Rank 0's initial parameters
    are broadcast, only rank 0 writes checkpoints, and a barrier follows;
  - under a mesh with a tp axis of several ranks (alone or with dp), the
    model is placed on it at ``init_state`` (``parallel.parallelize_``:
    rank 0's seeded init broadcast, each rank keeping its shards of the
    attention and MLP weights), the ranks of a tp group see the same batch
    and draw the same noise (the rows are keyed by the dp rank), the
    gradients are averaged over dp only, the clip's norm sums the shards
    over tp (``optim.py``), Adam and the EMA run on the shards, and the
    checkpoints hold full tensors in the fused layout: ``save`` gathers
    them and ``restore`` cuts them again (``checkpoints.full_state`` /
    ``shard_state_``), so a tp run's files load into a one-process run and
    into the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from .checkpoints import (
    full_state,
    load_train_state,
    resolve_last_checkpoint,
    save_train_state,
    save_variables,
    shard_state_,
    write_last_checkpoint,
)
from ..entropy.ops import BatchRows
from ..parallel.distributed import (
    all_reduce_mean_,
    barrier,
    is_primary,
    make_global_batch,
    process_count,
    put_tree,
)
from ..parallel.mesh import axis_group, axis_size
from ..parallel.tensor_parallel import parallelize_, placement_of
from ..utils.profiling import span
from .ema import EmaState, ema_init, ema_update_
from .loss import RateDistortionLoss, kl_weighted_loss
from .optim import NetAuxAdam, OptState, make_net_aux_optimizers

_SUFFIX = ".pt"


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.nn.Parameter]  # the model's own parameters, by name
    opt_state: OptState
    ema: Optional[EmaState] = None


@dataclasses.dataclass
class TrainerConfig:
    learning_rate: float = 1e-4
    aux_learning_rate: float = 1e-3
    lmbda: float = 0.01
    bpp_weight: float = 0.01
    kl_weight: float = 1e-6
    use_kl: bool = False
    use_ema: bool = True
    ema_decay: float = 0.9999
    max_grad_norm: float = 1.0
    log_every: int = 50
    ckpt_every: int = 1000
    ckpt_dir: str = "checkpoints"
    # keep only the newest N step_/state_ checkpoints (0 = keep all)
    ckpt_keep: int = 0
    # schedule config dict for the net rate, e.g.
    # dict(type="WarmupCosineLR", warmup_steps=1000, min_lr_ratio=0.1);
    # None = constant learning_rate
    scheduler: Optional[Dict[str, Any]] = None
    total_steps: Optional[int] = None


def step_generator(rng: int, step: int, device) -> torch.Generator:
    """The generator of one step's noise, a function of (rng, step) only."""
    seed = int(np.random.SeedSequence([int(rng), int(step)]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed >> 1)


def make_train_step(model: torch.nn.Module, tx: NetAuxAdam, cfg: TrainerConfig,
                    dp_group=None) -> Callable:
    """``train_step(state, batch, rng) -> (state, metrics)``. With a
    ``dp_group`` of several ranks, ``batch`` is this rank's rows of the
    global batch (the ranks' local batches are equal in size, in rank
    order), and ``train_step.timing["allreduce_s"]`` holds the last step's
    seconds in the gradient all-reduce. A model placed on a tp axis
    (``model.tp``) clips by the norm of the whole tree. The phases are
    spans (``utils/profiling.py``): ``train/forward``, ``train/backward``,
    ``train/optimizer`` and ``train/ema``."""
    import torch.distributed as dist

    rd = RateDistortionLoss(lmbda=cfg.lmbda, bpp_weight=cfg.bpp_weight)
    world = dist.get_world_size(dp_group) if dp_group is not None else 1
    rank = dist.get_rank(dp_group) if dp_group is not None else 0
    timing = {"allreduce_s": 0.0}  # not an attribute set inside: no cycle keeps the model

    def loss_fn(batch: torch.Tensor, generator: torch.Generator):
        out = model(batch, training=True, generator=generator)
        losses = rd(out, batch)
        aux = model.aux_loss()
        total = losses["loss"] + aux
        metrics = {**losses, "aux_loss": aux}
        if cfg.use_kl:
            klo = kl_weighted_loss(out, batch, kl_weight=cfg.kl_weight)
            total = total + klo["vae_loss"]
            metrics.update(klo)
        metrics["total_loss"] = total
        return total, metrics

    def train_step(state: TrainState, batch: torch.Tensor, rng: int):
        if hasattr(batch, "to_local"):  # a global batch: this rank's rows
            batch = batch.to_local()
        generator = step_generator(rng, state.step, batch.device)
        if world > 1:
            b = batch.shape[0]
            generator = BatchRows(generator, rank * b, (rank + 1) * b, world * b)
        for p in state.params.values():
            p.grad = None
        with span("train/forward"):
            total, metrics = loss_fn(batch, generator)
        with span("train/backward"):  # rematerialised blocks rerun in train/recompute
            total.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in state.params.items()}
        if world > 1:
            if batch.device.type == "cuda":
                torch.cuda.synchronize(batch.device)
            t0 = time.perf_counter()
            all_reduce_mean_(list(grads.values()), dp_group)
            if batch.device.type == "cuda":
                torch.cuda.synchronize(batch.device)
            timing["allreduce_s"] = time.perf_counter() - t0
            names = list(metrics)
            stacked = torch.stack([metrics[k].detach().float() for k in names])
            all_reduce_mean_([stacked], dp_group)
            metrics = dict(zip(names, stacked.unbind()))
        tp = getattr(model, "tp", None)
        split = [k for k, v in placement_of(model).items() if v is not None]
        with span("train/optimizer"):  # the net clip, net and aux Adam
            tx.update_(state.params, grads, state.opt_state, split=split,
                       tp_group=tp.group if tp is not None else None)
        for p in state.params.values():
            p.grad = None
        if state.ema is not None:
            with span("train/ema"):
                ema_update_(state.ema, state.params, cfg.ema_decay)
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    train_step.timing = timing
    return train_step


class Trainer:
    """Init or resume, the step, logging and checkpoints."""

    def __init__(self, model: torch.nn.Module, cfg: TrainerConfig = TrainerConfig(),
                 mesh=None, seed: int = 0):
        """``mesh``: a ``DeviceMesh`` (``parallel.make_mesh``) whose dp axis
        the step averages its gradients over and whose tp axis the model is
        placed on; None trains on one device."""
        self.model, self.cfg, self.seed, self.mesh = model, cfg, seed, mesh
        self.tp_size = axis_size(mesh, "tp")
        self.dp_group = axis_group(mesh, "dp")[0]
        self.tx = make_net_aux_optimizers(
            cfg.learning_rate, cfg.aux_learning_rate, cfg.max_grad_norm,
            scheduler=cfg.scheduler, total_steps=cfg.total_steps,
        )
        self._step_fn = make_train_step(model, self.tx, cfg, dp_group=self.dp_group)

    def init_state(self, example_batch: torch.Tensor) -> TrainState:
        """Seeded init of the model's parameters (rank 0's on every rank,
        placed on the mesh's tp axis), zero moments, the EMA. A model
        placed already draws its shards of the same init (``Dense.init_``
        draws the full weight), and only its replicated parameters are
        broadcast."""
        if process_count() > 1 and self.mesh is None:
            raise ValueError(
                "multi-process training requires a mesh: pass one to Trainer(..., mesh=...) "
                "(e.g. parallel.make_mesh({'dp': -1})) so the ranks know what to average over")
        self.model.reset_parameters(self.seed)
        if self.tp_size > 1 and getattr(self.model, "tp", None) is None:
            parallelize_(self.model, self.mesh)
        elif process_count() > 1:
            split = placement_of(self.model)
            put_tree(self.mesh, {k: p.data for k, p in self.model.named_parameters()
                                 if split.get(k) is None})
        params = dict(self.model.named_parameters())
        ema = ema_init(params) if self.cfg.use_ema else None
        return TrainState(step=0, params=params, opt_state=self.tx.init(params), ema=ema)

    def shard_batch(self, batch) -> torch.Tensor:
        """Place a batch for the step on the model's device. Multi-process
        with a dp axis: ``batch`` is this rank's local rows and the result
        is the global batch (local x dp) over the mesh's dp axis."""
        if self.dp_group is not None and process_count() > 1:
            return make_global_batch(self.mesh, torch.as_tensor(batch).to(self.model.device))
        return torch.as_tensor(batch, device=self.model.device)

    def fit(self, data: Iterable, state: Optional[TrainState] = None,
            num_steps: Optional[int] = None,
            log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None) -> TrainState:
        rng = self.seed + 1
        it = iter(data)
        if state is None:
            first = next(it)
            state = self.init_state(self.shard_batch(first))
            data_iter = _chain_first(first, it)
        else:
            data_iter = it
        step0 = state.step
        last_log_step = step0
        t0 = time.time()
        for i, batch in enumerate(data_iter):
            if num_steps is not None and i >= num_steps:
                break
            state, metrics = self._step_fn(state, self.shard_batch(batch), rng)
            step = step0 + i + 1
            if step % self.cfg.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m["steps_per_sec"] = (step - last_log_step) / max(time.time() - t0, 1e-9)
                last_log_step = step
                t0 = time.time()
                if log_fn is not None:
                    log_fn(step, m)
                else:
                    print(f"step {step}: " + " ".join(f"{k}={v:.4g}" for k, v in m.items()))
            if step % self.cfg.ckpt_every == 0:
                self.save(state)
        return state

    def save(self, state: TrainState) -> str:
        """Write a params-only checkpoint and the full resumable state, and
        point ``last_checkpoint`` / ``last_state`` at them. Every rank calls:
        a tp state is gathered into full tensors first; then only the
        primary rank writes (every dp replica holds the same state), and a
        barrier follows."""
        d = self.cfg.ckpt_dir
        path = os.path.join(d, f"step_{state.step}{_SUFFIX}")
        state_path = os.path.join(d, f"state_{state.step}{_SUFFIX}")
        placement = placement_of(self.model)
        if placement:
            state = full_state(state, self.mesh, placement)
        if is_primary():
            save_variables(path, state.params, model=self.model)
            write_last_checkpoint(d, path)
            save_train_state(state_path, state, model=self.model, scheduled=self._scheduled)
            write_last_checkpoint(d, state_path, "last_state")
            if self.cfg.ckpt_keep > 0:
                self._prune_checkpoints()
        barrier("ckpt_save")
        return path

    @property
    def _scheduled(self) -> bool:
        return callable(self.tx.net_lr)

    def _prune_checkpoints(self) -> None:
        # never delete what the pointer files reference: a reused dir with
        # stale higher-step checkpoints would otherwise out-sort (and so
        # delete) the one just written
        d = self.cfg.ckpt_dir
        protected = set()
        for pointer in ("last_checkpoint", "last_state"):
            p = os.path.join(d, pointer)
            if os.path.exists(p):
                with open(p) as f:
                    protected.add(os.path.basename(f.read().strip()))
        for prefix in ("step_", "state_"):
            files = sorted(
                (f for f in os.listdir(d)
                 if f.startswith(prefix) and f.endswith(_SUFFIX)
                 and f[len(prefix):-len(_SUFFIX)].isdigit()),
                key=lambda f: int(f[len(prefix):-len(_SUFFIX)]),
            )
            for old in files[: -self.cfg.ckpt_keep]:
                if old not in protected:
                    os.remove(os.path.join(d, old))

    def restore(self, example_batch: torch.Tensor, path: Optional[str] = None) -> TrainState:
        """Resume from a full train-state checkpoint (default: the
        ``last_state`` pointer under ``cfg.ckpt_dir``); a ``.msgpack`` path
        is the JAX package's train state. Under tp the full tensors are cut
        to this rank's shards."""
        if path is None:
            path = resolve_last_checkpoint(self.cfg.ckpt_dir, "last_state")
        template = self.init_state(self.shard_batch(example_batch))
        placement = placement_of(self.model)
        if not placement:
            return load_train_state(path, template, model=self.model, scheduled=self._scheduled)
        full = load_train_state(path, full_state(template, self.mesh, placement),
                                model=self.model, scheduled=self._scheduled)
        return shard_state_(template, full, self.mesh, placement)


def _chain_first(first, rest):
    yield first
    yield from rest
