"""The training job: one trainer stepping the port's train step
(``train/loop.py::make_train_step``) back to back on batches drawn from a
pool of seeded timesteps on the device.

Traffic parameters (``traffic/<mix>.json``): ``pool``, the distinct seeded
timesteps; ``warm_steps``, the steps of set-up, which the check follows;
``trace_steps``, the steps the traced run profiles. The configuration's
``train`` block gives the dtype, the remat option, the batch and the
trainer's settings.

Set-up builds one training state and drives it from the seed through its
first ``warm_steps`` steps, through the same call and feed as the window,
reading after step 1 each leaf's gradient as the optimizer took it (from
Adam's first moment) and after the last the change of every parameter and
of its EMA. The window goes on from there with the same state. Once it has
closed and the program is freed, the reference repeats those steps
(``reference/train.py``) and ``judge.train_numbers`` compares.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from reference import train as ref_train

from .. import card, fields, flops, judge, params, peaks, program, trace
from ..harness import Context, Outcome
from ..seeds import rng, sub_seed


def _norms(tensors: dict, base: dict = None) -> dict:
    names = list(tensors)
    with torch.no_grad():
        vals = torch.stack([torch.linalg.vector_norm((tensors[k] - base[k]) if base else tensors[k]).double()
                            for k in names]).cpu().numpy()
    return dict(zip(names, vals.astype(np.float64)))


def batches(seed: int, pool: int, batch: int, count: int) -> list:
    """Each step's rows: ``batch`` distinct pool indices, in a seeded order."""
    g = rng(seed, "batches")
    return [g.choice(pool, size=batch, replace=False).tolist() for _ in range(count)]


def run(ctx: Context) -> Outcome:
    from cra5_tpu_torch.train.ema import ema_init
    from cra5_tpu_torch.train.loop import TrainerConfig, TrainState, make_train_step
    from cra5_tpu_torch.train.optim import B1, make_net_aux_optimizers

    m, job, tr, dev, seed = ctx.config["model"], ctx.config["train"], ctx.traffic, ctx.device, ctx.seed
    tcfg = job["trainer"]
    B = job["batch"]
    P0 = params.make(m, seed, dev)
    model = program.build(m, P0, job["dtype"], dev, job["flash"], remat=job["remat"])
    cfg = TrainerConfig(**{k: v for k, v in tcfg.items()})
    tx = make_net_aux_optimizers(cfg.learning_rate, cfg.aux_learning_rate, cfg.max_grad_norm,
                                 scheduler=cfg.scheduler, total_steps=cfg.total_steps)
    step_fn = make_train_step(model, tx, cfg)
    ps = dict(model.named_parameters())
    state = TrainState(step=0, params=ps, opt_state=tx.init(ps),
                       ema=ema_init(ps) if cfg.use_ema else None)
    pool = [fields.field(m, seed, i, dev)[0] for i in range(tr["pool"])]
    plan = batches(seed, tr["pool"], B, 1 << 16)
    step_rng = sub_seed(seed, "train") >> 32

    def feed(i):
        return torch.stack([pool[j] for j in plan[i]])

    def one(i):
        st, metrics = step_fn(state, feed(i), step_rng)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return metrics

    losses, prog = [], {}
    for i in range(tr["warm_steps"]):
        losses.append(float(one(i)["total_loss"]))
        if i == 0:
            prog["grad"] = {k: v / (1.0 - B1) for k, v in _norms(state.opt_state.mu).items()}
    prog["losses"] = losses
    prog["change"] = _norms(ps, P0)
    prog["ema"] = _norms(state.ema.params, P0) if state.ema is not None else {}
    del P0
    traced = None
    if ctx.trace:
        with torch.profiler.profile(activities=trace.activities(dev)):
            torch.zeros(1, device=dev).add_(1)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    ctx.log(f"before the window: {card.sample()}")
    cpu = card.cpu_s()
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_process
    n, i = 0, tr["warm_steps"]
    prof = None
    # a traced run goes on, past the seconds if need be, until its steps are profiled
    while time.perf_counter() < t0 + ctx.seconds or (ctx.trace and traced is None):
        if ctx.trace and traced is None and prof is None and n >= 1:
            prof = torch.profiler.profile(activities=trace.activities(dev))
            prof.__enter__()
            traced_from = n
        with torch.profiler.record_function("bench/step"):
            one(i)
        i += 1
        n += 1
        if prof is not None and n - traced_from >= tr["trace_steps"]:
            prof.__exit__(None, None, None)
            traced, prof = prof, None
    window_s = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
        traced = prof
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    metrics = {"train_timesteps_per_s": n * B / window_s, "setup_s": setup_s,
               "peak_gib": peak / 2 ** 30 if dev.type == "cuda" else None}
    ctx.log(f"window {window_s:.3f} s, {n} steps, {metrics}")
    ctx.log(f"after the window: {card.sample()}; the process's CPU {card.cpu_s() - cpu:.2f} s")
    run_info = {"job": "train", "timesteps": n * B, "window_s": window_s, "batch": B,
                "flops_per_timestep": flops.train_step(m, B) / B, "peak_flops": peaks.FLOPS[job["dtype"]],
                "trace": trace.reduce(trace.events(traced)) if traced is not None else None,
                "card": peaks.card()}
    if run_info["trace"] is not None:
        ctx.log(f"trace {run_info['trace'].diagnostics}")

    # -- the check: the reference repeats the first steps ----------------
    t_check = time.perf_counter()
    del model, state, ps, tx, step_fn, pool
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    refr = reference_steps(m, tcfg, seed, tr, B, dev, plan, step_rng)
    numbers, worst = judge.train_numbers(prog, refr)
    correct, checks = judge.decide(numbers, ctx.limits)
    ctx.log(f"check in {time.perf_counter() - t_check:.1f} s: {numbers}, worst leaves {worst}")
    return Outcome(n, 0, metrics, checks, correct, peak, run_info)


def reference_steps(m, tcfg, seed, tr, B, dev, plan, step_rng, prec="fp32", rows=None) -> dict:
    """The reference's readings over the first ``warm_steps`` steps: the
    losses, the first gradient's leaf norms, the parameters' and the EMA's
    change. ``rows`` keeps only the first rows of each batch (a fault)."""
    P0 = params.make(m, seed, dev)
    rt = ref_train.Trainer(m, P0, tcfg, prec)
    out = {"losses": []}
    for i in range(tr["warm_steps"]):
        idx = plan[i][:rows] if rows else plan[i]
        batch = torch.stack([fields.field(m, seed, j, dev)[0] for j in idx])
        r = rt.step(batch, step_rng)
        out["losses"].append(r["loss"])
        if i == 0:
            out["grad"] = r["grad_norms"]
        del batch
    out["change"] = _norms({k: v.detach() for k, v in rt.P.items()}, P0)
    out["ema"] = _norms(rt.ema, P0) if rt.ema is not None else {}
    return out
