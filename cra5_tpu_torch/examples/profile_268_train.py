"""Profile the 268v training step under two remat policies and decide
between them.

Counterpart of ``examples/profile_268_train.py``: the full 268v VAEformer
in bf16 with ``remat=True`` (every block recomputed in the backward) and
with ``remat="dots"`` (the matmul outputs kept); for each, the seconds of
the seeded init, of a warm-up step and the median of ``--steps`` timed
steps, each ending in a synchronize. ``"dots"`` is chosen where its step
is below 0.95 of ``remat=True``'s. A variant that runs out of device
memory is recorded as an error and the other still runs. ``--trace``
writes one ``remat=True`` step's ``torch.profiler`` Chrome trace. The JAX
script's attention routing stays at its "auto" (the port has no flash
mode switch).

    python -m cra5_tpu_torch.examples.profile_268_train [--steps 5] [--trace]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import tempfile
import time

import torch

from ..device import resolve_device
from ..models.vaeformer import VAEformer, vaeformer_268
from ..train import Trainer, TrainerConfig
from . import add_device_arg, sync


def decide(full_s: float, dots_s: float) -> dict:
    """The remat decision from the two median step seconds."""
    return {"dots_remat_speedup": round(full_s / dots_s, 3),
            "decision": ("use remat='dots' for 268v training" if dots_s < 0.95 * full_s
                         else "keep remat=True (full block recompute; dots not faster)")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--trace", action="store_true", help="also write a profiler trace")
    ap.add_argument("--trace-dir", default=None, help="default: a new temporary directory")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    base = vaeformer_268()
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((1, base.in_chans, *base.img_size), generator=gen, device=device)
    results = {}
    for remat in (True, "dots"):
        key = f"auto+{'dots' if remat == 'dots' else 'full'}"
        model = VAEformer(dataclasses.replace(base, remat=remat), dtype=torch.bfloat16,
                          device=device)
        trainer = Trainer(model, TrainerConfig(use_ema=False, log_every=1, ckpt_every=10**9))
        state, losses = None, []

        def step(state):
            state = trainer.fit([x], state=state, num_steps=1,
                                log_fn=lambda s, m: losses.append(m["loss"]))
            sync(device)
            return state

        try:
            t0 = time.perf_counter()
            state = trainer.init_state(x)
            sync(device)
            init_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            state = step(state)
            warmup_s = time.perf_counter() - t0
            times = []
            for _ in range(args.steps):
                t0 = time.perf_counter()
                state = step(state)
                times.append(time.perf_counter() - t0)
            results[key] = {"step_s": statistics.median(times), "all_steps_s": times,
                            "warmup_s": warmup_s, "init_s": init_s, "loss": losses[-1]}
        except torch.cuda.OutOfMemoryError as e:
            results[key] = {"error": f"{type(e).__name__}: {str(e)[:300]}"}
        print(json.dumps({key: results[key]}), flush=True)

        if args.trace and key == "auto+full" and state is not None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == "cuda" else [])
            with profile(activities=activities) as prof:
                state = step(state)
            trace_dir = args.trace_dir or tempfile.mkdtemp(prefix="trace_268_")
            os.makedirs(trace_dir, exist_ok=True)
            results["trace"] = os.path.join(trace_dir, "train_step.json")
            prof.export_chrome_trace(results["trace"])
        del state, trainer, model
        if device.type == "cuda":
            torch.cuda.empty_cache()

    full_s = results["auto+full"].get("step_s")
    dots_s = results["auto+dots"].get("step_s")
    if full_s and dots_s:
        results.update(decide(full_s, dots_s))
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
