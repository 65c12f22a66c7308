"""Peak device memory and step seconds of one 268v training setting.

The published ERA5 configurations train at batch 4 with EMA, clipping
and the warmup-cosine schedule (``api/configs/train_era5_base.py``). This
probe builds the 268v model in a dtype, with or without remat, takes
that trainer block, and runs ``--steps`` steps on one seeded batch
already on the card (no tree, no loader): it says which settings fit one
card, and what a step costs on the device alone. Run it in a process of
its own, since a setting that does not fit raises. ``--batch`` takes a
list: the batches run in turn on one model and state, each after the
last one's tensors are freed. ``chip_smoke.py``'s float32 reckoning runs
it at batch 1,2 (float32, no remat: the published config as written);
``--dtype bfloat16`` and ``--remat`` give the bf16 and remat peaks that
PERF.md sets beside it.

    python -m cra5_tpu_torch.profiling.train_memory --dtype float32 --batch 1,2
        [--remat] [--steps 3]

prints one JSON line a batch: the setting, the flash mode, each step's
seconds (the first with the allocator's warm-up), the memory held after
the init, the peak (``max_memory_allocated``) over that batch's steps,
the last step's metrics, the flash launches over the steps, the model's
attentions (``attention_layout``) and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import torch

from .. import kernels
from ..device import resolve_device
from ..models.vaeformer import VAEformer, vaeformer_268
from ..nn import blocks
from ..train import Trainer, TrainerConfig
from ..utils.config import Config


def attention_layout(model) -> list:
    """Every attention of a built VAEformer's g_a, g_s, h_a and h_s, read
    from its blocks, as (tower, tokens each attends over, windows, heads):
    a window block attends within each window of its tower's grid (padded
    to a window multiple), a global block over the whole grid."""
    cfg = model.cfg
    rows = []
    for tower, grid in (("g_a", cfg.latent_grid), ("g_s", cfg.latent_grid),
                        ("h_a", cfg.hyper_grid), ("h_s", cfg.hyper_grid)):
        for blk in getattr(model, tower).blocks:
            win = blk.window_size
            if win is None:
                rows.append((tower, grid[0] * grid[1], 1, blk.attn.num_heads))
            else:
                rows.append((tower, win[0] * win[1], math.ceil(grid[0] / win[0])
                             * math.ceil(grid[1] / win[1]), blk.attn.num_heads))
    return rows


def trainer_block() -> dict:
    """The published 268v config's trainer block as TrainerConfig keywords,
    with its `steps` as the schedule's horizon (the train CLI's rule) and a
    log every step."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "api",
                        "configs", "train_era5_268v_1h.py")
    cfg = Config.fromfile(path)
    tc = dict(cfg["trainer"])
    tc["scheduler"] = dict(tc["scheduler"])
    return dict(tc, total_steps=cfg["steps"], log_every=1)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    ap.add_argument("--batch", type=lambda s: [int(b) for b in s.split(",")], default=[4])
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    cfg = dataclasses.replace(vaeformer_268(), remat=args.remat)
    model = VAEformer(cfg, dtype=getattr(torch, args.dtype), device=dev)
    trainer = Trainer(model, TrainerConfig(**trainer_block()))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    state, outs = None, []
    for batch in args.batch:
        x = torch.randn((batch, cfg.in_chans, *cfg.img_size), device=dev,
                        generator=torch.Generator(dev).manual_seed(0)) * 0.5
        if state is None:
            state = trainer.init_state(x)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        steps, metrics = [], []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            state = trainer.fit([x], state=state, num_steps=1,
                                log_fn=lambda step, m: metrics.append(m))
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
        outs.append({"dtype": args.dtype, "batch": batch, "remat": args.remat,
                     "flash_mode": blocks.flash_attention_mode(), "steps_s": steps,
                     "held_after_init_gib": held / 2**30,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "metrics": metrics[-1],
                     "launches": {k: v for k, v in kernels.launch_counts().items() if v},
                     "attention": attention_layout(model), "card": card})
        print(json.dumps(outs[-1]), flush=True)
        del x
        torch.cuda.empty_cache()
    return outs


if __name__ == "__main__":
    main()
    sys.exit(0)
