"""Single-card 268v training-step smoke: the full production model (ViT-L
towers, 10 368 tokens) trains on one card with remat and the flash
attention kernels forward and backward, in bf16.

Counterpart of ``examples/train_268v_smoke.py``: init, one warm-up step,
then three timed steps through ``Trainer.fit`` (no EMA).

    python -m cra5_tpu_torch.examples.train_268v_smoke
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..device import resolve_device
from ..models.vaeformer import VAEformer, vaeformer_268
from ..train import Trainer, TrainerConfig
from . import add_device_arg, sync

TIMED_STEPS = 3


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    cfg = dataclasses.replace(vaeformer_268(), remat=True)
    model = VAEformer(cfg, dtype=torch.bfloat16, device=device)
    trainer = Trainer(model, TrainerConfig(use_ema=False, log_every=1, ckpt_every=10**9))
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((1, cfg.in_chans, *cfg.img_size), generator=gen, device=device) * 0.5
    metrics = {}

    def log_fn(step, m):
        metrics.update((k, v) for k, v in m.items() if k != "steps_per_sec")

    t0 = time.perf_counter()
    state = trainer.init_state(x)
    sync(device)
    init_s = time.perf_counter() - t0
    print(f"init_state: {init_s:.1f}s")
    t0 = time.perf_counter()
    state = trainer.fit([x], state=state, num_steps=1, log_fn=log_fn)
    sync(device)
    warmup_s = time.perf_counter() - t0
    print(f"step 1 (warm-up): {warmup_s:.1f}s")
    t0 = time.perf_counter()
    trainer.fit([x] * TIMED_STEPS, state=state, num_steps=TIMED_STEPS, log_fn=log_fn)
    sync(device)
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    print(f"steps 2-{1 + TIMED_STEPS}: {step_s:.2f}s/step")
    print("metrics:", metrics)
    print("268v TRAINING STEP OK ON ONE CARD")
    return {"init_s": init_s, "warmup_step_s": warmup_s, "step_s": step_s, "metrics": metrics}


if __name__ == "__main__":
    main()
