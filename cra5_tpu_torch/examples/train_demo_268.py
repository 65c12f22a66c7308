"""268v end-to-end training on the card: train, save the full train state
mid-run, resume it into a fresh Trainer, continue, rebuild the CDF tables
from the trained entropy model and compress a held-out field.

Counterpart of ``examples/train_demo_268.py``, in four phases:

  1. smooth global fields made on the device for each step (coarse normal
     noise at (268, 46, 90) upsampled linearly to (268, 721, 1440), plus
     0.05 of fine noise, all x 0.5: spatially correlated, so the codec has
     structure to learn), on which ``Trainer.fit`` trains the 268v
     VAEformer (remat, bf16 compute, EMA, the net/aux optimizers) with the
     rate-distortion loss up to ``--save-at``;
  2. ``Trainer.save`` writes the full state (params, both Adam moments, the
     EMA shadow and its count, the step); the live trainer takes the next
     step, then is freed, and a fresh model and Trainer ``restore`` the
     file: every tensor must equal the saved one bitwise, the step and the
     counts too, and the same step taken again from the restored state
     must give the live step's metrics and tensors bitwise;
  3. training continues to ``--steps``;
  4. ``VAEformerCodec.update()`` rebuilds the tables and a held-out field is
     compressed and decompressed with the step-0 weights, the trained
     weights and the EMA shadow (in a model of its own): bytes, bpp, MSE,
     seconds, the decode kernel the y stream's header routes it to and its
     escape share; every decoded symbol must equal the encoder's.

The result JSON (``--out``, default ``<ckpt-dir>/demo_result.json``) has
the JAX script's keys and ``timing``; ``train_demo_report`` renders it.
``main`` returns it with ``total_loss``, every step's total loss, besides.
The checkpoints (~8.1 GB at 268v: the 6.5 GB state and the 1.6 GB
params-only file) stay in ``--ckpt-dir``, by default a new temporary
directory.

    python -m cra5_tpu_torch.examples.train_demo_268 [--steps 400] [--save-at 200]
    python -m cra5_tpu_torch.examples.train_demo_268 --device cpu --config tiny \\
        --steps 6 --save-at 3 --pool 2
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import statistics
import tempfile
import time
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from ..coder.lane_coder import parse_v2_header
from ..device import resolve_device
from ..models.vaeformer import VAEformer, VAEformerCodec, vaeformer_268, vaeformer_tiny
from ..train import Trainer, TrainerConfig
from ..train.checkpoints import resolve_last_checkpoint
from . import add_device_arg, sync

COARSE_268 = (268, 46, 90)
POOL_SEED, HELD_OUT_SEED = 1000, 99  # field i of the pool: seed 1000 + i
LOG_EVERY = 25


def upsample(coarse: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.image.resize(coarse, shape, "bilinear")`` for a (C, H, W)
    upsampling: linear along each axis at half-pixel centres, the edges
    clamped (JAX drops the taps past an edge and renormalises, which for
    an upsampling leaves the edge value, as the clamp does)."""
    return F.interpolate(coarse[None, None], size=tuple(shape), mode="trilinear",
                         align_corners=False)[0, 0]


def make_field(coarse: torch.Tensor, fine: torch.Tensor) -> torch.Tensor:
    """(1, C, H, W): the coarse noise upsampled to the fine noise's shape,
    plus 0.05 x the fine noise, all x 0.5 (the JAX script's field)."""
    return (upsample(coarse, fine.shape) + 0.05 * fine)[None] * 0.5


def seeded_field(seed: int, shape, coarse, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    c = torch.randn(tuple(coarse), generator=gen, device=device)
    return make_field(c, torch.randn(tuple(shape), generator=gen, device=device))


@contextlib.contextmanager
def _recording(obj, names):
    """obj.<name> records its last (args, result) in the yielded dict."""
    seen = {}

    def wrap(name):
        fn = getattr(obj, name)

        def wrapped(*args):
            out = fn(*args)
            seen[name] = (args, out)
            return out
        return wrapped

    for name in names:
        setattr(obj, name, wrap(name))
    try:
        yield seen
    finally:
        for name in names:
            delattr(obj, name)


def eval_codec(model: VAEformer, x: torch.Tensor) -> dict:
    """Rebuild the CDF tables (``update()``), compress ``x`` and decompress
    it: bytes, bpp (8 bytes over H x W), MSE, seconds (tables included);
    the decode kernel the y stream's header routes it to (K3 if sorted and
    kernel-safe, else K2) and its escape share. Raises if the decoded z or
    y symbols differ from the encoder's."""
    H, W = model.cfg.img_size
    codec = VAEformerCodec(model, coder="v2")
    sync(model.device)
    t0 = time.perf_counter()
    names = ("symbols_from_latent", "scales_from_z_symbols", "reconstruct_from_y_symbols")
    with _recording(model, names) as seen:
        codec.update()
        out = codec.compress(x)
        x_hat = codec.decompress(out["strings"], out["z_shape"])["x_hat"]
    with torch.inference_mode():
        mse = float(torch.mean(torch.square(x_hat.float() - x.float())))
    sync(model.device)
    wall = time.perf_counter() - t0
    enc = seen["symbols_from_latent"][1]
    z_dec, y_dec = seen["scales_from_z_symbols"][0][0], seen["reconstruct_from_y_symbols"][0][0]
    if not (torch.equal(z_dec, enc["z_sym"]) and torch.equal(y_dec, enc["y_sym"])):
        raise RuntimeError("the decoded symbols differ from the encoder's")
    nbytes = sum(len(s) for grp in out["strings"] for s in grp)
    n, _, n_esc, _, srt, safe, _ = parse_v2_header(out["strings"][0][0])
    return {"bin_bytes": nbytes, "bpp": 8 * nbytes / (H * W), "mse": mse, "wall_s": wall,
            "y_decode_kernel": "K3" if srt and safe else "K2", "y_escape_share": n_esc / n}


def _tensors(state) -> Dict[str, torch.Tensor]:
    """Every tensor of a train state, by kind and name."""
    out = {f"params/{k}": v for k, v in state.params.items()}
    out.update({f"mu/{k}": v for k, v in state.opt_state.mu.items()})
    out.update({f"nu/{k}": v for k, v in state.opt_state.nu.items()})
    out.update({f"ema/{k}": v for k, v in state.ema.params.items()})
    return out


def _snapshot(state) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in _tensors(state).items()}


def _counts(state) -> Dict[str, int]:
    return {"step": state.step, "adam_count": state.opt_state.count, "ema_steps": state.ema.steps}


def _build(config: str, device):
    if config == "tiny":
        cfg = vaeformer_tiny()
        return cfg, VAEformer(cfg, device=device)
    cfg = dataclasses.replace(vaeformer_268(), remat=True)
    return cfg, VAEformer(cfg, dtype=torch.bfloat16, device=device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--save-at", type=int, default=200)
    ap.add_argument("--pool", type=int, default=6, help="distinct training fields")
    ap.add_argument("--ckpt-dir", default=None, help="default: a new temporary directory")
    ap.add_argument("--out", default=None, help="write result JSON here")
    ap.add_argument("--config", default="268", choices=["268", "tiny"],
                    help="tiny = the same four phases at the tiny test model's size")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    if not 0 < args.save_at < args.steps or args.pool < 1:
        ap.error(f"need 0 < --save-at < --steps and --pool >= 1: {args.save_at}, "
                 f"{args.steps}, {args.pool}")
    dev = resolve_device(args.device)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="train_demo_268_")
    os.makedirs(ckpt_dir, exist_ok=True)

    cfg, model = _build(args.config, dev)
    tcfg = TrainerConfig(learning_rate=1e-4, lmbda=1.0, bpp_weight=0.02, use_ema=True,
                         log_every=1, ckpt_every=10**9, ckpt_dir=ckpt_dir)
    result = {"config": {"steps": args.steps, "save_at": args.save_at, "pool": args.pool,
                         "lmbda": tcfg.lmbda, "bpp_weight": tcfg.bpp_weight}}
    shape = (cfg.in_chans, *cfg.img_size)
    coarse = COARSE_268 if args.config == "268" else tuple(max(1, d // 16) for d in shape)

    def field(seed: int) -> torch.Tensor:
        return seeded_field(seed, shape, coarse, dev)

    def pool_field(i: int) -> torch.Tensor:
        return field(POOL_SEED + i % args.pool)

    def evaluate(m: VAEformer, label: str) -> dict:
        r = eval_codec(m, field(HELD_OUT_SEED))
        print(f"[demo] codec[{label}]: {r}", flush=True)
        return r

    losses: Dict[int, dict] = {}
    total_loss = [None] * (args.steps + 1)  # by step; [0] unused
    step_s = []

    def run_steps(trainer, state, lo: int, hi: int, record: bool = True):
        """Steps lo+1..hi through Trainer.fit; returns the state and the
        last step's metrics. Each step's host seconds (field made on the
        device included) end in a synchronize."""
        last = {}
        stamp = [0.0]

        def log_fn(step, m):
            sync(dev)
            now = time.perf_counter()
            sec, stamp[0] = now - stamp[0], now
            m = {k: v for k, v in m.items() if k != "steps_per_sec"}
            last.update(m)
            if not record:
                return
            total_loss[step] = m["total_loss"]
            if step > lo + 1:  # the first step of a fit warms up
                step_s.append(sec)
            if step % LOG_EVERY == 0 or step == hi:
                losses[step] = m
                print(f"[demo] step {step}: {m}  ({sec:.3f} s)", flush=True)

        sync(dev)
        stamp[0] = time.perf_counter()
        state = trainer.fit((pool_field(i) for i in range(lo, hi)), state=state,
                            num_steps=hi - lo, log_fn=log_fn)
        return state, last

    trainer = Trainer(model, tcfg)
    t0 = time.perf_counter()
    state = trainer.init_state(pool_field(0))
    sync(dev)
    init_s = time.perf_counter() - t0
    print(f"[demo] init_state: {init_s:.1f}s", flush=True)
    result["codec_step0"] = evaluate(model, "step0")

    # phase 1: train to the checkpoint
    state, _ = run_steps(trainer, state, 0, args.save_at)

    # phase 2: save, one live step, a fresh model and Trainer, restore,
    # the same step again
    n_params = sum(p.numel() for p in model.parameters())
    need = 5 * 4 * n_params  # float32: the params-only file, params + 2 moments + EMA
    free = shutil.disk_usage(ckpt_dir).free
    if free < need * 1.1:
        raise RuntimeError(f"{ckpt_dir}: {free} bytes free, the checkpoints need ~{need}")
    saved, saved_counts = _snapshot(state), _counts(state)
    t0 = time.perf_counter()
    params_path = trainer.save(state)
    save_s = time.perf_counter() - t0
    state_path = resolve_last_checkpoint(ckpt_dir, "last_state")
    nbytes = os.path.getsize(params_path) + os.path.getsize(state_path)
    print(f"[demo] full-state save at step {args.save_at}: {save_s:.1f}s, {nbytes} B", flush=True)

    state, live_metrics = run_steps(trainer, state, args.save_at, args.save_at + 1,
                                    record=False)
    live = _snapshot(state)
    del trainer, state, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    cfg, model = _build(args.config, dev)
    trainer = Trainer(model, tcfg)
    t0 = time.perf_counter()
    state = trainer.restore(pool_field(0))
    sync(dev)
    restore_s = time.perf_counter() - t0
    restored = _tensors(state)
    differ = [k for k in saved if not torch.equal(restored[k], saved[k])]
    if differ or _counts(state) != saved_counts:
        raise RuntimeError(f"the restored state differs from the saved one: counts "
                           f"{_counts(state)} against {saved_counts}; tensors {differ[:8]}")
    print(f"[demo] restore into a fresh Trainer: {restore_s:.1f}s; step, counts and "
          f"{len(saved)} tensors bitwise equal", flush=True)
    del saved, restored

    state, metrics = run_steps(trainer, state, args.save_at, args.save_at + 1)
    now = _tensors(state)
    moved = [k for k in live if not torch.equal(now[k], live[k])]
    if moved or metrics != live_metrics:
        raise RuntimeError(f"step {args.save_at + 1} from the restored state differs from the "
                           f"live one: metrics {metrics} against {live_metrics}; {len(moved)} "
                           f"tensors differ: {moved[:8]}")
    print(f"[demo] step {args.save_at + 1} again from the restored state: metrics and "
          f"{len(live)} tensors bitwise equal to the live step's", flush=True)
    del live, now
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    result["resume"] = {"save_s": save_s, "restore_s": restore_s, "checksums_match": True,
                        "resumed_step": saved_counts["step"], "bytes": nbytes,
                        "repeat_bitwise": True}

    # phase 3: continue to the end
    state, _ = run_steps(trainer, state, args.save_at + 1, args.steps)
    result["losses"] = losses

    # phase 4: the trained codec and its EMA shadow on the held-out field
    result["codec_trained"] = evaluate(model, "trained")
    _, ema_model = _build(args.config, dev)
    with torch.no_grad():
        for k, p in ema_model.named_parameters():
            p.copy_(state.ema.params[k])
    result["codec_trained_ema"] = evaluate(ema_model, "trained-ema")
    result["timing"] = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
                        else "cpu", "init_s": init_s,
                        "step_s_median": statistics.median(step_s) if step_s else None,
                        "steps_timed": len(step_s)}

    out_path = args.out or os.path.join(ckpt_dir, "demo_result.json")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"demo": "ok", "out": out_path}), flush=True)
    return {**result, "total_loss": total_loss[1:]}


if __name__ == "__main__":
    main()
