"""The controls: the reference put in the program's place, one precision
below what the configuration states, judged exactly as the program is
(``judge``); and faults planted in the reference put in the program's
place: the codec's z altered where it is produced, and the faults a
training cell can have. Each comes out not correct against the cell's
limits (``readings.py`` requires it). The benchmark's own runs never run
these; ``readings.py`` runs them on the card to set the limits, and
``tests/test_bench_controls.py`` at a size a test run holds.
"""

from __future__ import annotations

import gc
from typing import Dict

import torch

from reference import model as ref, tables

from . import fields, judge, params
from .harness import Context
from .jobs import roundtrip, train


def _faulted(R: ref.VAEformer, fault: str) -> ref.VAEformer:
    """The reference with a z fault planted where z is produced."""
    F = ref.VAEformer(R.c, R.P, R.prec)
    if fault == "h_a_zero":  # h_a returns zeros
        F.h_a = lambda y: torch.zeros_like(R.h_a(y))
    elif fault == "z_plus_one":  # every z symbol one step up
        F.h_a = lambda y: R.h_a(y) + 1.0
    return F


CODEC = {"fp8": ("fp8", None), "h_a_zero": ("fp32", "h_a_zero"), "z_plus_one": ("fp32", "z_plus_one")}


def codec(ctx: Context) -> Dict[str, Dict[str, float]]:
    """The worst of each codec number over as many pool fields as a run
    checks, with the reference coding them in the program's place: in fp8
    (the control), and in float32 with a z fault planted (``CODEC``)."""
    m, seed, dev = ctx.config["model"], ctx.seed, ctx.device
    P = params.make(m, seed, dev)
    inputs = roundtrip.Inputs(ctx, P)
    P.update(inputs.fitted)
    amp = inputs.amp
    del inputs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    R = ref.VAEformer(m, P)
    st = torch.from_numpy(tables.scale_table()).to(dev)
    worst: Dict[str, Dict[str, float]] = {name: {} for name in CODEC}
    with torch.no_grad():
        for idx in range(min(ctx.traffic["check_requests"], ctx.traffic["pool"])):
            x = fields.field(m, seed, idx, dev) * amp
            r = R.codec_symbols(x, st)
            for name, (prec, fault) in CODEC.items():
                C = _faulted(ref.VAEformer(m, P, prec), fault)
                # a fault keeps the float32 towers: its y and g_s are R's
                c = C.codec_symbols(x, st) if fault is None else C.symbols_from_y(r["y"], st)
                _, means_rc, idx_rc = R.hyper_from_z(c["z_sym"], st)
                x_ref = R.g_s(c["y_sym"].float() + means_rc)
                x_c = C.g_s(c["y_sym"].float() + c["means"]) if fault is None else x_ref
                nums = judge.codec_numbers(r, c["z_sym"], c["idx"], c["y_sym"], x_c, means_rc,
                                           idx_rc, x_ref)
                for k, v in nums.items():
                    worst[name][k] = max(worst[name].get(k, 0.0), v)
    for nums in worst.values():
        nums["stream_faults"] = 0.0  # the reference writes no streams
    return worst


def training(ctx: Context) -> Dict[str, Dict[str, float]]:
    """The training numbers of the reference at "tf32" in the program's
    place, and of the reference leaving out half of each batch (the mean
    taken over the rest), each against the float32 reference."""
    m, seed, dev, tr = ctx.config["model"], ctx.seed, ctx.device, ctx.traffic
    job = ctx.config["train"]
    B = job["batch"]
    plan = train.batches(seed, tr["pool"], B, tr["warm_steps"])
    rng = train.sub_seed(seed, "train") >> 32
    steps = lambda **kw: train.reference_steps(m, job["trainer"], seed, tr, B, dev, plan, rng, **kw)
    base = steps()
    out = {}
    for name, kw in (("tf32", {"prec": "tf32"}), ("half_batch", {"rows": B // 2})):
        out[name] = judge.train_numbers(steps(**kw), base)[0]
        gc.collect()
    return out
