"""The TCM cell's controls: the reference one precision below the
configuration's (TF32 operands) in the program's place, and the reference
with a z fault planted where z is produced (h_a returning zeros,
``h_a_zero``; every z symbol a step up, ``z_plus_one``), each judged
exactly as the program is (``jobs/image_roundtrip.numbers``). Run by
``control_readings.py`` on the card to set the limits, never by the
benchmark's own runs."""

from __future__ import annotations

import gc
from typing import Dict

import torch

from reference import tables, tcm2023 as ref

from . import tcm
from .harness import Context
from .jobs import image_roundtrip

CASES = {"tf32": ("tf32", None), "h_a_zero": ("fp32", "h_a_zero"),
         "z_plus_one": ("fp32", "z_plus_one")}


def _coder_in_place(m: dict, P, prec: str, fault) -> ref.TCM:
    C = ref.TCM(m, P, prec)
    h_a = C.h_a
    if fault == "h_a_zero":
        C.h_a = lambda y: torch.zeros_like(h_a(y))
    elif fault == "z_plus_one":
        C.h_a = lambda y: h_a(y) + 1.0
    return C


def codec(ctx: Context) -> Dict[str, Dict[str, float]]:
    """The worst of each codec number over as many pool images as a run
    checks, for each of ``CASES``."""
    m, seed, dev, tr = ctx.config["model"], ctx.seed, ctx.device, ctx.traffic
    P = tcm.make(m, seed, dev)
    inputs = image_roundtrip.Inputs(ctx, P)
    P.update(inputs.fitted)
    contrast = inputs.contrast
    del inputs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    R = ref.TCM(m, P)
    table = torch.from_numpy(tables.scale_table()).to(dev)
    worst: Dict[str, Dict[str, float]] = {name: {} for name in CASES}
    with torch.no_grad():
        for idx in range(min(tr["check_requests"], tr["pool"])):
            x = tcm.frame(tcm.field(seed, idx, tr["height"], tr["width"], dev), contrast,
                          tr["pad_to"])
            for name, (prec, fault) in CASES.items():
                C = _coder_in_place(m, P, prec, fault)
                enc = C.encode(x)
                rows = [ref.indexes(s, table) for s in enc["sigma"]]
                x_c = C.g_s(torch.cat(enc["y_hat"], 1))
                nums = image_roundtrip.numbers(R, x, enc["z_sym"], enc["sym"], rows, x_c, table)
                for k, v in nums.items():
                    worst[name][k] = max(worst[name].get(k, 0.0), v)
                del enc, x_c
    for nums in worst.values():
        nums["stream_faults"] = 0.0  # the reference writes no streams
    return worst
