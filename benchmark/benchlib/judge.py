"""The numbers that decide ``correct``, each against the plain reference.

Codec (``codec_numbers``), for one request, given what the program (or a
control in its place) produced and what the float32 reference derives:
  - ``z_far``: the share of z symbols more than 0.75 off the reference's
    unrounded z (g_a, quant_conv, h_a, the prior's medians): a quarter step
    past what rounding alone can give; the one number that holds h_a and
    the medians (the others start from the program's own decoded z);
  - ``y_far``: the same of the y symbols against the reference's unrounded
    y less the means the reference's h_s gives for the same z symbols
    (g_a, quant_conv, h_s's means);
  - ``idx_gap``: the mean gap, in table rows, of the y streams' CDF rows to
    the rows the reference's h_s gives for the same z symbols;
  - ``x_rel``: the reconstruction's relative L2 gap to the reference's g_s
    of the same y symbols (with the reference's means);
  - ``z_rel``, ``y_rel``: the symbols' relative L2 gaps to the reference's
    own symbols, reported but held to no limit (the controls read only 2-4
    times the program there: a flipped rounding moves a symbol a whole
    step, and a z flip moves its patch's means).
Whether the streams decode at all is ``stream_faults`` (limit 0).

Training (``train_numbers``), over the first three steps:
  - ``loss_gap``: the worst step's |loss - reference| / |reference|;
  - ``grad_gap``: the worst leaf's | ||g|| - ||g_ref|| | / max(||g_ref||,
    the median leaf's ||g_ref||), g the first step's gradient as the
    optimizer took it;
  - ``change_gap`` and ``ema_gap``: the same of the parameters' and the
    EMA's change over the three steps, leaving out leaves whose reference
    gradient is under a thousandth of the median leaf's (Adam moves those by
    round-off alone);
  - ``ema_med_gap``: the median leaf's gap of the EMA's change, the same
    leaves kept: a step of the EMA done wrong moves every leaf, while the
    worst leaf's gap swings with a few elements' rounding (a LayerNorm
    scale near 1 moves by whole float32 steps under the warm-up's rate).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

EXCLUDE_BELOW = 1e-3


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp(min=1e-30))


FAR = 0.75


def far(sym: torch.Tensor, exact: torch.Tensor) -> float:
    return float(((sym.double() - exact.double()).abs() > FAR).double().mean())


def codec_numbers(ref_syms: dict, z_out, idx_out, y_out, x_out, means_ref_of_z, idx_ref_of_z,
                  x_ref) -> Dict[str, float]:
    return {"z_far": far(z_out, ref_syms["z"]),
            "y_far": far(y_out, ref_syms["y"] - means_ref_of_z),
            "idx_gap": float((idx_out.long() - idx_ref_of_z.long()).abs().double().mean()),
            "x_rel": rel(x_out.float(), x_ref.float()),
            "z_rel": rel(z_out.float(), ref_syms["z_sym"].float()),
            "y_rel": rel(y_out.float(), ref_syms["y_sym"].float())}


def leaf_gaps(prog: Dict[str, float], refn: Dict[str, float], keep: Sequence[str]) -> Dict[str, float]:
    """Each kept leaf's gap of norms, over the larger of its reference norm
    and the median leaf's."""
    med = float(np.median([refn[k] for k in keep]))
    return {k: abs(prog[k] - refn[k]) / max(refn[k], med, 1e-30) for k in keep}


def leaf_gap(prog: Dict[str, float], refn: Dict[str, float], keep: Sequence[str]) -> Tuple[float, str]:
    """The worst leaf's gap of norms, and its name."""
    gaps = leaf_gaps(prog, refn, keep)
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def train_numbers(prog: dict, refr: dict) -> Tuple[Dict[str, float], Dict[str, str]]:
    """``prog`` and ``refr``: {"losses": [3], "grad": {leaf: norm},
    "change": {leaf: norm}, "ema": {leaf: norm}}."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], refr["losses"])]
    names = list(refr["grad"])
    med_g = float(np.median([refr["grad"][k] for k in names]))
    moved = [k for k in names if refr["grad"][k] >= EXCLUDE_BELOW * med_g]
    out, worst = {"loss_gap": max(losses)}, {}
    for key, which, keep in (("grad_gap", "grad", names), ("change_gap", "change", moved),
                             ("ema_gap", "ema", moved)):
        out[key], worst[key] = leaf_gap(prog[which], refr[which], keep)
    out["ema_med_gap"] = float(np.median(list(leaf_gaps(prog["ema"], refr["ema"], moved).values())))
    return out, worst


def decide(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[Tuple[str, float, float]]]:
    checks = [(k, float(v), float(limits[k])) for k, v in numbers.items() if k in limits]
    missing = [k for k in limits if k not in numbers]
    ok = not missing and all(v <= lim for _, v, lim in checks)
    return ok, checks
