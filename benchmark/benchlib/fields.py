"""Seeded input fields made on the device, and the production-bin
amplitude.

Frozen from the program's bench (``cra5_tpu_torch/bench.py``: ``field``
and ``production_point``'s search), so that a later change to the program
cannot move them: a field is a seeded standard normal (B, C, H, W) tensor
made on the device, so no host copy is timed; the amplitude scales the
fields until a rate of one field lands at a target. The benchmark's rate
is the reference's ideal code length (``reference.model.rate_bits``), not
the program's bytes, so the program's coder is measured on an input it
did not choose. The search is a secant in log-amplitude against log-rate
(the bench's damped first step, then secant steps), run to within
``tolerance`` of the target.
"""

from __future__ import annotations

import math
from typing import Callable, List, Tuple

import torch

from .seeds import sub_seed


def field(c: dict, seed: int, index: int, device, batch: int = 1) -> torch.Tensor:
    """Pool field ``index`` of ``seed``: (batch, in_chans, H, W) float32."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "field", index))
    return torch.randn((batch, c["in_chans"], *c["img_size"]), generator=g, device=device)


def production_amplitude(nbytes: Callable[[float], int], target: float, tolerance: float,
                         probes: int = 10) -> Tuple[float, List[Tuple[float, int]]]:
    """The amplitude whose rate ``nbytes(amplitude)`` comes within
    ``tolerance`` (a share) of ``target``, and the probes (amplitude,
    rate) taken."""
    amp = 1.0
    hist = [(amp, nbytes(amp))]
    for _ in range(probes - 1):
        a, b = hist[-1]
        if abs(b / target - 1.0) <= tolerance:
            break
        if len(hist) == 1:
            step = min(max(0.8 * math.log(target / b), -math.log(4.0)), math.log(4.0))
        else:
            (a0, b0) = hist[-2]
            slope = (math.log(b) - math.log(b0)) / (math.log(a) - math.log(a0) or 1e-12)
            step = (math.log(target) - math.log(b)) / (slope if slope > 1e-3 else 1e-3)
            step = min(max(step, -math.log(4.0)), math.log(4.0))
        amp = min(max(a * math.exp(step), 1 / 64), 64.0)
        hist.append((amp, nbytes(amp)))
    best = min(hist, key=lambda p: abs(p[1] / target - 1.0))
    return best[0], hist
