"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit), the bound arithmetic, and the card's own power limit,
read beside every number.

Float32 work on this card's tensor cores is TF32 at best, so 495 TFLOP/s
is the float32 peak that no float32 implementation can pass (the port's
float32 flash kernels run three TF32 products a product, and its float32
GEMMs run on the FMA units).
"""

from __future__ import annotations

import subprocess

FLOPS = {"bfloat16": 989e12, "float32": 495e12}
BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: operations over the dtype's peak
    or bytes over the memory's, whichever is larger."""
    return max(flops / FLOPS[dtype], nbytes / BYTES_PER_S)


def card(index: int = 0) -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
        return out[index] if len(out) > index else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"
