"""Time the image codecs' convolution towers by convolution route.

The zoo's convolutions run with cuDNN off (``nn/conv.py::native_conv``):
PyTorch's own im2col / col2im and cuBLAS GEMMs, float32 with TF32 off.
This probe times ``g_a`` and ``g_s`` of cheng2020-anchor q6 and
mbt2018-mean q8 (the zoo's full widths, seeded weights) on one seeded
Kodak-size input (1, 3, 512, 768) down that route and down cuDNN's, with
``benchmark`` and ``deterministic`` each off and on, and says whether two
``g_s`` calls agree bitwise (the codec's decode gate needs that). No path
of the port runs it.

    python -m cra5_tpu_torch.profiling.conv_routes

prints one line a model and route (CUDA events over back-to-back calls,
after a warm-up call that also runs cuDNN's autotuning where
``benchmark`` is on), each with the card's name and power limit, and
returns the rows.
"""

from __future__ import annotations

import subprocess
from typing import Dict, List

import torch

from ..device import resolve_device
from ..models import load_model
from ..nn import conv

KODAK = (1, 3, 512, 768)
MODELS = (("cheng2020-anchor", 6), ("mbt2018-mean", 8))


def _cudnn(benchmark: bool, deterministic: bool):
    return lambda: torch.backends.cudnn.flags(enabled=True, benchmark=benchmark,
                                              deterministic=deterministic, allow_tf32=False)


ROUTES = {
    "port (cuDNN off)": conv.native_conv,
    "cuDNN": _cudnn(False, False),
    "cuDNN deterministic": _cudnn(False, True),
    "cuDNN benchmark": _cudnn(True, False),
    "cuDNN benchmark deterministic": _cudnn(True, True),
}


def _ms(fn, iters: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run(iters: int = 3, seed: int = 0) -> List[Dict]:
    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    native, rows = conv.native_conv, []
    for arch, q in MODELS:
        model, _ = load_model(arch, q, device=dev)
        x = torch.rand(KODAK, generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
        with torch.inference_mode():
            y = model.g_a(x)
            for name, route in ROUTES.items():
                conv.native_conv = route
                try:
                    ga, gs = _ms(lambda: model.g_a(x), iters), _ms(lambda: model.g_s(y), iters)
                    same = torch.equal(model.g_s(y), model.g_s(y))
                finally:
                    conv.native_conv = native
                rows.append(dict(arch=arch, quality=q, route=name, g_a_ms=ga, g_s_ms=gs,
                                 bitwise=same))
                print(f"[conv routes] {arch} q{q} {KODAK} float32, {name}: g_a {ga:.3f} ms, "
                      f"g_s {gs:.3f} ms; two g_s calls bitwise equal {same}  ({card})",
                      flush=True)
        del model
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    run()
