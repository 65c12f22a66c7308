"""The floor under the lane encode K1: its serial chain alone.

K1 (``csrc/rans_encode.cu``) walks each lane's M steps as one serial
chain. ``profiling/csrc/encode_chain_probe.cu`` runs that chain's
arithmetic alone, on freqs and starts made in registers, with no loads and
no stores but the final states, so that its time is M times one step's
dependent latency. ``chip_smoke.py`` times it (``device_us``) at the 268v
streams' shapes and prints it beside K1. It is built here with ``nvcc``
into ``build/cra5_tpu_torch/``; no path of the port runs it.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
from functools import lru_cache
from pathlib import Path

import torch

from .. import kernels

_SRC = Path(__file__).resolve().parent / "csrc" / "encode_chain_probe.cu"


@lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile the chain kernel (once per source content) and load it."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    out = kernels.BUILD_DIR / f"encode_chain_probe_{digest}.so"
    if not out.exists():
        kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", str(_SRC), "-o", str(out)],
                       check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.probe_encode_chain.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_void_p]
    lib.probe_encode_chain.restype = ctypes.c_int
    return lib


def chain(M: int, K: int, states: torch.Tensor) -> None:
    """Launch the chain over M steps on K lanes; ``states`` is a (K,) int32
    tensor on the card, written with states that are not K1's."""
    if states.device.type != "cuda" or states.dtype != torch.int32 or states.numel() < K:
        raise ValueError("states must be a CUDA int32 tensor of at least K entries")
    stream = torch.cuda.current_stream(states.device).cuda_stream
    kernels.check(build().probe_encode_chain(M, K, states.data_ptr(), stream),
                  "probe_encode_chain")
