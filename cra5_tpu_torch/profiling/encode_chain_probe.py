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
from functools import lru_cache
from pathlib import Path

import torch

from .. import kernels

_SRC = Path(__file__).resolve().parent / "csrc" / "encode_chain_probe.cu"


@lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile the chain kernel (once per source content) and load it."""
    lib = ctypes.CDLL(str(kernels.build_single(_SRC)))
    lib.probe_encode_chain.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_void_p]
    lib.probe_encode_chain.restype = ctypes.c_int
    return lib


def chain(M: int, K: int, states: torch.Tensor) -> None:
    """Launch the chain over M steps on K lanes; ``states`` is a (K,) int32
    tensor on the card, written with states that are not K1's."""
    if states.device.type != "cuda" or states.dtype != torch.int32 or states.numel() < K:
        raise ValueError("states must be a CUDA int32 tensor of at least K entries")
    stream = kernels.raw_stream(states.get_device())
    kernels.check(build().probe_encode_chain(M, K, states.data_ptr(), stream),
                  "probe_encode_chain")
