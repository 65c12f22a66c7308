"""The floor under a launch-bound kernel: an empty kernel.

``profiling/csrc/launch_floor.cu`` holds a kernel that does nothing, on one
warp. ``empty(index)`` launches it through the same path as the K7 and K8
wrappers (``kernels.raw_stream``, a C function bound once, ``check``), so
its device time is the least one launch takes on the card and its time a
call is what that launch path costs on the host. ``call_forms`` gives the same
launch behind K8's argument list in the ways ctypes can make it, and the
arguments without a launch, to split a call's host time. ``chip_smoke.py``
prints them beside K7 and K8. The source is built here with ``nvcc`` into
``build/cra5_tpu_torch/``, apart from the kernel library; no path of the
port runs it.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from pathlib import Path
from typing import Callable, Dict

from .. import kernels

_SRC = Path(__file__).resolve().parent / "csrc" / "launch_floor.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int


@lru_cache(maxsize=None)
def load(loader=ctypes.CDLL) -> ctypes.CDLL:
    """The probe's library through ``loader`` (``ctypes.CDLL`` releases the
    GIL around a call, ``ctypes.PyDLL`` keeps it)."""
    lib = loader(str(kernels.build_single(_SRC)))
    for name, argtypes in (("probe_empty_launch", [_P]),
                           ("probe_empty_launch6", [_P, _P, _P, _I, _I, _P]),
                           ("probe_no_launch6", [_P, _P, _P, _I, _I, _P]),
                           ("probe_empty_launch_packed", None)):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def empty(device_index: int) -> None:
    """Launch the empty kernel on the caller's current stream of the card
    ``device_index``."""
    kernels.check(load().probe_empty_launch(kernels.raw_stream(device_index)),
                  "probe_empty_launch")


def call_forms(device_index: int, ptrs) -> Dict[str, Callable[[], int]]:
    """Zero-argument calls that launch the empty kernel (or, for
    ``no launch``, only pass the arguments) behind K8's argument list: the
    three pointers ``ptrs``, (8, 1024) and the current stream."""
    cdll, pydll = load(), load(ctypes.PyDLL)
    packed = (ctypes.c_longlong * 6)()
    a, b, c = ptrs
    stream = kernels.raw_stream

    def pack():
        packed[:] = (a, b, c, 8, 1024, stream(device_index))
        return pydll.probe_empty_launch_packed(packed)

    return {
        "6 args, CDLL": lambda: cdll.probe_empty_launch6(a, b, c, 8, 1024, stream(device_index)),
        "6 args, PyDLL": lambda: pydll.probe_empty_launch6(a, b, c, 8, 1024, stream(device_index)),
        "6 args packed, PyDLL": pack,
        "6 args, no launch, CDLL": lambda: cdll.probe_no_launch6(a, b, c, 8, 1024,
                                                                stream(device_index)),
        "1 arg, CDLL": lambda: cdll.probe_empty_launch(stream(device_index)),
    }
