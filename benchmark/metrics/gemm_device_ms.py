"""gemm_device_ms: device time a timestep of the dense matrix products
(cuBLAS and CUTLASS GEMM kernels), picked by the kernel-name patterns in
``gemm_device_ms.json``."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("_per_timestep", Path(__file__).with_name("_per_timestep.py"))
_pt = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_pt)
PATTERNS = _pt.patterns("gemm_device_ms")


def read(run):
    return _pt.device_ms(run, lambda op: any(p.search(op.name) for p in PATTERNS))
