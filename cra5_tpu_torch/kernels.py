"""Build and load the port's CUDA kernels; count their launches.

The sources in ``csrc/`` expose a plain C interface. At first use they are
compiled for Hopper (``sm_90a``) by ``nvcc``, one process per source, all
started together, then linked into one shared library under
``build/cra5_tpu_torch/`` at the root of the checkout and loaded with
``ctypes``. Pointers and the CUDA stream cross as ``c_void_p``; every C entry
returns ``cudaGetLastError()`` and ``check`` raises on anything but 0.
Nothing is compiled at import time, and nothing here falls back: a missing
``nvcc`` or a failed build raises.

Each kernel wrapper carries an integer ``launches`` attribute that it
increments where, and only where, it launches its kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List

_SRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "cra5_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "cra5_rans_encode": [_P, _P, _I, _I, _P, _P, _P, _P],
    "cra5_rans_decode_lanes": [_P, _I, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _P, _P, _P],
    "cra5_rans_decode_sorted": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _P, _P, _P],
    "cra5_flash_attn_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "cra5_flash_attn_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "cra5_flash_attn_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "cra5_flash_attn_fwd_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "cra5_flash_attn_bwd_dq_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "cra5_flash_attn_bwd_dkv_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "cra5_perm_expand": [_P, _P, _P, _I, _P],
    "cra5_perm_dynroll": [_P, _P, _P, _I, _I, _P],
}

_lib = None
build_info: Dict[str, object] = {}
_wrappers: List[Callable] = []


def counted(fn: Callable) -> Callable:
    """Register a kernel wrapper and give it a ``launches`` counter."""
    fn.launches = 0
    _wrappers.append(fn)
    return fn


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in _wrappers}


def reset_launch_counts() -> None:
    for fn in _wrappers:
        fn.launches = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        shutil.which("nvcc"),
        os.path.join(home, "bin", "nvcc") if home else None,
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first use with nvcc")


def _sources() -> List[Path]:
    return sorted(_SRC.glob("*.cu"))


def build() -> Path:
    """Compile the kernels (once per source content) and return the
    library's path. Fills ``build_info`` with the build seconds and each
    source's ``-Xptxas -v`` report."""
    srcs = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(_SRC.iterdir()):
        digest.update(p.name.encode() + p.read_bytes())
    out = BUILD_DIR / f"libcra5_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        build_info.setdefault("seconds", 0.0)
        build_info.setdefault("cached", True)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    jobs = []
    for src in srcs:
        obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    reports, failed = {}, []
    for src, obj, proc in jobs:
        so, se = proc.communicate()
        reports[src.name] = (so + se).strip()
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        detail = "\n".join(f"--- {n}\n{reports[n]}" for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{detail}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
         *[str(o) for _, o, _ in jobs], "-o", str(tmp)],
        capture_output=True, text=True,
    )
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, out)
    build_info.update(seconds=time.time() - t0, cached=False, ptxas=reports, path=str(out))
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")
