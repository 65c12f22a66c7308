"""Build and load the port's CUDA kernels; count their launches.

The sources in ``csrc/`` expose a plain C interface. At first use they are
compiled for Hopper (``sm_90a``) by ``nvcc``, one process per source, all
started together, then linked into one shared library under
``build/cra5_tpu_torch/`` at the root of the checkout and loaded with
``ctypes``. Pointers and the CUDA stream cross as ``c_void_p``; every C entry
returns ``cudaGetLastError()`` and ``check`` raises on anything but 0.
Nothing is compiled at import time, and nothing here falls back: a missing
``nvcc`` or a failed build raises.

The launch path of a short kernel is mostly host time, so it is kept
lean: ``raw_stream(index)`` gives the caller's current stream as the raw
handle without building a ``torch.cuda.Stream`` per call, and ``lib()``
binds each C function once (its argument types set at load, the function
object kept on the library), so a wrapper calls
``kernels.lib().<entry>(...)`` and ``check``s the status.

Each kernel wrapper carries an integer ``launches`` attribute that it
increments through ``count`` where, and only where, it launches its
kernel; ``count`` holds a lock, so wrappers called from several threads
(each on its own stream) lose no launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List

import torch

_SRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "cra5_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _U, _LL, _F, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong,
                           ctypes.c_float, ctypes.c_double)
_SIGNATURES = {
    "cra5_rans_encode": [_P, _P, _I, _I, _P, _P, _P, _P],
    "cra5_rans_decode": [_I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I,
                         _I, _I, _I, _I, _P, _P, _P, _P],
    "cra5_container_write": [_P, _P, _P, _P, _U, _U, _I, _LL, _LL, _P, _LL, _P, _P],
    "cra5_container_read": [_P, _LL, _I, _LL, _LL, _P, _LL, _P, _P, _P, _P],
    "cra5_container_write_tiles": [_LL],
    "cra5_container_read_tiles": [_LL, _LL, _LL],
    "cra5_flash_attn_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "cra5_flash_attn_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "cra5_flash_attn_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "cra5_flash_attn_fwd_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "cra5_flash_attn_bwd_dq_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "cra5_flash_attn_bwd_dkv_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "cra5_flash_attn_fwd_any": [_P, _P, _P, _P, _P, _I, _I, _I, _D, _I, _P],
    "cra5_flash_attn_bwd_dq_any": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _D, _I, _P],
    "cra5_flash_attn_bwd_dkv_any": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _D, _I, _P],
    "cra5_flash_attn_fwd_anydim": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    "cra5_flash_attn_bwd_dkv_anydim": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    "cra5_flash_attn_bwd_dq_anydim": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    "cra5_perm_expand": [_P, _P, _P, _I, _I, _I, _P],
    "cra5_perm_dynroll": [_P, _P, _P, _I, _I, _P],
}

_RESTYPES = {"cra5_container_write_tiles": _LL, "cra5_container_read_tiles": _LL}  # else int

_lib = None
build_info: Dict[str, object] = {}
_wrappers: List[Callable] = []
_count_lock = threading.Lock()


def counted(fn: Callable) -> Callable:
    """Register a kernel wrapper and give it a ``launches`` counter."""
    fn.launches = 0
    _wrappers.append(fn)
    return fn


def count(fn: Callable) -> None:
    """One launch of ``fn``'s kernel."""
    with _count_lock:
        fn.launches += 1


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


def build_single(src: Path, deps=()) -> Path:
    """Compile one source apart from the kernel library (a profiling
    probe) into its own shared library, once per content of it and its
    ``deps``, with the kernels' flags; returns its path."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in (src, *deps):
        digest.update(p.read_bytes())
    out = BUILD_DIR / f"{src.stem}_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", str(src), "-o", str(tmp)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src.name}:\n{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = _RESTYPES.get(name, _I)
        _lib = handle
    return _lib


def check(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")


def _no_cuda(index: int) -> int:
    raise RuntimeError("this PyTorch build has no CUDA: there is no stream to launch on")


# raw_stream(device_index) -> int: the cudaStream_t of the caller's current
# stream on that device, the handle torch.cuda.current_stream(index)
# .cuda_stream gives (so a launch under ``with torch.cuda.stream(s):`` runs
# on s), without constructing a Stream object, which enters and leaves a
# device context on every call.
raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", _no_cuda)
