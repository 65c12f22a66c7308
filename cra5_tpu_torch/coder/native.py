"""ctypes binding to the host rANS64 coder (``csrc/rans64.cpp``): the serial
coder of the published CRA5 archives ("v1").

Counterpart of ``cra5_tpu/coder/native.py``, bitstream-identical to it and
to the pure-Python oracle ``rans_py``. The shared library is built at first
use by ``g++ -O3 -std=c++17 -shared -fPIC`` into ``build/cra5_tpu_torch/``
at the root of the checkout, named by a hash of the source and flags, and
never next to the source. Nothing falls back: a missing ``g++`` or a failed
build raises, and no code path runs ``rans_py``.

Buffers cross as flat numpy int32 arrays, not per-symbol Python lists.
Invalid CDF tables and out-of-range indexes raise ``ValueError``.
``pmf_to_quantized_cdf_native`` builds a quantized CDF in C; where the JAX
package computes it in Python when its library is missing, the port raises
as its coder does, and ``native_available`` says beforehand whether the
library builds here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "csrc" / "rans64.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cra5_tpu_torch"
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build() -> Path:
    """Compile the coder once per source content; returns the library."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"librans64_{digest}.so"
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the v1 host coder is built at first use with g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([gxx, *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {_SRC.name}:\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded coder library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            i32p, u8p, sz = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t
            sigs = {
                "rans_encode_with_indexes": (ctypes.c_longlong,
                                             [i32p, i32p, sz, i32p, i32p, i32p, sz, sz, u8p, sz]),
                "rans_decode_with_indexes": (ctypes.c_int,
                                             [u8p, sz, i32p, sz, i32p, i32p, i32p, sz, sz, i32p]),
                "rans_stream_new": (ctypes.c_void_p, [u8p, sz]),
                "rans_stream_decode": (ctypes.c_int,
                                       [ctypes.c_void_p, i32p, sz, i32p, i32p, i32p, sz, sz, i32p]),
                "rans_stream_free": (None, [ctypes.c_void_p]),
                "rans_validate_cdfs": (ctypes.c_int, [i32p, i32p, sz, sz]),
                "zz_varint_encode": (ctypes.c_longlong, [i32p, sz, u8p, sz]),
                "zz_varint_decode": (ctypes.c_longlong, [u8p, sz, sz, i32p]),
                "pmf_to_quantized_cdf_c": (ctypes.c_int, [ctypes.POINTER(ctypes.c_float), sz,
                                                          ctypes.c_int, i32p]),
            }
            for name, (restype, argtypes) in sigs.items():
                fn = getattr(handle, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = handle
    return _lib


def native_available() -> bool:
    """Whether the host coder's library builds and loads here (``g++``)."""
    try:
        lib()
    except (RuntimeError, OSError):
        return False
    return True


def _as_i32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a).reshape(-1), dtype=np.int32)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _prep_cdfs(cdfs, cdf_sizes) -> Tuple[np.ndarray, np.ndarray]:
    """A (rows, stride) int32 table from a 2-D array or ragged rows."""
    if isinstance(cdfs, np.ndarray) and cdfs.ndim == 2:
        table = np.ascontiguousarray(cdfs, dtype=np.int32)
    else:
        table = np.zeros((len(cdfs), max(len(row) for row in cdfs)), dtype=np.int32)
        for i, row in enumerate(cdfs):
            table[i, : len(row)] = row
    return table, _as_i32(cdf_sizes)


def encode_with_indexes(symbols, indexes, cdfs, cdf_sizes, offsets) -> bytes:
    """Encode int32 symbols against CDF rows ``indexes``: the v1 stream."""
    sym, idx, offs = _as_i32(symbols), _as_i32(indexes), _as_i32(offsets)
    table, sizes = _prep_cdfs(cdfs, cdf_sizes)
    n = sym.size
    if idx.size != n:
        raise ValueError(f"symbol count {n} != index count {idx.size}")
    cap = 4 * (5 * n + 8) + 64
    out = np.empty(cap, dtype=np.uint8)
    nbytes = lib().rans_encode_with_indexes(
        _ptr(sym, ctypes.c_int32), _ptr(idx, ctypes.c_int32), n,
        _ptr(table, ctypes.c_int32), _ptr(sizes, ctypes.c_int32), _ptr(offs, ctypes.c_int32),
        table.shape[0], table.shape[1], _ptr(out, ctypes.c_uint8), cap)
    if nbytes == -2:
        raise ValueError("rans_encode_with_indexes: invalid CDF table")
    if nbytes == -3:
        raise ValueError("rans_encode_with_indexes: cdf index out of range")
    if nbytes < 0:
        raise RuntimeError("rans_encode_with_indexes: output buffer overflow")
    return out[:nbytes].tobytes()


def decode_with_indexes(encoded: bytes, indexes, cdfs, cdf_sizes, offsets) -> np.ndarray:
    """Decode a v1 stream to int32 symbols shaped like ``indexes``."""
    shape = np.shape(indexes)
    idx, offs = _as_i32(indexes), _as_i32(offsets)
    table, sizes = _prep_cdfs(cdfs, cdf_sizes)
    out = np.empty(idx.size, dtype=np.int32)
    buf = np.frombuffer(encoded, dtype=np.uint8)
    rc = lib().rans_decode_with_indexes(
        _ptr(buf, ctypes.c_uint8), buf.size, _ptr(idx, ctypes.c_int32), idx.size,
        _ptr(table, ctypes.c_int32), _ptr(sizes, ctypes.c_int32), _ptr(offs, ctypes.c_int32),
        table.shape[0], table.shape[1], _ptr(out, ctypes.c_int32))
    if rc == -2:
        raise ValueError("rans_decode_with_indexes: invalid CDF table")
    if rc == -3:
        raise ValueError("rans_decode_with_indexes: cdf index out of range")
    if rc != 0:
        raise ValueError("rans_decode_with_indexes: malformed stream")
    return out.reshape(shape)


class StreamingDecoder:
    """A v1 stream decoded in pieces, for autoregressive codecs: each
    ``decode`` call continues where the last one stopped."""

    def __init__(self, encoded: bytes):
        self._lib = lib()
        self._buf = np.frombuffer(encoded, dtype=np.uint8)  # kept alive
        self._handle = self._lib.rans_stream_new(_ptr(self._buf, ctypes.c_uint8), self._buf.size)
        if not self._handle:
            raise ValueError("malformed stream")
        self._validated = set()

    def decode(self, indexes, cdfs, cdf_sizes, offsets) -> np.ndarray:
        shape = np.shape(indexes)
        idx, offs = _as_i32(indexes), _as_i32(offsets)
        table, sizes = _prep_cdfs(cdfs, cdf_sizes)
        key = (table.ctypes.data, table.shape)  # validate each table once
        if key not in self._validated:
            if self._lib.rans_validate_cdfs(_ptr(table, ctypes.c_int32),
                                            _ptr(sizes, ctypes.c_int32), *table.shape) != 0:
                raise ValueError("stream decode: invalid CDF table")
            self._validated.add(key)
        out = np.empty(idx.size, dtype=np.int32)
        rc = self._lib.rans_stream_decode(
            self._handle, _ptr(idx, ctypes.c_int32), idx.size, _ptr(table, ctypes.c_int32),
            _ptr(sizes, ctypes.c_int32), _ptr(offs, ctypes.c_int32), table.shape[0],
            table.shape[1], _ptr(out, ctypes.c_int32))
        if rc == -3:
            raise ValueError("stream decode: cdf index out of range")
        if rc != 0:
            raise ValueError("stream decode failed")
        return out.reshape(shape)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.rans_stream_free(self._handle)
            self._handle = None


def zigzag_varint_encode(values) -> bytes:
    """Zigzag-LEB128 varints of int32 values (the v2 escape channel)."""
    vals = _as_i32(values)
    cap = 5 * vals.size + 8
    out = np.empty(cap, dtype=np.uint8)
    nbytes = lib().zz_varint_encode(_ptr(vals, ctypes.c_int32), vals.size,
                                    _ptr(out, ctypes.c_uint8), cap)
    if nbytes < 0:
        raise RuntimeError("zz_varint_encode: output buffer overflow")
    return out[:nbytes].tobytes()


def zigzag_varint_decode(data: bytes, count: int) -> np.ndarray:
    """``count`` int32 values from zigzag-LEB128 varints."""
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(count, dtype=np.int32)
    if lib().zz_varint_decode(_ptr(buf, ctypes.c_uint8), buf.size, count,
                              _ptr(out, ctypes.c_int32)) < 0:
        raise ValueError("truncated escape side channel")
    return out


def pmf_to_quantized_cdf_native(pmf, precision: int = 16) -> np.ndarray:
    """The quantized CDF of ``pmf`` (length + 1 int32 entries) built in C,
    equal to ``entropy.cdf.pmf_to_quantized_cdf``. Raises ``RuntimeError``
    when the library does not build (no Python fallback) and ``ValueError``
    on an invalid pmf."""
    pmf32 = np.ascontiguousarray(pmf, dtype=np.float32).reshape(-1)
    out = np.empty(pmf32.size + 1, dtype=np.int32)
    if lib().pmf_to_quantized_cdf_c(_ptr(pmf32, ctypes.c_float), pmf32.size, precision,
                                    _ptr(out, ctypes.c_int32)) != 0:
        raise ValueError("invalid pmf")
    return out
