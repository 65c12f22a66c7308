"""A msgpack reader and writer for the files ``flax.serialization`` writes.

The JAX package stores its single-file checkpoints with
``flax.serialization.to_bytes`` / ``msgpack_restore`` (``.msgpack`` files).
The card's machine has neither flax nor the ``msgpack`` package, so the
port carries its own codec, in pure Python, for the subset those files
use:

  - maps (keys in the order given; str keys), str, int, float, bool, nil,
    bin, and arrays (lists; tuples too inside an ndarray's header);
  - flax's ext types: 1 an ndarray, itself a msgpack of
    ``(shape, dtype name, C-order bytes)``; 2 a native complex, a msgpack
    of ``(real, imag)``; 3 a numpy scalar, stored as a 0-d ndarray;
  - flax's chunked form of an array leaf larger than ``MAX_CHUNK_SIZE``
    bytes: ``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...},
    "chunks": {"0": flat0, ...}}``.

``dumps(tree)`` gives the bytes of ``flax.serialization.to_bytes(tree)``
for a tree of dicts, lists and tuples with numpy leaves (the writer follows msgpack's
``packb(..., strict_types=True)`` and flax's ext hook byte for byte);
``loads(data)`` gives what ``flax.serialization.msgpack_restore`` gives.
A leaf may also be a torch tensor: it is written as the ndarray of its
values (a bfloat16 tensor under dtype name ``bfloat16``, as JAX writes
one), and a ``bfloat16`` ndarray is read back as a torch tensor, since
numpy has no such dtype.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


# ------------------------------------------------------------------ writer
def _pack_int(out: List[bytes], v: int) -> None:
    if v < -(1 << 5):
        if v < -(1 << 15):
            if v < -(1 << 31):
                if v < -(1 << 63):
                    raise OverflowError(f"int {v} does not fit in 64 bits")
                out.append(b"\xd3" + struct.pack(">q", v))
            else:
                out.append(b"\xd2" + struct.pack(">i", v))
        elif v < -(1 << 7):
            out.append(b"\xd1" + struct.pack(">h", v))
        else:
            out.append(b"\xd0" + struct.pack(">b", v))
    elif v < (1 << 7):
        out.append(struct.pack(">b", v) if v < 0 else bytes((v,)))
    elif v < (1 << 16):
        out.append(b"\xcc" + bytes((v,)) if v < (1 << 8) else b"\xcd" + struct.pack(">H", v))
    elif v < (1 << 32):
        out.append(b"\xce" + struct.pack(">I", v))
    elif v < (1 << 64):
        out.append(b"\xcf" + struct.pack(">Q", v))
    else:
        raise OverflowError(f"int {v} does not fit in 64 bits")


def _pack_len(out: List[bytes], n: int, fix: Tuple[int, int], codes: Tuple[int, ...]) -> None:
    """A length header: the fix form below fix[1], else 8 (when codes has
    three entries), 16 or 32 bits."""
    if n < fix[1]:
        out.append(bytes((fix[0] | n,)))
        return
    sizes = ((1 << 8, ">B"), (1 << 16, ">H"), (1 << 32, ">I"))[3 - len(codes):]
    for code, (limit, fmt) in zip(codes, sizes):
        if n < limit:
            out.append(bytes((code,)) + struct.pack(fmt, n))
            return
    raise ValueError(f"length {n} does not fit in msgpack")


def _pack_bin(out: List[bytes], b: bytes) -> None:
    n = len(b)
    for code, limit, fmt in ((0xC4, 1 << 8, ">B"), (0xC5, 1 << 16, ">H"), (0xC6, 1 << 32, ">I")):
        if n < limit:
            out.append(bytes((code,)) + struct.pack(fmt, n))
            out.append(bytes(b))
            return
    raise ValueError(f"bin of {n} bytes does not fit in msgpack")


def _pack_ext(out: List[bytes], code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(bytes((fixed[n], code)))
    elif n < (1 << 8):
        out.append(bytes((0xC7, n, code)))
    elif n < (1 << 16):
        out.append(b"\xc8" + struct.pack(">H", n) + bytes((code,)))
    else:
        out.append(b"\xc9" + struct.pack(">I", n) + bytes((code,)))
    out.append(data)


def _array_header(arr) -> Tuple[Tuple[int, ...], str, bytes]:
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()
        arr = t.numpy()
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    return tuple(arr.shape), arr.dtype.name, arr.tobytes("C")


def _pack(out: List[bytes], o: Any, strict: bool) -> None:
    """msgpack's Packer._pack with use_bin_type=True, and flax's
    ``_msgpack_ext_pack`` as its default hook."""
    if o is None:
        out.append(b"\xc0")
    elif o is True:
        out.append(b"\xc3")
    elif o is False:
        out.append(b"\xc2")
    elif type(o) is int or (not strict and isinstance(o, int)):
        _pack_int(out, int(o))
    elif type(o) is float or (not strict and isinstance(o, float)):
        out.append(b"\xcb" + struct.pack(">d", o))
    elif type(o) in (bytes, bytearray):
        _pack_bin(out, o)
    elif type(o) is str:
        b = o.encode("utf-8")
        _pack_len(out, len(b), (0xA0, 32), (0xD9, 0xDA, 0xDB))
        out.append(b)
    elif type(o) is dict:
        _pack_len(out, len(o), (0x80, 16), (0xDE, 0xDF))
        for k, v in o.items():
            _pack(out, k, strict)
            _pack(out, v, strict)
    elif type(o) is list or (not strict and type(o) is tuple):
        _pack_len(out, len(o), (0x90, 16), (0xDC, 0xDD))
        for v in o:
            _pack(out, v, strict)
    elif isinstance(o, (np.ndarray, torch.Tensor)):
        _pack_ext(out, EXT_NDARRAY, _packb_plain(_array_header(o)))
    elif isinstance(o, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _packb_plain(_array_header(np.asarray(o))))
    elif type(o) is complex:
        _pack_ext(out, EXT_COMPLEX, _packb_plain((o.real, o.imag)))
    else:
        raise TypeError(f"can not serialize {type(o).__name__!r} object")


def _packb_plain(o: Any) -> bytes:
    """msgpack.packb(o, use_bin_type=True): tuples as arrays."""
    out: List[bytes] = []
    _pack(out, o, strict=False)
    return b"".join(out)


def packb(o: Any) -> bytes:
    """msgpack.packb(o, default=flax's ext hook, strict_types=True)."""
    out: List[bytes] = []
    _pack(out, o, strict=True)
    return b"".join(out)


def _chunk(arr) -> Dict[str, Any]:
    itemsize = arr.element_size() if isinstance(arr, torch.Tensor) else arr.dtype.itemsize
    chunksize = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = arr.reshape(-1)
    n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
    return {_CHUNKED: True, "shape": {str(i): int(s) for i, s in enumerate(arr.shape)},
            "chunks": {str(j): flat[i:i + chunksize]
                       for j, i in enumerate(range(0, n, chunksize))}}


def _nbytes(arr) -> int:
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return arr.size * arr.dtype.itemsize


def _state_dict(tree: Any) -> Any:
    """flax's to_state_dict (lists and tuples become dicts keyed "0",
    "1", ...; keys become str) followed by its
    _chunk_array_leaves_in_place, on copies of the containers."""
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        return {str(k): (_chunk(v) if isinstance(v, (np.ndarray, torch.Tensor))
                         and _nbytes(v) > MAX_CHUNK_SIZE else _state_dict(v))
                for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, torch.Tensor)) and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def dumps(tree: Any) -> bytes:
    """The bytes ``flax.serialization.to_bytes(tree)`` writes for a tree of
    dicts (str keys, in their given order) with array and scalar leaves."""
    return packb(_state_dict(tree))


# ------------------------------------------------------------------ reader
class _Reader:
    def __init__(self, data: bytes, raw: bool, ext: bool):
        self.buf, self.pos, self.raw, self.ext = memoryview(data), 0, raw, ext

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def obj(self) -> Any:
        c = self.take(1)[0]
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.obj() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.str(c & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in fixed:
            return fixed[c]
        ints = {0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
                0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
                0xCA: (">f", 4), 0xCB: (">d", 8)}
        if c in ints:
            return self.unpack(*ints[c])
        lens = {0xC4: 1, 0xC5: 2, 0xC6: 4, 0xD9: 1, 0xDA: 2, 0xDB: 4, 0xDC: 2, 0xDD: 4,
                0xDE: 2, 0xDF: 4, 0xC7: 1, 0xC8: 2, 0xC9: 4}
        fmt = {1: ">B", 2: ">H", 4: ">I"}
        if c in lens:
            n = self.unpack(fmt[lens[c]], lens[c])
            if c <= 0xC6:
                return bytes(self.take(n))
            if c <= 0xC9:
                return self.ext_obj(n)
            if c <= 0xDB:
                return self.str(n)
            if c <= 0xDD:
                return [self.obj() for _ in range(n)]
            return self.map(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if c in fixext:
            return self.ext_obj(fixext[c])
        raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")

    def str(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.obj()
            if not isinstance(k, (str, bytes)):
                raise ValueError(f"map key {k!r} is not str or bytes")
            out[k] = self.obj()
        return out

    def ext_obj(self, n: int) -> Any:
        code = self.take(1)[0]
        data = bytes(self.take(n))
        if not self.ext:
            raise ValueError(f"ext type {code} inside an ext payload")
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            arr = _array_from_bytes(data)
            return arr[()] if code == EXT_NPSCALAR and isinstance(arr, np.ndarray) else arr
        if code == EXT_COMPLEX:
            re_, im = _Reader(data, raw=False, ext=False).obj()
            return complex(re_, im)
        raise ValueError(f"unknown ext type {code}")


def _array_from_bytes(data: bytes):
    shape, dtype_name, buf = _Reader(data, raw=True, ext=False).obj()
    shape = tuple(int(s) for s in shape)
    if dtype_name == b"bfloat16":
        t = torch.frombuffer(bytearray(buf), dtype=torch.int16) if buf else torch.empty(0, dtype=torch.int16)
        return t.view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name.decode())).reshape(shape, order="C")


def unpackb(data: bytes) -> Any:
    """msgpack.unpackb(data, ext_hook=flax's, raw=False)."""
    r = _Reader(data, raw=False, ext=True)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes of extra data after the msgpack object")
    return out


def _unchunk(d: Dict[str, Any]):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(tree: Any) -> Any:
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            return _unchunk(tree)
        return {k: _unchunk_leaves(v) for k, v in tree.items()}
    return tree


def loads(data: bytes) -> Any:
    """What ``flax.serialization.msgpack_restore(data)`` returns: nested
    dicts and lists with numpy leaves (torch for bfloat16)."""
    return _unchunk_leaves(unpackb(data))
