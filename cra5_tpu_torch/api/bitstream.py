""".bin container framing of the CRA5 archives (docs/FORMATS.md §1).

Counterpart of ``cra5_tpu/api/bitstream.py``, byte for byte: a big-endian
uint32 header (H, W, n_strings), then per string a big-endian uint32
length and the raw bytes. The parse is validated: truncation and lengths
that overrun the file raise ``ValueError``.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import BinaryIO, List, Sequence, Tuple


def filesize(filepath: str) -> int:
    p = Path(filepath)
    if not p.is_file():
        raise ValueError(f'Invalid file "{filepath}"')
    return p.stat().st_size


def write_uints(fd: BinaryIO, values: Sequence[int]) -> int:
    fd.write(struct.pack(f">{len(values)}I", *values))
    return len(values) * 4


def write_bytes(fd: BinaryIO, values: bytes) -> int:
    if len(values) == 0:
        return 0
    fd.write(values)
    return len(values)


def read_uints(fd: BinaryIO, n: int) -> Tuple[int, ...]:
    buf = fd.read(n * 4)
    if len(buf) != n * 4:
        raise ValueError(
            f"truncated .bin container: wanted {n * 4} header bytes, got {len(buf)}"
        )
    return struct.unpack(f">{n}I", buf)


def read_bytes(fd: BinaryIO, n: int) -> bytes:
    buf = fd.read(n)
    if len(buf) != n:
        raise ValueError(
            f"truncated .bin container: stream declares {n} bytes, got {len(buf)}"
        )
    return buf


def save_bin(path: str, strings: Sequence[Sequence[bytes]], z_shape: Tuple[int, int]) -> int:
    """Write the v1 container: header (H, W, n_strings), then per-stream
    (len, bytes). ``strings`` follows the archive nesting
    [[y_bytes], [z_bytes]] (batch size 1 per file)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    total = 0
    with open(path, "wb") as f:
        total += write_uints(f, (int(z_shape[0]), int(z_shape[1]), len(strings)))
        for s in strings:
            payload = s[0] if isinstance(s, (list, tuple)) else s
            total += write_uints(f, (len(payload),))
            total += write_bytes(f, payload)
    return total


def load_bin(path: str) -> Tuple[List[List[bytes]], Tuple[int, int]]:
    """Read a v1 container -> (strings [[y],[z]], z_shape).

    Validated parse: header/stream truncation and length fields that
    overrun the file raise ValueError instead of propagating struct
    errors or silently returning short streams (the native decoders
    downstream trust these lengths)."""
    size = filesize(path)
    with open(path, "rb") as f:
        h, w, n_strings = read_uints(f, 3)
        if n_strings > (size - 12) // 4 + 1:
            raise ValueError(
                f".bin header declares {n_strings} streams but the file has "
                f"only {size} bytes"
            )
        strings: List[List[bytes]] = []
        for _ in range(n_strings):
            (ln,) = read_uints(f, 1)
            if ln > size:
                raise ValueError(
                    f".bin stream length {ln} exceeds file size {size}"
                )
            strings.append([read_bytes(f, ln)])
    return strings, (h, w)
