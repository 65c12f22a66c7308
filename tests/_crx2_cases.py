"""CRX2 (format v2) containers shared by the container tests on the CPU
(tests/test_torch_container.py) and on the card (tests/test_torch_cuda.py):
the host arrays a container is packed from, at the edges of the layout and
of the escape varints, and the malformed streams every decoder refuses.
numpy and the port only: the card's test file imports no JAX."""

import struct

import numpy as np

from cra5_tpu_torch.coder.lane_coder import LaneCoder, container_arrays, parse_v2_header
from cra5_tpu_torch.coder.rans_kernels import container_layout

# zigzag values at each edge of the varint lengths 1-5 (u < 2**7, 2**14,
# 2**21, 2**28, 2**32): both signs, and int32's ends
VARINT_EDGES = np.array(
    [0, -1, 63, -64, 64, -65, 8191, -8192, 8192, -8193, (1 << 20) - 1, -(1 << 20), 1 << 20,
     -(1 << 20) - 1, (1 << 27) - 1, -(1 << 27), 1 << 27, -(1 << 27) - 1, (1 << 31) - 1,
     -(1 << 31)], np.int32)

# (name, K, words, escapes, sorted, safe, escape kind)
LAYOUT_CASES = [
    ("no_escapes", 300, 1001, 0, False, False, "small"),
    ("every_varint_length", 64, 500, 200, True, True, "edges"),
    ("one_lane", 1, 7, 3, False, False, "small"),
    ("no_words", 16, 0, 5, False, False, "edges"),
    ("no_words_no_escapes", 1, 0, 0, False, False, "small"),
    ("odd_words", 33, 999, 50, False, False, "small"),
    ("sorted_unsafe", 128, 640, 40, True, False, "small"),
    ("sorted_safe", 2048, 4096, 90, True, True, "small"),
    ("unsorted_verdict_ignored", 256, 300, 12, False, True, "edges"),
    ("tiles_of_escapes", 8192, 20001, 30000, True, True, "mixed"),
]

# the main path's streams, for the card: the 268v y (8192 lanes, ~1.29 M
# words, ~10^5 escapes), y at 16 384 lanes, the 268v z and a small image
# codec's stream
CARD_CASES = [
    ("268v_y", 8192, 1_290_001, 100_000, True, True, "mixed"),
    ("y_16384_lanes", 16384, 2_500_000, 100_000, True, False, "mixed"),
    ("268v_z", 256, 24_411, 310, False, False, "small"),
    ("image_codec", 32, 301, 4, False, False, "small"),
]


def escapes(rng, ne: int, kind: str) -> np.ndarray:
    """``ne`` escape values: ``small`` ones (1-2 byte varints, as the
    coder's out-of-range symbols), the varint ``edges`` repeated, or a
    ``mixed`` draw of both with uniform int32s."""
    if kind == "edges":
        return rng.permutation(np.resize(VARINT_EDGES, ne))
    small = rng.integers(50, 3000, ne) * rng.choice([-1, 1], ne)
    if kind == "mixed":
        pick = rng.random(ne)
        small = np.where(pick < 0.05, rng.integers(-(1 << 31), 1 << 31, ne), small)
        small = np.where(pick > 0.999, np.resize(VARINT_EDGES, ne), small)
    return small.astype(np.int32)


def arrays(rng, K, nw, ne, kind):
    """(states u32 (K,), words u16 (nw,), escapes int32 (ne,))."""
    states = rng.integers(1 << 16, 1 << 32, K, dtype=np.uint64).astype(np.uint32)
    words = rng.integers(0, 1 << 16, nw).astype(np.uint16)
    return states, words, escapes(rng, ne, kind)


def escape_region(rng, kind: str, ne: int) -> bytes:
    """Escape varint regions a decoder must read as numpy's decoder does:
    ``random`` bytes; ``overlong``: varints of 1-9 bytes, of which a
    decoder reads at most the first 5; ``trailing`` bytes after the
    n_esc-th varint.
    Each holds at least ``ne`` bytes with bit 7 clear."""
    if kind == "random":
        body = rng.integers(0, 256, 4 * ne + 64).astype(np.uint8)
        body[rng.choice(body.size, ne, replace=False)] &= 0x7F
        return body.tobytes()
    if kind == "overlong":
        out = bytearray()
        for _ in range(ne):
            length = int(rng.integers(1, 10))
            v = rng.integers(0, 256, length).astype(np.uint8)
            v[:-1] |= 0x80
            v[-1] &= 0x7F
            out += v.tobytes()
        return bytes(out)
    assert kind == "trailing"
    return escape_region(rng, "overlong", ne) + rng.integers(0, 256, 37).astype(np.uint8).tobytes()


def with_region(K: int, words: np.ndarray, ne: int, region: bytes) -> bytes:
    """A container of K zero states, ``words`` and a raw escape region."""
    return (struct.pack("<IIIII", 0x32585243, 1 << 20, K, ne, words.size)
            + np.zeros(K, "<u4").tobytes() + words.astype("<u2").tobytes() + region)


def malformed_streams(data: bytes):
    """(name, stream, symbol count the decoder is given or None, message
    pattern) of each malformed variant of a valid stream ``data`` that
    ``LaneCoder.upload_batch`` refuses with a ValueError."""
    n, K, n_esc, n_words = parse_v2_header(data)[:4]
    assert n_esc > 0
    at = container_layout(K, n_words, n_esc)
    field = lambda i, v: data[:4 * i] + struct.pack("<I", v) + data[4 * i + 4:]
    return [
        ("empty", b"", None, "missing header"),
        ("header_cut", data[:19], None, "missing header"),
        ("bad_magic", field(0, 0x32585244), None, "not a CRX2"),
        ("no_lanes", field(2, 0), None, "implausible lane count"),
        ("too_many_lanes", field(2, (1 << 20) + 1), None, "implausible lane count"),
        ("too_many_symbols", field(1, (1 << 30) + 1), None, "implausible symbol/escape counts"),
        ("too_many_escapes", field(3, n + K + 1), None, "implausible symbol/escape counts"),
        ("words_cut", data[:at.escapes - 1], None, "header promises"),
        ("no_varints", data[:at.escapes], None, "truncated escape side channel"),
        ("last_varint_open", data[:-1] + bytes([data[-1] | 0x80]), None,
         "truncated escape side channel"),
        ("symbol_count", data, n + 1, "symbol count mismatch"),
    ]


def valid_stream(table, rng, device) -> bytes:
    """A stream of 3000 symbols with escapes, written by a coder on
    ``device``."""
    idx = rng.integers(0, table.num_indexes, 3000).astype(np.int32)
    sym = (table.offset[idx] + rng.integers(0, 5, idx.size)).astype(np.int32)
    sym[rng.random(idx.size) < 0.05] += 5000
    return LaneCoder(table, num_lanes=64, device=device).encode(sym, idx)


def reference_arrays(data: bytes):
    """``container_arrays`` of a container, its header parsed."""
    return container_arrays(data, parse_v2_header(data))
