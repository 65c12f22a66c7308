"""A plain NumPy decoder of the CRX2 interleaved-lane rANS streams
(``docs/FORMATS.md`` section 3), written from the format: the header, the
lane states, the shared 16-bit word stream, the zigzag-varint escapes, the
index-sorted lane assignment and the tiny-bucket merge.

``decode`` returns the symbols and raises ``StreamError`` on any fault a
conforming stream cannot have: a header out of bounds, words left over or
missing, a lane whose state does not end at the encoder's initial 2**16, or
an escape count that disagrees with the sentinels decoded.
"""

from __future__ import annotations

import struct

import numpy as np

from .tables import PRECISION, Table

MAGIC = 0x32585243
SORTED, SAFE, MERGED = 1 << 31, 1 << 30, 1 << 29
LANE_L = 1 << PRECISION


class StreamError(ValueError):
    pass


def _varints(data: bytes, count: int) -> np.ndarray:
    out, pos = np.zeros(count, np.int64), 0
    for i in range(count):
        u, shift = 0, 0
        while True:
            if pos >= len(data):
                raise StreamError("escape side channel truncated")
            b = data[pos]
            pos += 1
            u |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        out[i] = (u >> 1) ^ -(u & 1)
    return out


def _merge(idx_sorted: np.ndarray, rows: int, lanes: int) -> np.ndarray:
    """Every index holding fewer than ``lanes`` symbols goes to the
    nearest index holding at least that many (ties to the smaller)."""
    counts = np.bincount(idx_sorted, minlength=rows)
    big = np.flatnonzero(counts >= lanes)
    if big.size == 0:
        return idx_sorted
    ids = np.arange(rows)
    dist = np.abs(ids[:, None] - big[None, :])
    remap = np.where(counts >= lanes, ids, big[np.argmin(dist, axis=1)])
    return remap[idx_sorted]


def decode(data: bytes, indexes: np.ndarray, table: Table) -> np.ndarray:
    """The int32 symbols of one stream, shaped like ``indexes`` (the CDF
    row of every symbol, in the stream's own order)."""
    if len(data) < 20:
        raise StreamError("header truncated")
    magic, n, kf, n_esc, n_words = struct.unpack_from("<IIIII", data, 0)
    K = kf & ~(SORTED | SAFE | MERGED)
    if magic != MAGIC or not 1 <= K <= 1 << 20 or n != indexes.size or n_esc > n + K:
        raise StreamError(f"bad header: magic {magic:#x}, n {n}, K {K}, escapes {n_esc}")
    end_words = 20 + 4 * K + 2 * n_words
    if len(data) < end_words:
        raise StreamError("stream truncated")
    x = np.frombuffer(data, "<u4", K, 20).astype(np.int64)
    words = np.frombuffer(data, "<u2", n_words, 20 + 4 * K).astype(np.int64)
    escapes = _varints(data[end_words:], n_esc)

    idx = indexes.reshape(-1).astype(np.int64)
    perm = None
    if kf & SORTED:
        pos_bits = max((n - 1).bit_length(), 1)
        perm = np.argsort((idx << pos_bits) | np.arange(n), kind="stable")
        idx = idx[perm]
        if kf & MERGED:
            idx = _merge(idx, table.cdf.shape[0], K)
    M = -(-n // K)
    pad = M * K - n
    fill = idx[-1] if perm is not None else 0
    grid = np.concatenate([idx, np.full(pad, fill, np.int64)]).reshape(M, K)

    # every row's cdf in one sorted key array: (row << 17) | cdf value
    rows_n = table.cdf.shape[0]
    lengths = table.length.astype(np.int64)
    row_start = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    flat = np.concatenate([table.cdf[r, :lengths[r]] for r in range(rows_n)]).astype(np.int64)
    keys = (np.repeat(np.arange(rows_n, dtype=np.int64), lengths) << 17) | flat
    top = lengths - 2
    values = np.empty((M, K), np.int64)
    sentinel = np.empty((M, K), bool)
    ptr = 0
    for t in range(M):
        r = grid[t]
        cum = x & 0xFFFF
        pos = np.searchsorted(keys, (r << 17) | cum, side="right") - 1
        s = pos - row_start[r]
        start = flat[pos]
        freq = flat[pos + 1] - start
        x = freq * (x >> PRECISION) + cum - start
        values[t] = s + table.offset[r]
        sentinel[t] = s == top[r]
        low = x < LANE_L
        need = int(low.sum())
        if ptr + need > n_words:
            raise StreamError("word stream ends early")
        w = np.zeros(K, np.int64)
        w[low] = words[ptr:ptr + need]
        x = np.where(low, (x << PRECISION) | w, x)
        ptr += need
    if ptr != n_words or np.any(x != LANE_L):
        raise StreamError(f"lanes end off their initial state ({int((x != LANE_L).sum())} "
                          f"lanes) or words left over ({n_words - ptr})")
    values, sentinel = values.reshape(-1)[:n], sentinel.reshape(-1)[:n]
    if int(sentinel.sum()) != n_esc:
        raise StreamError(f"{int(sentinel.sum())} escapes decoded, {n_esc} in the stream")
    values[sentinel] = escapes
    if perm is not None:
        out = np.empty(n, np.int64)
        out[perm] = values
        values = out
    return values.astype(np.int32).reshape(indexes.shape)
