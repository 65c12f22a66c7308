"""64-bit rANS entropy coder — pure-Python oracle of the v1 stream.

Counterpart of ``cra5_tpu/coder/rans_py.py``. Bitstream-compatible with
CompressAI's native coder (cpp_exts/rans/rans_interface.cpp: precision=16,
4-bit bypass escapes, LIFO buffered encode, uint32 word stream with the
64-bit final state flushed to the head), which itself follows the public
ryg_rans rans64 construction. This module is the readable oracle the tests
hold ``native`` against; no code path of the port runs it.

Coding contract (shared with ``native``):
  - ``cdfs[k]`` is a quantized CDF row (int32) of length ``cdf_sizes[k]``,
    cdf[0] == 0, cdf[-1] == 2**16, strictly increasing.
  - symbol value ``v`` is coded in bin ``v - offsets[k]``; bins outside
    [0, max_value) escape through the last bin (sentinel) followed by a
    variable-length 4-bit bypass sequence.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

PRECISION = 16
BYPASS_PRECISION = 4
MAX_BYPASS_VAL = (1 << BYPASS_PRECISION) - 1
RANS64_L = 1 << 31

_MASK32 = (1 << 32) - 1
_MASK16 = (1 << 16) - 1


class BufferedRansEncoder:
    """Buffers (start, freq, bypass) triples, then flushes LIFO."""

    def __init__(self) -> None:
        self._syms: List[Tuple[int, int, bool]] = []

    def encode_with_indexes(
        self,
        symbols: Sequence[int],
        indexes: Sequence[int],
        cdfs: Sequence[Sequence[int]],
        cdf_sizes: Sequence[int],
        offsets: Sequence[int],
    ) -> None:
        syms = self._syms
        for i in range(len(symbols)):
            k = int(indexes[i])
            cdf = cdfs[k]
            max_value = int(cdf_sizes[k]) - 2
            value = int(symbols[i]) - int(offsets[k])

            raw_val = 0
            if value < 0:
                raw_val = -2 * value - 1
                value = max_value
            elif value >= max_value:
                raw_val = 2 * (value - max_value)
                value = max_value

            start = int(cdf[value])
            freq = int(cdf[value + 1]) - start
            syms.append((start, freq, False))

            if value == max_value:
                # escape: count of 4-bit bypass chunks, then the chunks
                n_bypass = 0
                while (raw_val >> (n_bypass * BYPASS_PRECISION)) != 0:
                    n_bypass += 1
                val = n_bypass
                while val >= MAX_BYPASS_VAL:
                    syms.append((MAX_BYPASS_VAL, MAX_BYPASS_VAL + 1, True))
                    val -= MAX_BYPASS_VAL
                syms.append((val, val + 1, True))
                for j in range(n_bypass):
                    chunk = (raw_val >> (j * BYPASS_PRECISION)) & MAX_BYPASS_VAL
                    syms.append((chunk, chunk + 1, True))

    def flush(self) -> bytes:
        x = RANS64_L
        emitted: List[int] = []  # words in emission order (stream is reversed)
        for start, freq, bypass in reversed(self._syms):
            if not bypass:
                # renormalize then x = C(s, x)
                x_max = ((RANS64_L >> PRECISION) << 32) * freq
                if x >= x_max:
                    emitted.append(x & _MASK32)
                    x >>= 32
                x = ((x // freq) << PRECISION) + (x % freq) + start
            else:
                # raw nbits put: freq = 2**(16 - nbits)
                freq = 1 << (PRECISION - BYPASS_PRECISION)
                x_max = ((RANS64_L >> PRECISION) << 32) * freq
                if x >= x_max:
                    emitted.append(x & _MASK32)
                    x >>= 32
                x = (x << BYPASS_PRECISION) | start
        self._syms.clear()
        words = np.empty(len(emitted) + 2, dtype=np.uint32)
        words[0] = x & _MASK32
        words[1] = (x >> 32) & _MASK32
        if emitted:
            words[2:] = np.asarray(emitted[::-1], dtype=np.uint32)
        return words.tobytes()


class RansEncoder:
    def encode_with_indexes(self, symbols, indexes, cdfs, cdf_sizes, offsets) -> bytes:
        enc = BufferedRansEncoder()
        enc.encode_with_indexes(symbols, indexes, cdfs, cdf_sizes, offsets)
        return enc.flush()


class RansDecoder:
    def __init__(self) -> None:
        self._words: np.ndarray | None = None
        self._pos = 0
        self._x = 0

    def set_stream(self, encoded: bytes) -> None:
        self._words = np.frombuffer(encoded, dtype=np.uint32)
        self._x = int(self._words[0]) | (int(self._words[1]) << 32)
        self._pos = 2

    def _get_bits(self, nbits: int) -> int:
        x = self._x
        val = x & ((1 << nbits) - 1)
        x >>= nbits
        if x < RANS64_L:
            x = (x << 32) | int(self._words[self._pos])
            self._pos += 1
        self._x = x
        return val

    def decode_stream(self, indexes, cdfs, cdf_sizes, offsets) -> List[int]:
        out = [0] * len(indexes)
        for i in range(len(indexes)):
            k = int(indexes[i])
            cdf = cdfs[k]
            size = int(cdf_sizes[k])
            max_value = size - 2

            x = self._x
            cum = x & _MASK16
            # first bin whose upper edge exceeds cum
            s = int(np.searchsorted(np.asarray(cdf[:size]), cum, side="right")) - 1
            start = int(cdf[s])
            freq = int(cdf[s + 1]) - start
            x = freq * (x >> PRECISION) + (x & _MASK16) - start
            if x < RANS64_L:
                x = (x << 32) | int(self._words[self._pos])
                self._pos += 1
            self._x = x

            value = s
            if value == max_value:
                val = self._get_bits(BYPASS_PRECISION)
                n_bypass = val
                while val == MAX_BYPASS_VAL:
                    val = self._get_bits(BYPASS_PRECISION)
                    n_bypass += val
                raw_val = 0
                for j in range(n_bypass):
                    raw_val |= self._get_bits(BYPASS_PRECISION) << (j * BYPASS_PRECISION)
                value = raw_val >> 1
                if raw_val & 1:
                    value = -value - 1
                else:
                    value += max_value

            out[i] = value + int(offsets[k])
        return out

    def decode_with_indexes(self, encoded, indexes, cdfs, cdf_sizes, offsets) -> List[int]:
        self.set_stream(encoded)
        return self.decode_stream(indexes, cdfs, cdf_sizes, offsets)
