"""Seeds derived from ``--seed``: one stream a purpose, so that the weights,
the fields and the arrivals of one seed never share draws."""

from __future__ import annotations

import zlib

import numpy as np


def sub_seed(seed: int, tag: str, index: int = 0) -> int:
    """A 63-bit seed for ``tag`` (and ``index``) from ``seed`` (any whole
    number up to 2**64)."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF, zlib.crc32(tag.encode()), index]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, tag))
