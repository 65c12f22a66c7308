"""The port's entropy coders: the interleaved-lane rANS of format v2 on the
card (``lane_coder``, kernels K1-K3) and the serial v1 rANS on the host
(``native``; ``rans_py`` is its pure-Python oracle)."""

from .lane_coder import LaneCoder, lane_decode, lane_encode
from .native import decode_with_indexes, encode_with_indexes
from .rans_py import BufferedRansEncoder, RansDecoder, RansEncoder

__all__ = [
    "RansEncoder",
    "RansDecoder",
    "BufferedRansEncoder",
    "encode_with_indexes",
    "decode_with_indexes",
    "LaneCoder",
    "lane_encode",
    "lane_decode",
]
