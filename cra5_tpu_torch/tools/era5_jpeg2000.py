"""ERA5-as-JPEG 2000 classical baseline.

Counterpart of ``cra5_tpu/tools/era5_jpeg2000.py`` (numpy and PIL only, so
the same outputs): each normalized channel is shifted and scaled affinely
into uint16, compressed as a JPEG 2000 codestream at a target compression
ratio, and scored as per-channel and mean MSE at a bits-per-sub-pixel rate.
The (shift, scale) pair of each channel is what its decode needs.

Usage:
  python -m cra5_tpu_torch.tools.era5_jpeg2000 INPUT.npy -q 50 100 [-o out.json]
"""

from __future__ import annotations

import argparse
import io
import json
import sys
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np


def channel_to_uint16(chan: np.ndarray) -> Tuple[np.ndarray, float, float]:
    lo = float(chan.min())
    hi = float(chan.max())
    scale = (hi - lo) / 65535.0 if hi > lo else 1.0
    q = np.round((chan - lo) / scale).astype(np.uint16)
    return q, lo, scale


def uint16_to_channel(q: np.ndarray, shift: float, scale: float) -> np.ndarray:
    return q.astype(np.float32) * scale + shift


def compress_channel(chan: np.ndarray, rate: float) -> Tuple[bytes, float, float]:
    """rate: JPEG2000 'quality_layers' compression ratio."""
    from PIL import Image

    q, shift, scale = channel_to_uint16(chan)
    img = Image.fromarray(q)  # uint16 -> I;16
    buf = io.BytesIO()
    img.save(buf, format="JPEG2000", quality_mode="rates", quality_layers=[rate], irreversible=True)
    return buf.getvalue(), shift, scale


def decompress_channel(data: bytes, shift: float, scale: float) -> np.ndarray:
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    q = np.asarray(img).astype(np.int32)
    return uint16_to_channel(np.clip(q, 0, 65535), shift, scale)


def evaluate(data: np.ndarray, rate: float) -> Dict[str, float]:
    """data: (C, H, W) normalized fields -> mse/bpsp at one rate point."""
    C, H, W = data.shape
    total_bytes = 0
    sq_err = np.zeros(C)
    for c in range(C):
        stream, shift, scale = compress_channel(data[c], rate)
        rec = decompress_channel(stream, shift, scale)
        total_bytes += len(stream)
        sq_err[c] = float(np.mean((rec - data[c]) ** 2))
    return {
        "mse": float(sq_err.mean()),
        "bpsp": total_bytes * 8.0 / (C * H * W),
        "per_channel_mse": sq_err.tolist(),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("input", type=str, help=".npy of shape (C, H, W)")
    parser.add_argument("-q", "--rates", nargs="+", type=float, default=[50.0])
    parser.add_argument("-o", "--output", type=str, default=None)
    args = parser.parse_args(argv)

    data = np.load(args.input).astype(np.float32)
    if data.ndim == 4:
        data = data[0]
    results: Dict[str, List[float]] = {"mse": [], "bpsp": []}
    for r in args.rates:
        rv = evaluate(data, r)
        results["mse"].append(rv["mse"])
        results["bpsp"].append(rv["bpsp"])
    output = {"name": "JPEG-2000", "description": "ERA5 uint16 J2K", "results": results}
    text = json.dumps(output, indent=2)
    if args.output:
        Path(args.output).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
