"""Classical-codec baselines over an image folder.

Counterpart of ``cra5_tpu/tools/bench.py`` (not the repository's bench of
the port, ``cra5_tpu_torch/bench.py``), with the same JSON: JPEG, WebP and
JPEG 2000 through PIL in-process, and BPG, VTM, HM, AV1 and TFCI through
the subprocess wrappers of ``ext_codecs``, which exit 2 naming the missing
binary when it is absent. The metrics (PSNR, MS-SSIM on 8-bit levels) are
the port's ``metrics.py`` on ``--device``, the card unless ``--device
cpu``; the codecs themselves run on the host.

Usage:
  python -m cra5_tpu_torch.tools.bench jpeg DATASET -q 10 20 ... [-o out.json]
  python -m cra5_tpu_torch.tools.bench bpg DATASET -q 30 40 --encoder-path bpgenc
  python -m cra5_tpu_torch.tools.bench vtm DATASET -q 32 --build-dir B --codec-config C
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from ..device import resolve_device
from ..metrics import MSSSIM_WEIGHTS, ms_ssim, psnr
from .eval_model import IMG_EXTENSIONS

_PIL_FORMATS = {"jpeg": "JPEG", "webp": "WEBP", "jpeg2000": "JPEG2000"}
_EXTERNAL = ("bpg", "vtm", "hm", "av1", "tfci")


def collect_images(rootpath: str) -> List[Path]:
    root = Path(rootpath)
    files: List[Path] = []
    for ext in IMG_EXTENSIONS:
        files.extend(root.rglob(f"*{ext}"))
    return sorted(files)


def rgb_metrics(org: np.ndarray, rec: np.ndarray, device=None) -> Dict[str, float]:
    """PSNR and MS-SSIM of two (H, W, 3) images on 8-bit levels, computed on
    ``device``; MS-SSIM takes as many scales as the size allows (up to
    five)."""
    dev = resolve_device(device)
    a = torch.as_tensor(np.asarray(org, np.float32).transpose(2, 0, 1)[None], device=dev)
    b = torch.as_tensor(np.asarray(rec, np.float32).transpose(2, 0, 1)[None], device=dev)
    levels = 5
    while levels > 1 and min(org.shape[:2]) < 11 * 2 ** (levels - 1):
        levels -= 1
    return {
        "psnr-rgb": float(psnr(a, b, 255.0)),
        "ms-ssim-rgb": float(ms_ssim(a, b, 255.0, weights=MSSSIM_WEIGHTS[:levels])),
    }


def run_pil_codec(img, fmt: str, quality: int, device=None) -> Dict[str, float]:
    """One image through a PIL codec at ``quality`` (JPEG 2000: the
    compression ratio of its one quality layer): bpp, the encode and decode
    seconds and the metrics on ``device``."""
    from PIL import Image

    buf = io.BytesIO()
    t0 = time.time()
    if fmt == "JPEG2000":
        img.save(buf, format=fmt, quality_mode="rates", quality_layers=[quality])
    else:
        img.save(buf, format=fmt, quality=quality)
    enc_time = time.time() - t0
    nbytes = buf.tell()
    buf.seek(0)
    t0 = time.time()
    rec = np.asarray(Image.open(buf).convert("RGB"), np.float32)
    dec_time = time.time() - t0
    org = np.asarray(img.convert("RGB"), np.float32)
    return {
        **rgb_metrics(org, rec, device),
        "bpp": nbytes * 8.0 / (org.shape[0] * org.shape[1]),
        "encoding_time": enc_time,
        "decoding_time": dec_time,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("codec", choices=sorted(_PIL_FORMATS) + list(_EXTERNAL))
    parser.add_argument("dataset", type=str)
    parser.add_argument("-q", "--qualities", nargs="+", type=int, default=[75])
    parser.add_argument("-o", "--output", type=str, default=None)
    parser.add_argument("--encoder-path", default=None,
                        help="external codec encoder binary (bpg/vtm/hm/av1)")
    parser.add_argument("--decoder-path", default=None,
                        help="external codec decoder binary (bpg/vtm/hm/av1)")
    parser.add_argument("--build-dir", default=None,
                        help="VTM/HM/AV1 build directory with the reference binaries")
    parser.add_argument("--codec-config", default=None, help="VTM/HM encoder .cfg file")
    parser.add_argument("--tfci-script", default=None,
                        help="path to tensorflow/compression tfci.py")
    parser.add_argument("--tfci-model", default="bmshj2018-factorized-mse")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="where the metrics are computed")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from .ext_codecs import CodecUnavailable, build_image_codec

    external = None
    if args.codec in _EXTERNAL:
        try:
            external = build_image_codec(args.codec, args)
            external._check()
        except CodecUnavailable as e:
            print(f"codec '{args.codec}' unavailable: {e}", file=sys.stderr)
            return 2

    from PIL import Image

    files = collect_images(args.dataset)
    if not files:
        print(f"no images found in {args.dataset}", file=sys.stderr)
        return 1

    results: Dict[str, List[float]] = defaultdict(list)
    for q in args.qualities:
        totals: Dict[str, float] = defaultdict(float)
        for f in files:
            if external is not None:
                rv = external.run(Image.open(f), q)
            else:
                rv = run_pil_codec(Image.open(f), _PIL_FORMATS[args.codec], q, device)
            for k, v in rv.items():
                totals[k] += v
        for k, v in totals.items():
            results[k].append(v / len(files))

    description = "PIL" if external is None else f"external ({args.codec})"
    text = json.dumps({"name": args.codec, "description": description,
                       "results": dict(results)}, indent=2)
    if args.output:
        Path(args.output).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
