"""Find the classical-codec quality whose metric is closest to a target.

Counterpart of ``cra5_tpu/tools/find_close.py``: bisect the codec's quality
range until the chosen metric brackets the target, then report the
closest setting. The PIL codecs run in-process, BPG/VTM/HM/AV1 through the
``ext_codecs`` wrappers when their binaries are present (exit 2 naming the
missing one otherwise). The metrics are computed on ``--device``, the card
unless ``--device cpu``.

Usage:
  python -m cra5_tpu_torch.tools.find_close jpeg image.png 35 --metric psnr-rgb
  python -m cra5_tpu_torch.tools.find_close bpg image.png 0.5 --metric bpp
"""

from __future__ import annotations

import argparse
import sys

from ..device import resolve_device
from .bench import _EXTERNAL, _PIL_FORMATS, run_pil_codec

_QUALITY_RANGE = {"jpeg": (1, 95), "webp": (0, 100), "jpeg2000": (1, 200)}
# the metric falls as the quality parameter rises: JPEG 2000's rate and the
# external codecs' QP-style parameters
_DECREASING = {"jpeg2000", "bpg", "vtm", "hm", "av1"}


def find_close(codec: str, img, target: float, metric: str, external=None, device=None):
    """(quality, metric value, the run's results) closest to ``target``."""
    if external is not None:
        lo, hi = external.quality_range
        run = lambda q: external.run(img, q)  # noqa: E731
    else:
        lo, hi = _QUALITY_RANGE[codec]
        fmt = _PIL_FORMATS[codec]
        run = lambda q: run_pil_codec(img, fmt, q, device)  # noqa: E731
    decreasing = codec in _DECREASING
    best = None
    while lo < hi:
        mid = (lo + hi) // 2
        rv = run(mid)
        val = rv[metric]
        if best is None or abs(val - target) < abs(best[1] - target):
            best = (mid, val, rv)
        go_up = (val < target) != decreasing
        if go_up:
            lo = mid + 1
        else:
            hi = mid
    return best


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("codec", choices=sorted(_PIL_FORMATS) + [c for c in _EXTERNAL
                                                                 if c != "tfci"])
    parser.add_argument("image", type=str)
    parser.add_argument("target", type=float)
    parser.add_argument("--metric", default="psnr-rgb", choices=["psnr-rgb", "ms-ssim-rgb", "bpp"])
    parser.add_argument("--encoder-path", default=None)
    parser.add_argument("--decoder-path", default=None)
    parser.add_argument("--build-dir", default=None)
    parser.add_argument("--codec-config", default=None)
    parser.add_argument("--tfci-script", default=None)
    parser.add_argument("--tfci-model", default="bmshj2018-factorized-mse")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="where the metrics are computed")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    external = None
    if args.codec in _EXTERNAL:
        from .ext_codecs import CodecUnavailable, build_image_codec

        try:
            external = build_image_codec(args.codec, args)
            external._check()
        except CodecUnavailable as e:
            print(f"codec '{args.codec}' unavailable: {e}", file=sys.stderr)
            return 2

    from PIL import Image

    img = Image.open(args.image)
    quality, value, rv = find_close(args.codec, img, args.target, args.metric, external, device)
    print(f"{args.codec} quality={quality}: {args.metric}={value:.4f} "
          f"(target {args.target}) bpp={rv['bpp']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
