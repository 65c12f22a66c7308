"""Classical video baselines over frame-folder clips.

Counterpart of ``cra5_tpu/tools/video_bench.py``, with the same JSON:
x264 / x265 (ffmpeg) and VTM / HM through the subprocess wrappers of
``ext_codecs``, gated on their binaries (exit 2 naming the missing one),
and all-intra JPEG / WebP / JPEG 2000 a frame through PIL. The metrics are
computed on ``--device``, the card unless ``--device cpu``.

Usage:
  python -m cra5_tpu_torch.tools.video_bench jpeg DATASET -q 30 60 [-o out.json]
  python -m cra5_tpu_torch.tools.video_bench x265 DATASET -q 30 35
  python -m cra5_tpu_torch.tools.video_bench vtm DATASET -q 32 --build-dir B --codec-config C
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict, List

import numpy as np

from ..data.image import VideoFolder
from ..device import resolve_device
from .bench import _PIL_FORMATS, run_pil_codec

_EXTERNAL_VIDEO = ("x264", "x265", "vtm", "hm")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("codec", choices=sorted(_PIL_FORMATS) + list(_EXTERNAL_VIDEO))
    parser.add_argument("dataset", type=str)
    parser.add_argument("--split", default="train")
    parser.add_argument("--frames", type=int, default=3)
    parser.add_argument("-q", "--qualities", nargs="+", type=int, default=[75])
    parser.add_argument("-o", "--output", type=str, default=None)
    parser.add_argument("--encoder-path", default=None,
                        help="ffmpeg (x264/x265) or encoder binary override")
    parser.add_argument("--decoder-path", default=None)
    parser.add_argument("--build-dir", default=None, help="VTM/HM build dir")
    parser.add_argument("--codec-config", default=None, help="VTM/HM .cfg file")
    parser.add_argument("--preset", default="medium", help="x264/x265 preset")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="where the metrics are computed")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from .ext_codecs import CodecUnavailable, build_video_codec

    external = None
    if args.codec in _EXTERNAL_VIDEO:
        try:
            external = build_video_codec(args.codec, args)
            external._check()
        except CodecUnavailable as e:
            print(f"codec '{args.codec}' unavailable: {e}", file=sys.stderr)
            return 2

    from PIL import Image

    ds = VideoFolder(args.dataset, split=args.split, max_frames=args.frames)
    if len(ds) == 0:
        print(f"no clips in {args.dataset}/{args.split}", file=sys.stderr)
        return 1

    results: Dict[str, List[float]] = defaultdict(list)
    for q in args.qualities:
        totals: Dict[str, float] = defaultdict(float)
        count = 0
        for ci in range(len(ds)):
            if external is not None:
                rvs = [external.run_clip([str(p) for p in ds.clips[ci]], q)]
            else:
                clip = ds[ci]  # (T, C, H, W) float in [0, 1]
                rvs = [run_pil_codec(Image.fromarray((f.transpose(1, 2, 0) * 255).astype(np.uint8)),
                                     _PIL_FORMATS[args.codec], q, device) for f in clip]
            for rv in rvs:
                for k, v in rv.items():
                    totals[k] += v
            count += len(rvs)
        for k, v in totals.items():
            results[k].append(v / count)

    name = args.codec if external is not None else f"{args.codec}-intra"
    description = "external" if external is not None else "all-intra PIL"
    text = json.dumps({"name": name, "description": description, "results": dict(results)},
                      indent=2)
    if args.output:
        Path(args.output).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
