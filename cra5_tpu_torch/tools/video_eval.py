"""Video codec evaluation: ScaleSpaceFlow over frame-folder clips.

Counterpart of ``cra5_tpu/tools/video_eval.py``, with the same JSON: per
clip, the frames padded to a multiple of 128 -> compress -> bytes ->
decompress -> PSNR / MS-SSIM on 8-bit levels (the port's ``metrics.py``),
bpp and the encode and decode wall times, averaged over the clips. Each
clock read follows a device synchronize, so the times are the work's and
not its issue. It runs on the card unless ``--device cpu``.

Weights come from ``--checkpoint`` (the JAX package's ``.msgpack``
variables, or the port's ``.pt``), else from the seeded flax init; the
JAX package inits from ``PRNGKey(0)``, whose draws a torch generator
cannot reproduce, so a seeded run's weights (and numbers) differ between
the packages while a checkpoint's agree.

Usage:
  python -m cra5_tpu_torch.tools.video_eval DATASET [--frames 3] [--checkpoint ckpt]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from ..data.image import VideoFolder
from ..device import resolve_device
from ..metrics import MSSSIM_WEIGHTS, ms_ssim, psnr
from ..models.video import ScaleSpaceFlow, ScaleSpaceFlowCodec


def _pad_frames(frames: np.ndarray, min_div: int = 128):
    # 128: three stride-2 hyper convs must stay invertible (z >= 1 px)
    T, C, H, W = frames.shape
    ph = (min_div - H % min_div) % min_div
    pw = (min_div - W % min_div) % min_div
    return np.pad(frames, ((0, 0), (0, 0), (0, ph), (0, pw))), (H, W)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def eval_clip(codec: ScaleSpaceFlowCodec, frames: np.ndarray) -> Dict[str, float]:
    """One (T, C, H, W) clip in [0, 1] through the codec: its metrics, bpp
    and encode / decode seconds."""
    padded, (H, W) = _pad_frames(frames)
    frame_list = [padded[i:i + 1] for i in range(padded.shape[0])]
    _sync(codec.device)
    t0 = time.time()
    strings, shapes = codec.compress(frame_list)
    _sync(codec.device)
    enc_time = time.time() - t0
    t0 = time.time()
    dec = codec.decompress(strings, shapes)
    _sync(codec.device)
    dec_time = time.time() - t0

    nbytes = 0
    for s in strings:
        for group in (s.values() if isinstance(s, dict) else [s]):
            nbytes += sum(len(b) for part in group for b in part)
    num_pixels = frames.shape[0] * H * W

    org = torch.as_tensor(frames, device=codec.device) * 255.0
    rec = torch.clamp(torch.stack([d[0] for d in dec])[:, :, :H, :W] * 255.0, 0, 255)
    levels = 5
    while levels > 1 and min(H, W) < 11 * 2 ** (levels - 1):
        levels -= 1
    return {
        "psnr-rgb": float(psnr(org, rec, 255.0)),
        "ms-ssim-rgb": float(ms_ssim(org, rec, 255.0, weights=MSSSIM_WEIGHTS[:levels])),
        "bpp": nbytes * 8.0 / num_pixels,
        "encoding_time": enc_time,
        "decoding_time": dec_time,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("dataset", type=str)
    parser.add_argument("--split", default="train")
    parser.add_argument("--frames", type=int, default=3)
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--planes", type=int, default=192)
    parser.add_argument("--mid-planes", type=int, default=128)
    parser.add_argument("--num-levels", type=int, default=5)
    parser.add_argument("-o", "--output", type=str, default=None)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    ds = VideoFolder(args.dataset, split=args.split, max_frames=args.frames)
    if len(ds) == 0:
        print(f"no clips in {args.dataset}/{args.split}", file=sys.stderr)
        return 1

    model = ScaleSpaceFlow(num_levels=args.num_levels, mid_planes=args.mid_planes,
                           planes=args.planes, device=device)
    if args.checkpoint:
        from ..models.zoo import _load_checkpoint

        _load_checkpoint(model, args.checkpoint)
    else:
        model.reset_parameters(0)
    codec = ScaleSpaceFlowCodec(model)

    totals: Dict[str, float] = defaultdict(float)
    for i in range(len(ds)):
        for k, v in eval_clip(codec, ds[i]).items():
            totals[k] += v
    results = {k: [v / len(ds)] for k, v in totals.items()}
    text = json.dumps({"name": "ssf2020", "description": "video eval", "results": results},
                      indent=2)
    if args.output:
        Path(args.output).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
