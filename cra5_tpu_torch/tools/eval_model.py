"""Evaluate a zoo model on a folder of images (or .npy tensors).

Counterpart of ``cra5_tpu/tools/eval_model.py``, with the same JSON: per
input, pad -> compress -> bytes -> decompress -> PSNR / MS-SSIM (images,
on 8-bit levels) or MSE / PSNR (.npy), bpp and the encode and decode wall
times (each ending in a device synchronize), averaged over the inputs;
``--entropy-estimation`` skips the coder and integrates the likelihoods of
the model's forward. Weights are the seeded init unless ``--checkpoint``
names a file (the JAX package's ``.msgpack`` variables, or the port's
``.pt``). It runs on the card unless ``--device cpu``. PIL is imported
only for image files; ``.npy`` inputs ((C, H, W) or (H, W)) need none.

Usage:
  python -m cra5_tpu_torch.tools.eval_model DATASET -a bmshj2018-factorized -q 1 2 3
  python -m cra5_tpu_torch.tools.eval_model DATASET -a mbt2018-mean -q 1 --entropy-estimation
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..entropy.ops import compute_padding
from ..metrics import MSSSIM_WEIGHTS, ms_ssim, psnr
from ..models import load_model, model_architectures

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp")


def collect_files(rootpath: str) -> List[Path]:
    root = Path(rootpath)
    files: List[Path] = []
    for ext in IMG_EXTENSIONS + (".npy",):
        files.extend(root.rglob(f"*{ext}"))
    return sorted(files)


def read_input(path: Path) -> np.ndarray:
    """(C, H, W) float32: in [0, 1] for images, as stored for .npy."""
    if path.suffix == ".npy":
        arr = np.load(path).astype(np.float32)
        return arr[None] if arr.ndim == 2 else arr
    from PIL import Image

    img = Image.open(path).convert("RGB")
    return np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0


def _pad(x: np.ndarray, min_div: int):
    _, _, h, w = x.shape
    (left, right, top, bottom), _ = compute_padding(h, w, min_div=min_div)
    xp = np.pad(x, ((0, 0), (0, 0), (top, bottom), (left, right)))
    return xp, (top, bottom, left, right)


def _unpad(x: torch.Tensor, borders) -> torch.Tensor:
    top, bottom, left, right = borders
    h, w = x.shape[-2], x.shape[-1]
    return x[..., top:h - bottom, left:w - right]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _img_metrics(x: np.ndarray, x_hat: torch.Tensor, is_image: bool) -> Dict[str, float]:
    xt = torch.as_tensor(x, device=x_hat.device)[None]
    x_hat = x_hat[None].float()
    if is_image:
        org = torch.round(torch.clamp(xt * 255, 0, 255))
        rec = torch.round(torch.clamp(x_hat * 255, 0, 255))
        levels = 5
        min_dim = min(x.shape[-2:])
        while levels > 1 and min_dim < 11 * 2 ** (levels - 1):
            levels -= 1
        return {
            "psnr-rgb": float(psnr(org, rec, 255.0)),
            "ms-ssim-rgb": float(ms_ssim(org, rec, 255.0, weights=MSSSIM_WEIGHTS[:levels])),
        }
    return {
        "mse": float(torch.mean(torch.square(xt - x_hat))),
        "psnr": float(psnr(xt, x_hat, float(np.abs(x).max() or 1.0))),
    }


def inference(codec, x: np.ndarray, min_div: int, is_image: bool) -> Dict[str, float]:
    xp, borders = _pad(x[None], min_div)
    t0 = time.time()
    out_enc = codec.compress(xp)  # ends with the bytes on the host
    enc_time = time.time() - t0
    t0 = time.time()
    out_dec = codec.decompress(out_enc["strings"], out_enc["shape"])
    _sync(codec.device)
    dec_time = time.time() - t0
    x_hat = _unpad(out_dec["x_hat"][0], borders)
    num_pixels = x.shape[-2] * x.shape[-1]
    nbytes = sum(len(s if isinstance(s, bytes) else s[0])
                 for group in out_enc["strings"] for s in group)
    return {
        **_img_metrics(x, x_hat, is_image),
        "bpp": nbytes * 8.0 / num_pixels,
        "encoding_time": enc_time,
        "decoding_time": dec_time,
    }


def inference_entropy_estimation(codec, x: np.ndarray, min_div: int,
                                 is_image: bool) -> Dict[str, float]:
    xp, borders = _pad(x[None], min_div)
    t0 = time.time()
    out = codec.forward(xp)
    _sync(codec.device)
    elapsed = time.time() - t0
    x_hat = _unpad(out["x_hat"][0], borders)
    num_pixels = x.shape[-2] * x.shape[-1]
    bpp = sum(float(torch.sum(torch.log(l)) / (-math.log(2) * num_pixels))
              for l in out["likelihoods"].values())
    return {
        **_img_metrics(x, x_hat, is_image),
        "bpp": bpp,
        "encoding_time": elapsed / 2.0,
        "decoding_time": elapsed / 2.0,
    }


def eval_model(codec, files: List[Path], entropy_estimation: bool, min_div: int,
               per_image_dir: Optional[str] = None,
               trained_net: str = "model") -> Dict[str, float]:
    """Each input's metrics averaged over ``files``; with
    ``per_image_dir`` also one JSON per input, ``<stem>-<trained_net>.json``."""
    totals: Dict[str, float] = defaultdict(float)
    for f in files:
        x = read_input(f)
        is_image = f.suffix != ".npy"
        rv = (inference_entropy_estimation if entropy_estimation else inference)(
            codec, x, min_div, is_image)
        for k, v in rv.items():
            totals[k] += v
        if per_image_dir:
            out = Path(per_image_dir) / f"{f.stem}-{trained_net}.json"
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps({"source": f.stem, "name": trained_net, "results": rv},
                                      indent=2))
    return {k: v / len(files) for k, v in totals.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("dataset", type=str)
    parser.add_argument("-a", "--architecture", required=True,
                        choices=sorted(model_architectures.keys()))
    parser.add_argument("-q", "--qualities", nargs="+", type=int, default=[1])
    parser.add_argument("--entropy-estimation", action="store_true")
    parser.add_argument("--entropy-coder", choices=["v1", "v2"], default="v2")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="weights file: the JAX package's .msgpack or the port's .pt "
                             "(else the seeded init)")
    parser.add_argument("--in-channel", type=int, default=3)
    parser.add_argument("--min-div", type=int, default=64)
    parser.add_argument("--per-image", type=str, default=None,
                        help="directory for per-image result JSONs")
    parser.add_argument("-o", "--output", type=str, default=None)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)

    files = collect_files(args.dataset)
    if not files:
        print(f"no inputs found in {args.dataset}", file=sys.stderr)
        return 1

    results: Dict[str, List[float]] = defaultdict(list)
    for q in args.qualities:
        _, codec = load_model(
            args.architecture, q,
            in_channel=args.in_channel,
            pretrained=args.checkpoint is not None,
            checkpoint_path=args.checkpoint,
            coder=args.entropy_coder,
            device=args.device,
        )
        metrics = eval_model(codec, files, args.entropy_estimation, args.min_div,
                             args.per_image, f"{args.architecture}-{q}")
        for k, v in metrics.items():
            results[k].append(v)

    desc = "entropy-estimation" if args.entropy_estimation else args.entropy_coder
    text = json.dumps({"name": args.architecture, "description": f"Inference ({desc})",
                       "results": dict(results)}, indent=2)
    if args.output:
        Path(args.output).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
