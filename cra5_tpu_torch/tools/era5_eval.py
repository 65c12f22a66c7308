"""ERA5 reconstruction evaluator: the per-variable WRMSE / MAE / MSE table.

Counterpart of ``cra5_tpu/tools/era5_eval.py``: the latitude-weighted RMSE
(WeatherBench weights, ``metrics.lat_weights``) and the mean absolute
error of each channel, their means over the channels, and the plain MSE,
of a reconstruction against its target in physical units. The metrics run
on ``device`` (the card unless the CPU is asked for).

Usage:
  python -m cra5_tpu_torch.tools.era5_eval RECON.npy TARGET.npy
      [--vnames-from cfg] [-o out.json] [--device cuda|cpu]
  (arrays shaped (C, H, W) or (B, C, H, W))
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..metrics import mean_abs_error, wrmse


def evaluate_fields(recon: np.ndarray, target: np.ndarray,
                    channel_names: Optional[List[str]] = None,
                    device=None) -> Dict[str, object]:
    if recon.ndim == 3:
        recon, target = recon[None], target[None]
    dev = resolve_device(device)
    r, t = torch.as_tensor(recon, device=dev), torch.as_tensor(target, device=dev)
    per_wrmse = wrmse(r, t, per_channel=True).cpu().numpy()
    per_mae = mean_abs_error(r, t, per_channel=True).cpu().numpy()
    names = channel_names or [f"ch{i}" for i in range(recon.shape[1])]
    return {
        "wrmse": {n: float(v) for n, v in zip(names, per_wrmse)},
        "mae": {n: float(v) for n, v in zip(names, per_mae)},
        "mean_wrmse": float(per_wrmse.mean()),
        "mean_mae": float(per_mae.mean()),
        "mse": float(np.mean((recon - target) ** 2)),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("recon", type=str)
    parser.add_argument("target", type=str)
    parser.add_argument("--vnames-from", type=str, default=None,
                        help="api config .py providing vnames/pressure_level")
    parser.add_argument("-o", "--output", type=str, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu; the card unless asked")
    args = parser.parse_args(argv)

    recon = np.load(args.recon).astype(np.float32)
    target = np.load(args.target).astype(np.float32)
    names = None
    if args.vnames_from:
        from ..api.era5 import channel_vname_mapping
        from ..utils.config import Config

        idx2name, _ = channel_vname_mapping(Config.fromfile(args.vnames_from))
        names = [idx2name[i] for i in range(len(idx2name))]

    text = json.dumps(evaluate_fields(recon, target, names, device=args.device), indent=2)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
