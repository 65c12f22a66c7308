"""Forecast evaluation over the ERA5 eval-mode datasets.

Counterpart of ``cra5_tpu/tools/forecast_eval.py``: ``ERA5EvalDataset``
(ensemble / HRES / AI-model modes, with the climate-mean test path) scored
as WeatherBench scores forecasts: the latitude-weighted RMSE, the anomaly
correlation against the day-of-year climate mean, and the mean absolute
error, per lead time and per channel, averaged over the init times. The
metrics run on ``--device`` (the card unless the CPU is asked for).

Usage:
  python -m cra5_tpu_torch.tools.forecast_eval ARCHIVE --mode hres \\
      --pred-root PRED --climate-root CLIM \\
      --years 1979-01-01T00:00:00 1979-01-02T00:00:00 \\
      --gt-offsets 6 12 [--vnames z,t --levels 50,100 --singles t2m] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch

from ..data.era5 import ERA5EvalDataset
from ..device import resolve_device
from ..metrics import acc, mean_abs_error, wrmse


def evaluate_dataset(ds: ERA5EvalDataset, device=None) -> Dict[str, Dict[str, List[float]]]:
    """Per-lead-time, per-channel metrics averaged over every init time."""
    dev = resolve_device(device)
    names = ds.channel_names()
    sums = {"wrmse": defaultdict(lambda: 0.0), "mae": defaultdict(lambda: 0.0),
            "acc": defaultdict(lambda: 0.0)}
    counts: Dict[int, int] = defaultdict(int)
    has_clim = ds.climate_root is not None
    for i in range(len(ds)):
        item = ds[i]
        pred, gt = item["pred_label"], item["gt_label"]  # (T, C, H, W)
        clim = item.get("climate_mean") if has_clim else None
        for t in range(gt.shape[0]):
            p = torch.as_tensor(pred[t][None], device=dev)
            g = torch.as_tensor(gt[t][None], device=dev)
            sums["wrmse"][t] += wrmse(p, g, per_channel=True).cpu().numpy()
            sums["mae"][t] += mean_abs_error(p, g).cpu().numpy()
            if clim is not None:
                c = torch.as_tensor(clim[t][None], device=dev)
                sums["acc"][t] += acc(p, g, c).cpu().numpy()
            counts[t] += 1

    lead_hours = [int(h) for h in ds.sequence_cfg["gt"]]
    out: Dict[str, Dict[str, List[float]]] = {"channels": names, "lead_hours": lead_hours}
    for metric, per_t in sums.items():
        if per_t:
            out[metric] = {str(lead_hours[t]): (per_t[t] / counts[t]).tolist()
                           for t in sorted(per_t)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("archive", help="ground-truth archive root (per-channel npy)")
    ap.add_argument("--mode", default="hres",
                    choices=["default", "ensemble", "hres", "aimodel", "aimodel_interp"])
    ap.add_argument("--pred-root", default=None)
    ap.add_argument("--climate-root", default=None)
    ap.add_argument("--years", nargs=2, required=True, metavar=("START", "END"))
    ap.add_argument("--time-interval", type=int, default=6)
    ap.add_argument("--gt-offsets", nargs="+", type=int, default=[6, 12])
    ap.add_argument("--vnames", default="z,t", help="pressure variables (comma)")
    ap.add_argument("--levels", default="50,100", help="pressure levels (comma)")
    ap.add_argument("--singles", default="t2m", help="surface variables (comma)")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu; the card unless asked")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    ds = ERA5EvalDataset(
        args.archive,
        vnames={"pressure": [v for v in args.vnames.split(",") if v],
                "single": [v for v in args.singles.split(",") if v]},
        pressure_level=[int(lv) for lv in args.levels.split(",") if lv],
        years=(args.years[0], args.years[1]),
        time_interval=args.time_interval,
        sequence_cfg={"input": [0], "gt": list(args.gt_offsets)},
        test_mode=args.mode,
        pred_root=args.pred_root,
        climate_root=args.climate_root,
    )
    if len(ds) == 0:
        print("no usable init times in the given range", file=sys.stderr)
        return 1
    report = evaluate_dataset(ds, device)
    report["mode"] = args.mode
    report["n_init_times"] = len(ds)
    text = json.dumps(report, indent=1)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
