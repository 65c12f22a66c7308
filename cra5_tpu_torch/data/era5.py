"""ERA5 training-time dataset loaders (host side, numpy).

Counterpart of ``cra5_tpu/data/era5.py``, item for item: per-channel
``.npy`` assembly with the directory scheme
``{year}/{date}/{hour}-{vname}{level}.npy``, timestamp arithmetic for
input/gt sequence pairs (``sequence_cfg``), mean/std normalization, the
evaluation modes of ``ERA5EvalDataset``, and NetCDF full-timestep reads of
the downloader's ``{ts}_pressure.nc`` / ``{ts}_single.nc`` pair. Items are
numpy arrays; ``prefetch.PrefetchLoader`` moves batches to the card.

``ERA5EvalDataset``'s resize of AI-model forecasts is ``resize_bilinear``,
the arithmetic of ``jax.image.resize(..., method="bilinear")``: a
separable triangle filter widened by the downsampling factor
(antialiasing), its weights renormalized where the filter leaves the
grid, not ``F.interpolate``'s clamped source coordinates.
"""

from __future__ import annotations

import datetime as _dt
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def timestamp_range(start: str, end: str, interval_hours: int = 6) -> List[str]:
    """Inclusive ISO timestamps like the reference's pd.date_range usage
    (era5_base_npy.py:160)."""
    t0 = _dt.datetime.fromisoformat(start)
    t1 = _dt.datetime.fromisoformat(end)
    out = []
    t = t0
    step = _dt.timedelta(hours=interval_hours)
    while t <= t1:
        out.append(t.isoformat())
        t += step
    return out


def _ts_to_npy_dir(ts: str) -> str:
    """'1979-01-01T06:00:00' -> '1979/1979-01-01/06:00:00' (reference
    era5_base_npy.py:175 file_list construction)."""
    d = _dt.datetime.fromisoformat(ts)
    return os.path.join(str(d.year), d.date().isoformat(), d.time().isoformat())


def _bilinear_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of one axis, as the jitted
    ``jax.image.resize`` makes them (``compute_weight_mat``) for the
    triangle kernel with antialiasing: sample points at (i + 0.5) n_in /
    n_out - 0.5, the kernel widened by n_in / n_out when that is above 1,
    each column divided by its sum (zero where the sum is below 1000 float32
    eps), and columns whose sample lies outside [-0.5, n_in - 0.5] zero."""
    inv = np.float32(n_in / n_out)
    kernel_scale = max(inv, np.float32(1.0))
    # (i + 0.5) * inv - 0.5 rounded once, as XLA's fused multiply-add gives
    # it inside the jitted resize (a position near 1440 has a float32 ulp
    # of 1.2e-4, so a second rounding moves a weight by as much)
    half = np.arange(n_out, dtype=np.float32) + np.float32(0.5)
    sample = (half.astype(np.float64) * np.float64(inv) - 0.5).astype(np.float32)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x)).astype(np.float32)
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    keep = np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps)
    w = np.where(keep, w / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


def resize_bilinear(x: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Resize the last two axes of ``x`` to ``hw`` as
    ``jax.image.resize(x, (..., *hw), method="bilinear")`` does (float32
    out for float32 in); an axis whose size does not change is left as it
    is."""
    x = np.asarray(x)
    if not np.issubdtype(x.dtype, np.floating):
        x = x.astype(np.float32)
    H, W = x.shape[-2:]
    if H != hw[0]:
        x = np.einsum("...hw,hH->...Hw", x, _bilinear_weights(H, hw[0]).astype(x.dtype))
    if W != hw[1]:
        x = np.einsum("...hw,wW->...hW", x, _bilinear_weights(W, hw[1]).astype(x.dtype))
    return x


class ERA5NpyDataset:
    """Assemble (C, H, W) timesteps from per-channel .npy files.

    File scheme: ``{root}/{year}/{date}/{time}-{vname}{level}.npy`` for
    pressure variables and ``{root}/{year}/{date}/{time}-{vname}.npy``
    for surface variables (reference era5_base_npy.py:340-380).

    sequence_cfg: {"input": [0], "gt": [0]} hour offsets; __getitem__
    returns {"inputs": (T_in, C, H, W), "gt": (T_gt, C, H, W)}.
    """

    def __init__(
        self,
        root: str,
        vnames: Dict[str, Sequence[str]],
        pressure_level: Sequence[int],
        years: Tuple[str, str],
        time_interval: int = 6,
        sequence_cfg: Optional[Dict[str, Sequence[int]]] = None,
        mean: Optional[np.ndarray] = None,
        std: Optional[np.ndarray] = None,
        num_samples: Optional[int] = None,
    ):
        self.root = root
        self.pressure_vnames = list(vnames.get("pressure", []))
        self.single_vnames = list(vnames.get("single", []))
        self.pressure_level = list(pressure_level)
        self.sequence_cfg = sequence_cfg or {"input": [0], "gt": [0]}
        self.mean = mean
        self.std = std

        stamps = timestamp_range(years[0], years[1], time_interval)
        max_off = max(
            max(self.sequence_cfg["input"], default=0),
            max(self.sequence_cfg["gt"], default=0),
        )
        usable = len(stamps) - max_off // time_interval
        self.timestamps = stamps[: max(usable, 0)]
        self.time_interval = time_interval
        if num_samples:
            self.timestamps = self.timestamps[:num_samples]

    def __len__(self) -> int:
        return len(self.timestamps)

    @property
    def num_channels(self) -> int:
        return len(self.pressure_vnames) * len(self.pressure_level) + len(
            self.single_vnames
        )

    def channel_names(self) -> List[str]:
        names = [
            f"{v}{l}" for v in self.pressure_vnames for l in self.pressure_level
        ]
        names += list(self.single_vnames)
        return names

    def _load_timestep(self, ts: str) -> np.ndarray:
        base = os.path.join(self.root, _ts_to_npy_dir(ts))
        chans = []
        for name in self.channel_names():
            path = f"{base}-{name}.npy"
            chans.append(np.load(path).astype(np.float32))
        data = np.stack(chans)
        if self.mean is not None:
            data = (data - self.mean.reshape(-1, 1, 1)) / self.std.reshape(-1, 1, 1)
        return data

    def _offset_ts(self, ts: str, hours: int) -> str:
        return (
            _dt.datetime.fromisoformat(ts) + _dt.timedelta(hours=hours)
        ).isoformat()

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        ts = self.timestamps[index]
        inputs = np.stack(
            [self._load_timestep(self._offset_ts(ts, h)) for h in self.sequence_cfg["input"]]
        )
        gt = np.stack(
            [self._load_timestep(self._offset_ts(ts, h)) for h in self.sequence_cfg["gt"]]
        )
        return {"inputs": inputs, "gt": gt, "timestamp": ts}

    @staticmethod
    def save_timestep(root: str, ts: str, data: np.ndarray, names: Sequence[str]) -> None:
        """Write one (C, H, W) timestep in the per-channel scheme (used by
        tests and archive tooling)."""
        base = os.path.join(root, _ts_to_npy_dir(ts))
        os.makedirs(os.path.dirname(base), exist_ok=True)
        for c, name in enumerate(names):
            np.save(f"{base}-{name}.npy", data[c])


class ERA5EvalDataset(ERA5NpyDataset):
    """Evaluation-mode dataset over forecast predictions vs the archive.

    The JAX package's counterpart of the reference's multi-mode test
    ``__getitem__`` (``cra5/dataset/cra5_base.py:541-648``: ensemble /
    HRES_25km / operational_9km / aimodel_* modes plus the climate-mean
    test path), on plain filesystem roots instead of the reference's S3
    buckets.

    Modes:
      - ``default``       — input/gt both from the archive (training layout)
      - ``ensemble``      — physics-ensemble forecasts: one multi-step run
                            per init time under ``{pred_root}/{init}/stepNN.npy``;
                            predictions are every ``pred_stride``-th step
                            starting at ``pred_start`` (reference takes the
                            12-hourly slots: start=2, stride=2)
      - ``hres``          — operational HRES runs, one step per gt offset
                            (start=0, stride=1), same layout as ensemble
      - ``aimodel``       — AI-model forecasts stored per valid time:
                            ``{pred_root}/{year}/{init}/{valid}.npy``
      - ``aimodel_interp``— like aimodel, with predictions bilinearly
                            resized to the gt grid (reference
                            aimodel_9km_to_25km, cra5_base.py:600-607)

    When ``climate_root`` is set (the reference's test split), items also
    carry ``climate_mean`` read per gt day-of-year from
    ``{climate_root}/{MM-DD}-{channel}.npy`` (reference cra5_base.py:634-641).

    Returns the reference's key schema: input, gt_label, pred_label,
    in_time_stamp, gt_time_stamp (+ climate_mean).
    """

    def __init__(
        self,
        *args,
        test_mode: str = "default",
        pred_root: Optional[str] = None,
        climate_root: Optional[str] = None,
        pred_start: Optional[int] = None,
        pred_stride: Optional[int] = None,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        modes = ("default", "ensemble", "hres", "aimodel", "aimodel_interp")
        if test_mode not in modes:
            raise ValueError(f"test_mode {test_mode!r} not in {modes}")
        if test_mode != "default" and pred_root is None:
            raise ValueError(f"test_mode {test_mode!r} requires pred_root")
        self.test_mode = test_mode
        self.pred_root = pred_root
        self.climate_root = climate_root
        self.pred_start = pred_start if pred_start is not None else (
            2 if test_mode == "ensemble" else 0
        )
        self.pred_stride = pred_stride if pred_stride is not None else (
            2 if test_mode == "ensemble" else 1
        )

    # -- prediction readers -------------------------------------------------

    def _load_step_file(self, path: str) -> np.ndarray:
        data = np.load(path).astype(np.float32)
        if self.mean is not None:
            data = (data - self.mean.reshape(-1, 1, 1)) / self.std.reshape(-1, 1, 1)
        return data

    def _preds_multistep(self, init_ts: str, n: int) -> List[np.ndarray]:
        """stepNN.npy run layout (ensemble / hres)."""
        run_dir = os.path.join(self.pred_root, init_ts)
        idxs = range(self.pred_start, self.pred_start + n * self.pred_stride,
                     self.pred_stride)
        return [self._load_step_file(os.path.join(run_dir, f"step{i:02d}.npy"))
                for i in idxs]

    def _preds_per_valid(self, init_ts: str, valid_ts: Sequence[str]) -> List[np.ndarray]:
        """{year}/{init}/{valid}.npy layout (aimodel, reference
        cra5_base.py:583-585 pred_path construction)."""
        base = os.path.join(self.pred_root, init_ts[:4], init_ts)
        return [self._load_step_file(os.path.join(base, f"{v}.npy")) for v in valid_ts]

    def _climate_mean(self, gt_ts: Sequence[str]) -> np.ndarray:
        out = []
        for ts in gt_ts:
            monthday = ts[5:10]
            chans = [
                np.load(os.path.join(self.climate_root, f"{monthday}-{name}.npy"))
                for name in self.channel_names()
            ]
            out.append(np.stack(chans).astype(np.float32))
        return np.stack(out)

    @staticmethod
    def _resize_to(pred: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
        return resize_bilinear(pred, hw)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        ts = self.timestamps[index]
        in_ts = [self._offset_ts(ts, h) for h in self.sequence_cfg["input"]]
        gt_ts = [self._offset_ts(in_ts[-1], h) for h in self.sequence_cfg["gt"]]
        gt = np.stack([self._load_timestep(t) for t in gt_ts])

        if self.test_mode == "default":
            inputs = np.stack([self._load_timestep(t) for t in in_ts])
            preds = gt.copy()
        elif self.test_mode in ("ensemble", "hres"):
            preds = np.stack(self._preds_multistep(in_ts[0], len(gt_ts)))
            inputs = self._load_step_file(
                os.path.join(self.pred_root, in_ts[0], "step00.npy")
            )[None]
        else:  # aimodel / aimodel_interp
            pred_list = self._preds_per_valid(in_ts[0], gt_ts)
            if self.test_mode == "aimodel_interp":
                pred_list = [self._resize_to(p, gt.shape[-2:]) for p in pred_list]
            preds = np.stack(pred_list)
            inputs = preds[:1].copy()

        item = {
            "input": inputs,
            "gt_label": gt,
            "pred_label": preds,
            "in_time_stamp": np.array(in_ts, dtype="datetime64[s]"),
            "gt_time_stamp": np.array(gt_ts, dtype="datetime64[s]"),
        }
        if self.climate_root is not None:
            item["climate_mean"] = self._climate_mean(gt_ts)
        return item

    @staticmethod
    def save_prediction_run(pred_root: str, init_ts: str, steps: Sequence[np.ndarray]) -> None:
        """Write a multi-step forecast run in the stepNN layout."""
        run_dir = os.path.join(pred_root, init_ts)
        os.makedirs(run_dir, exist_ok=True)
        for i, s in enumerate(steps):
            np.save(os.path.join(run_dir, f"step{i:02d}.npy"), s)

    @staticmethod
    def save_aimodel_forecast(pred_root: str, init_ts: str, valid_ts: str,
                              data: np.ndarray) -> None:
        """Write one AI-model forecast in the {year}/{init}/{valid} layout."""
        base = os.path.join(pred_root, init_ts[:4], init_ts)
        os.makedirs(base, exist_ok=True)
        np.save(os.path.join(base, f"{valid_ts}.npy"), data)

    @staticmethod
    def save_climate_mean(climate_root: str, monthday: str, data: np.ndarray,
                          names: Sequence[str]) -> None:
        """Write one day-of-year climate-mean in the per-channel scheme."""
        os.makedirs(climate_root, exist_ok=True)
        for c, name in enumerate(names):
            np.save(os.path.join(climate_root, f"{monthday}-{name}.npy"), data[c])


class ERA5NcDataset:
    """Full-timestep NetCDF dataset over downloader-produced pairs
    ``{ts}_pressure.nc`` + ``{ts}_single.nc`` (reference era5_base_nc.py
    and cra5/api layout)."""

    def __init__(
        self,
        cfg,
        root: str,
        timestamps: Sequence[str],
        normalize: bool = True,
    ):
        from ..api.era5 import load_mean_std, read_data_from_nc

        self.cfg = cfg
        self.root = root
        self.timestamps = list(timestamps)
        self.normalize = normalize
        self._read = read_data_from_nc
        if normalize:
            self.mean, self.std = load_mean_std(cfg)

    def __len__(self) -> int:
        return len(self.timestamps)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        ts = self.timestamps[index]
        data = self._read(self.cfg, self.root, ts).astype(np.float32)
        if self.normalize:
            data = (data - self.mean.reshape(-1, 1, 1)) / self.std.reshape(-1, 1, 1)
        return {"inputs": data[None], "gt": data[None], "timestamp": ts}
