"""ERA5 field ingest and per-channel normalization (host side).

Counterpart of ``cra5_tpu/api/era5.py``: reads ``{ts}_pressure.nc`` and
``{ts}_single.nc``, stacks the configured pressure variables over the
configured levels, then the surface variables (tp scaled x1000), and builds
the per-channel mean/std from the JSON stats in ``assets/``. ``cfg`` is a
mapping with the keys of ``configs/cra5_268v.py``.

``xarray`` is imported inside ``read_data_from_nc`` only; without it that
function raises ``RuntimeError`` and ``synthetic_timestep`` serves tests
and benchmarks.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

_ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")


def load_mean_std(cfg) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel mean/std vectors in channel order."""
    with open(os.path.join(_ASSETS, "mean_std.json")) as f:
        mean_std = json.load(f)
    with open(os.path.join(_ASSETS, "mean_std_single.json")) as f:
        mean_std_single = json.load(f)

    level_mapping = [
        cfg["total_levels"].index(val)
        for val in cfg["pressure_level"]
        if val in cfg["total_levels"]
    ]
    mean_list: List[float] = []
    std_list: List[float] = []
    for vname in cfg["vnames"]["pressure"]:
        mean_list += [mean_std["mean"][vname][i] for i in level_mapping]
        std_list += [mean_std["std"][vname][i] for i in level_mapping]
    for vname in cfg["vnames"]["single"]:
        mean_list.append(mean_std_single["mean"][vname])
        std_list.append(mean_std_single["std"][vname])
    return (
        np.asarray(mean_list, dtype=np.float32),
        np.asarray(std_list, dtype=np.float32),
    )


def channel_vname_mapping(cfg) -> Tuple[Dict[int, str], Dict[str, int]]:
    """channel index <-> variable name."""
    channels_to_vname: Dict[int, str] = {}
    vname_to_channels: Dict[str, int] = {}
    ch = 0
    for v in cfg["vnames"]["pressure"]:
        for level in cfg["pressure_level"]:
            name = f"{v}_{int(level)}"
            channels_to_vname[ch] = name
            vname_to_channels[name] = ch
            ch += 1
    for v in cfg["vnames"]["single"]:
        channels_to_vname[ch] = v
        vname_to_channels[v] = ch
        ch += 1
    return channels_to_vname, vname_to_channels


def read_data_from_nc(cfg, local_root: str, time_stamp: str) -> np.ndarray:
    """Read one timestep from NetCDF files into a (C, 721, 1440) array
    (tp x 1000)."""
    try:
        import xarray as xr
    except ImportError as e:
        raise RuntimeError(
            "xarray/netCDF4 are not installed in this environment; "
            "use synthetic_timestep() or install the optional deps"
        ) from e

    year = time_stamp[:4]
    pressure_file = f"{local_root}/ERA5/{year}/{time_stamp}_pressure.nc"
    single_file = f"{local_root}/ERA5/{year}/{time_stamp}_single.nc"

    one_step = []
    pressure_data = xr.open_dataset(pressure_file, engine="netcdf4")
    single_data = xr.open_dataset(single_file, engine="netcdf4")

    for vname in cfg["vnames"]["pressure"]:
        D = pressure_data[vname].data
        file_levels = list(pressure_data.level.data)
        level_mapping = [
            file_levels.index(val) for val in cfg["pressure_level"] if val in file_levels
        ]
        for level in level_mapping:
            one_step.append(D[0][level][None])

    for vname in cfg["vnames"]["single"]:
        D = single_data[vname].data
        if vname == "tp":
            D = D * 1000
        one_step.append(D)

    return np.concatenate(one_step, 0)


def synthetic_timestep(cfg, seed: int = 0, shape: Tuple[int, int] = (721, 1440)) -> np.ndarray:
    """Physically-scaled random field for tests/benchmarks: each channel is
    N(mean_c, std_c) so the normalized tensor is ~N(0,1), matching the
    model's operating statistics."""
    mean, std = load_mean_std(cfg)
    rng = np.random.default_rng(seed)
    C = mean.shape[0]
    x = rng.standard_normal((C, *shape), dtype=np.float32)
    return x * std[:, None, None] + mean[:, None, None]


def normalize(data: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    return (data - mean[:, None, None]) / std[:, None, None]


def denormalize(data: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    return data * std[:, None, None] + mean[:, None, None]
