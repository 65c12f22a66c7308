"""ERA5 downloader via the Copernicus CDS API (host side, network).

Counterpart of ``cra5_tpu/api/downloader.py``: per-timestamp
pressure-level and single-level NetCDF requests (``configs/era5_cds.py``)
written as ``{local_root}/ERA5/{year}/{ts}_pressure.nc`` and
``{ts}_single.nc``, with a size-verified retry. ``cdsapi`` is optional and
imported at first use; without it, use raises.
"""

from __future__ import annotations

import os
from typing import Optional

from ..utils.config import Config


class era5_downloader:
    def __init__(self, config: Optional[str] = None):
        here = os.path.dirname(os.path.abspath(__file__))
        self.cfg = Config.fromfile(config or os.path.join(here, "configs", "era5_cds.py"))
        self._client = None

    def _ensure_client(self):
        if self._client is None:
            try:
                import cdsapi
            except ImportError as e:
                raise RuntimeError("cdsapi is not installed; ERA5 download is unavailable") from e
            self._client = cdsapi.Client()
        return self._client

    def _requests_for(self, time_stamp: str):
        date, hour = time_stamp.split("T")
        hour = hour[:5]
        pressure_req = {
            "product_type": "reanalysis",
            "variable": list(self.cfg.pressure_variables.values()),
            "pressure_level": list(self.cfg.pressure_levels),
            "date": date,
            "time": hour,
            "format": self.cfg.get("data_format", "netcdf"),
            "grid": list(self.cfg.get("grid", [0.25, 0.25])),
        }
        single_req = {
            "product_type": "reanalysis",
            "variable": list(self.cfg.single_variables.values()),
            "date": date,
            "time": hour,
            "format": self.cfg.get("data_format", "netcdf"),
            "grid": list(self.cfg.get("grid", [0.25, 0.25])),
        }
        return pressure_req, single_req

    def save(self, time_stamp: str, local_root: str, max_retries: int = 3) -> dict:
        """Download ``{ts}_pressure.nc`` and ``{ts}_single.nc``, each tried
        again while its size differs from the server's, up to
        ``max_retries`` times."""
        client = self._ensure_client()
        year = time_stamp[:4]
        out_dir = os.path.join(local_root, "ERA5", year)
        os.makedirs(out_dir, exist_ok=True)
        pressure_req, single_req = self._requests_for(time_stamp)
        paths = {}
        jobs = [
            ("reanalysis-era5-pressure-levels", pressure_req, f"{time_stamp}_pressure.nc"),
            ("reanalysis-era5-single-levels", single_req, f"{time_stamp}_single.nc"),
        ]
        for dataset, req, fname in jobs:
            target = os.path.join(out_dir, fname)
            for attempt in range(max_retries):
                result = client.retrieve(dataset, req)
                expected = result.content_length
                result.download(target)
                if expected is None or os.path.getsize(target) == expected:
                    break
                if attempt == max_retries - 1:
                    raise RuntimeError(f"size mismatch after {max_retries} tries: {target}")
            paths[fname] = target
        return paths

    def get_form_timestamp(self, time_stamp: str, local_root: str) -> dict:
        return self.save(time_stamp, local_root)
