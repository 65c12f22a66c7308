"""The 268-variable ERA5 configuration of ``cra5_api``: 7 pressure-level
variables x 37 levels + 9 surface variables = 268 channels, in this order.

Counterpart of ``cra5_tpu/api/configs/cra5_268v.py``, as plain constants
read by import.
"""

vnames = dict(
    pressure=["z", "q", "u", "v", "t", "r", "w"],
    single=["v10", "u10", "v100", "u100", "t2m", "tcc", "sp", "tp", "msl"],
)

total_levels = [
    1000., 975., 950., 925., 900., 875., 850., 825., 800.,
    775., 750., 700., 650., 600., 550., 500., 450., 400.,
    350., 300., 250., 225., 200., 175., 150., 125., 100.,
    70., 50., 30., 20., 10., 7., 5., 3., 2., 1.,
]

pressure_level = total_levels

crop_size = (721, 1440)
ori_size = (721, 1440)
model_version = 268
