"""268-variable VAEformer training config: 7 pressure variables x 37
levels + 9 surface variables, hourly ERA5 at 721 x 1440.

Counterpart of ``cra5_tpu/api/configs/train_era5_268v_1h.py``. Usage:
``python -m cra5_tpu_torch.tools.train cra5_tpu_torch/api/configs/train_era5_268v_1h.py``
"""
_base_ = ["./train_era5_base.py"]

# same channel order as the API config (cra5_268v.py)
vnames = dict(
    pressure=["z", "q", "u", "v", "t", "r", "w"],
    single=["v10", "u10", "v100", "u100", "t2m", "tcc", "sp", "tp", "msl"],
)
pressure_level = [
    1000., 975., 950., 925., 900., 875., 850., 825., 800.,
    775., 750., 700., 650., 600., 550., 500., 450., 400.,
    350., 300., 250., 225., 200., 175., 150., 125., 100.,
    70., 50., 30., 20., 10., 7., 5., 3., 2., 1.,
]

model = dict(type="VAEformer", cfg="268")

dataset = dict(vnames=vnames, pressure_level=pressure_level)
val_dataset = dict(vnames=vnames, pressure_level=pressure_level)
