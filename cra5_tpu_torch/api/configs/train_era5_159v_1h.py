"""159-variable VAEformer training config: 6 pressure variables x 25
levels + 9 surface variables, hourly ERA5 at 721 x 1440.

Counterpart of ``cra5_tpu/api/configs/train_era5_159v_1h.py``. Usage:
``python -m cra5_tpu_torch.tools.train cra5_tpu_torch/api/configs/train_era5_159v_1h.py``
"""
_base_ = ["./train_era5_base.py"]

vnames = dict(
    pressure=["z", "q", "u", "v", "t", "w"],
    single=["v10", "u10", "v100", "u100", "t2m", "tcc", "sp", "tp6h", "msl"],
)
pressure_level = [
    1000., 950., 925., 900., 850.,
    800., 700., 600., 500., 400.,
    300., 250., 200., 150., 100.,
    70., 50., 30., 20., 10.,
    7., 5., 3., 2., 1.,
]

model = dict(type="VAEformer", cfg="159")

dataset = dict(vnames=vnames, pressure_level=pressure_level)
val_dataset = dict(vnames=vnames, pressure_level=pressure_level)
