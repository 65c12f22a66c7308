"""Shared ERA5 training-config base: dataset windows, loader and trainer
defaults.

Counterpart of ``cra5_tpu/api/configs/train_era5_base.py``, key for key.
Read by ``python -m cra5_tpu_torch.tools.train`` through
``utils/config.py`` (``_base_`` inheritance, ``{{$ENV:default}}``
substitution). ``mesh = dict(dp=-1)`` takes every visible device
data-parallel; on one card that is the one-device trainer. A mesh such as
``dict(dp=2, tp=2)`` adds tensor parallelism over the ranks.
"""

local_root = "{{$CRA5_ERA5_ROOT:/data/era5_np}}"

dataset = dict(
    type="ERA5NpyDataset",
    root=local_root,
    years=("1998-05-04", "2017-12-31"),
    time_interval=6,
    # input the current step, reconstruct the same step (compression);
    # forecast-style offsets go through sequence_cfg the same way
    sequence_cfg=dict(input=[0], gt=[0]),
    batch_size=4,
)

val_dataset = dict(
    type="ERA5NpyDataset",
    root=local_root,
    years=("2018-01-01", "2018-12-31"),
    time_interval=12,
    sequence_cfg=dict(input=[0], gt=[0]),
    batch_size=4,
)

evaluator = dict(type="Era5_RMSE", metric_name=["WRMSE", "MSE"])

trainer = dict(
    learning_rate=1e-4,
    aux_learning_rate=1e-3,
    lmbda=0.01,
    bpp_weight=0.01,
    use_ema=True,
    ema_decay=0.9999,
    max_grad_norm=1.0,
    ckpt_every=1000,
    # net-LR schedule (SCHEDULERS registry, train/schedulers.py); the
    # horizon defaults to this config's `steps`
    scheduler=dict(type="WarmupCosineLR", warmup_steps=2000, min_lr_ratio=0.1),
)

mesh = dict(dp=-1)  # all visible devices data-parallel
steps = 300_000
