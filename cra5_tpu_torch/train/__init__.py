"""Training of the port: losses, optimizers, schedules, EMA, checkpoints
and the ``Trainer`` (counterpart of ``cra5_tpu/train``)."""

from .calibrate import TRAINABLE, calibrate_entropy, calibrate_entropy_cached
from .ema import EmaState, ema_init, ema_update_
from .loop import Trainer, TrainerConfig, TrainState, make_train_step
from .loss import RateDistortionLoss, bpp_from_likelihoods, kl_weighted_loss
from .optim import NetAuxAdam, OptState, make_net_aux_optimizers
from .schedulers import SCHEDULERS, build_schedule

__all__ = [
    "TRAINABLE", "calibrate_entropy", "calibrate_entropy_cached",
    "EmaState", "ema_init", "ema_update_",
    "Trainer", "TrainerConfig", "TrainState", "make_train_step",
    "RateDistortionLoss", "bpp_from_likelihoods", "kl_weighted_loss",
    "NetAuxAdam", "OptState", "make_net_aux_optimizers",
    "SCHEDULERS", "build_schedule",
]
