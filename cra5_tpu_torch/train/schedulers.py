"""Learning-rate schedules: functions from the update count (from 0) to
the learning rate.

Counterpart of ``cra5_tpu/train/schedulers.py``: the same four schedules,
each computing what its optax schedule computes, registered into the
``SCHEDULERS`` registry (``utils/registry.py``) and selected by
``build_schedule`` from a config dict ``{"type": <name>, ...}``. A
schedule registered there with ``@SCHEDULERS.register`` builds and
trains like the built-in ones.
"""

from __future__ import annotations

import bisect
import inspect
import math
from typing import Any, Callable, Dict, Optional, Sequence, Union

from ..utils.registry import SCHEDULERS

Schedule = Callable[[int], float]


def _linear(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax.linear_schedule."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        frac = 1 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


@SCHEDULERS.register("ConstantLR")
def constant_lr(base_lr: float) -> Schedule:
    return lambda count: base_lr


@SCHEDULERS.register("WarmupCosineLR")
def warmup_cosine_lr(
    base_lr: float,
    total_steps: int,
    warmup_steps: int = 1000,
    min_lr_ratio: float = 0.0,
) -> Schedule:
    """Linear warmup 0 -> base_lr over ``warmup_steps``, then cosine decay
    to ``base_lr * min_lr_ratio`` at ``total_steps``."""
    warmup = max(int(warmup_steps), 1)
    decay_steps = max(int(total_steps), int(warmup_steps) + 1) - warmup
    if decay_steps <= 0:
        raise ValueError(
            f"The cosine_decay_schedule requires positive decay_steps, got {decay_steps=}.")
    end = base_lr * min_lr_ratio
    alpha = 0.0 if base_lr == 0.0 else end / base_lr
    warm = _linear(0.0, base_lr, warmup)

    def schedule(count: int) -> float:
        if count < warmup:
            return warm(count)
        c = min(float(count - warmup), float(decay_steps))
        cosine = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
        return base_lr * ((1 - alpha) * cosine + alpha)

    return schedule


@SCHEDULERS.register("MultiStepLR")
def multistep_lr(
    base_lr: float,
    milestones: Sequence[int] = (),
    gamma: float = 0.1,
    warmup_steps: int = 0,
) -> Schedule:
    """Step decay: the rate is multiplied by ``gamma`` at each milestone
    (absolute step numbers, not offset by the warmup), with an optional
    linear warmup prefix."""
    ms = sorted(int(m) for m in milestones)
    w = int(warmup_steps)

    def schedule(count: int) -> float:
        lr = base_lr * gamma ** bisect.bisect_right(ms, count)
        if w:
            lr = lr * min(max(count / w, 0.0), 1.0)
        return lr

    return schedule


@SCHEDULERS.register("LinearWarmupLR")
def linear_warmup_lr(base_lr: float, warmup_steps: int = 1000) -> Schedule:
    w = int(warmup_steps)
    warm = _linear(0.0, base_lr, w)
    return lambda count: warm(count) if count < w else base_lr


def build_schedule(
    cfg: Optional[Dict[str, Any]],
    base_lr: float,
    total_steps: Optional[int] = None,
) -> Union[float, Schedule]:
    """Resolve ``{"type": <name>, ...}`` into a schedule (``None`` -> the
    constant ``base_lr``). ``total_steps`` is passed to schedules that
    need a horizon unless the dict sets one."""
    if cfg is None:
        return base_lr
    cfg = dict(cfg)
    name = cfg.pop("type")
    factory = SCHEDULERS.get(name)
    params = inspect.signature(factory).parameters
    accepted = set(params)
    unknown = set(cfg) - accepted
    if unknown:
        raise ValueError(
            f"scheduler {name!r} got unknown option(s) {sorted(unknown)}; "
            f"accepted: {sorted(accepted - {'base_lr'})}"
        )
    kwargs = {"base_lr": base_lr, **cfg}
    if "total_steps" in accepted and "total_steps" not in kwargs:
        if total_steps is None:
            if params["total_steps"].default is inspect.Parameter.empty:
                raise ValueError(
                    f"scheduler {name!r} needs a horizon: set "
                    f"TrainerConfig.total_steps (train CLI: the config's "
                    f"'steps' or --steps) or pass total_steps in the "
                    f"scheduler dict"
                )
        else:
            kwargs["total_steps"] = total_steps
    return factory(**kwargs)
