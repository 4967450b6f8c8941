"""Learning-rate schedules of the two trainers
(``diff_foley_tpu/utils/lr_schedules.py``), as plain functions of the
update count that return a float.

- ``lambda_linear`` (stage 2, the reference's LambdaLinearScheduler):
  linear warmup from ``f_start`` to ``f_max`` over ``warm_up_steps``, then
  a linear move towards ``f_min`` over ``cycle_length``; the shipped
  config (f_start 1e-6, f_max = f_min = 1, warmup 1000) is constant after
  the warmup.
- ``const_lr``, ``const_lr_cooldown``, ``cosine_with_warmup`` (stage 1)
  and ``lambda_warmup_cosine``.
"""
from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def lambda_linear(base_lr: float, warm_up_steps: int = 1000,
                  f_start: float = 1e-6, f_max: float = 1.0,
                  f_min: float = 1.0, cycle_length: float = 1e10) -> Schedule:
    cycle_length = float(cycle_length)

    def schedule(step: int) -> float:
        if step < warm_up_steps:
            f = f_start + (f_max - f_start) * (step / max(warm_up_steps, 1))
        else:
            f = f_min + (f_max - f_min) * (cycle_length - step) / cycle_length
        return base_lr * f

    return schedule


def const_lr(base_lr: float, warmup_steps: int = 0) -> Schedule:
    """Constant after a linear warmup."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * (step + 1) / max(warmup_steps, 1)
        return base_lr

    return schedule


def const_lr_cooldown(base_lr: float, warmup_steps: int, total_steps: int,
                      cooldown_steps: int, cooldown_power: float = 1.0,
                      cooldown_end_lr: float = 0.0) -> Schedule:
    """Constant with a polynomial cooldown over the last
    ``cooldown_steps``."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * (step + 1) / max(warmup_steps, 1)
        if step < total_steps - cooldown_steps:
            return base_lr
        frac = min(max((total_steps - step) / max(cooldown_steps, 1), 0.0),
                   1.0)
        return cooldown_end_lr + (base_lr - cooldown_end_lr) \
            * frac**cooldown_power

    return schedule


def lambda_warmup_cosine(base_lr: float, warm_up_steps: int, lr_min: float,
                         lr_max: float, lr_start: float,
                         max_decay_steps: int) -> Schedule:
    """A multiplier warmed from ``lr_start`` to ``lr_max``, then a cosine
    decay to ``lr_min``."""

    def schedule(step: int) -> float:
        if step < warm_up_steps:
            f = lr_start + (lr_max - lr_start) * step / max(warm_up_steps, 1)
        else:
            t = min(max((step - warm_up_steps)
                        / max(max_decay_steps - warm_up_steps, 1), 0.0), 1.0)
            f = lr_min + 0.5 * (lr_max - lr_min) * (1 + math.cos(t * math.pi))
        return base_lr * f

    return schedule


def cosine_with_warmup(base_lr: float, warmup_steps: int,
                       total_steps: int) -> Schedule:
    """Linear warmup, then a cosine decay to 0 at ``total_steps``."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * (step + 1) / max(warmup_steps, 1)
        prog = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        return 0.5 * (1 + math.cos(math.pi * min(max(prog, 0.0), 1.0))) \
            * base_lr

    return schedule
