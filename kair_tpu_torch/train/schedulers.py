"""Learning-rate schedules as plain step → lr functions (counterpart of
``kair_tpu/train/schedulers.py``; reference model_plain.py:227-240).

``step`` is the number of optimizer updates already made: the count at
which optax evaluates the JAX package's schedule for the next update, so
both packages use the same lr at every step. The trainer sets the lr of
``torch.optim`` from these before each update instead of using
``torch.optim.lr_scheduler``.
"""

from __future__ import annotations

import math
from bisect import bisect_right
from typing import Callable, Sequence


def multistep(base_lr: float, milestones: Sequence[int],
              gamma: float = 0.5) -> Callable[[int], float]:
    """lr = base · gamma^(number of milestones ≤ step) (MultiStepLR)."""
    ms = sorted(milestones)
    return lambda step: base_lr * gamma ** bisect_right(ms, step)


def cosine_annealing_restarts(base_lr: float, periods: Sequence[int],
                              restart_weights=1, eta_min: float = 0.0
                              ) -> Callable[[int], float]:
    """BasicSR CosineAnnealingRestartLR: cosine cycles of lengths
    ``periods``, each scaled by its restart weight; a scalar period is one
    cycle. Past the last cycle the lr stays at its final value."""
    if isinstance(periods, (int, float)):
        periods = [int(periods)]
    periods = list(periods)
    if isinstance(restart_weights, (int, float)):
        restart_weights = [restart_weights] * len(periods)
    assert len(restart_weights) == len(periods)
    ends = [sum(periods[:i + 1]) for i in range(len(periods))]

    def schedule(step):
        step = min(float(step), ends[-1] - 1.0)
        i = min(bisect_right(ends, step), len(periods) - 1)
        t = (step - (ends[i] - periods[i])) / periods[i]
        return eta_min + restart_weights[i] * 0.5 * (base_lr - eta_min) * (
            1 + math.cos(math.pi * t))

    return schedule


def get_schedule(opt_train: dict) -> Callable[[int], float]:
    """Scheduler selection mirroring model_plain.py:227-240."""
    stype = opt_train.get("G_scheduler_type") or "MultiStepLR"
    lr = opt_train["G_optimizer_lr"]
    if stype == "MultiStepLR":
        return multistep(lr, opt_train.get("G_scheduler_milestones") or [],
                         opt_train.get("G_scheduler_gamma") or 0.5)
    if stype == "CosineAnnealingWarmRestarts":
        return cosine_annealing_restarts(
            lr, opt_train["G_scheduler_periods"],
            opt_train.get("G_scheduler_restart_weights") or 1,
            opt_train.get("G_scheduler_eta_min") or 0.0)
    raise NotImplementedError(f"scheduler [{stype}]")
