"""Learning-rate schedules, step-indexed.

Port of ``segmentation_factory_tpu/schedule.py`` (:23-108, :286-302): the
cosine schedule with restarts (``cosine_schedule``), its linear warm-up
(``_with_warmup``) and ``create_schedule`` for the ``cosine`` entry that
pinned config #5 uses. A schedule maps an optimizer-update count (an int
or an integer tensor on any device) to a float32 tensor, computed in
float32 as the jnp original; the first update reads schedule(0).
Seeded LR noise (``_with_noise``) is not ported: passing ``noise_range``
raises.
"""

from __future__ import annotations

import math
from typing import Callable

import torch


def _t(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def _with_warmup(fn: Callable, warmup_steps: int, warmup_lr_init: float, base_lr: float):
    """Linear ramp from ``warmup_lr_init`` to ``base_lr`` over
    ``warmup_steps``, then ``fn`` of the steps after the warm-up."""
    if warmup_steps <= 0:
        return fn

    def sched(step):
        step = _t(step)
        frac = (step / warmup_steps).clamp(0.0, 1.0)
        warm = warmup_lr_init + frac * (base_lr - warmup_lr_init)
        return torch.where(step < warmup_steps, warm,
                           fn((step - warmup_steps).clamp_min(0.0)))

    return sched


def cosine_schedule(base_lr: float, total_steps: int, min_lr: float = 1e-5,
                    warmup_steps: int = 0, warmup_lr_init: float = 1e-6,
                    cycle_mul: float = 1.0, cycle_decay: float = 1.0, cycle_limit: int = 1,
                    k_decay: float = 1.0, noise_range=None, **_other_schedules_knobs) -> Callable:
    """Cosine with restarts (schedule.py:71-107); knobs of other schedules
    are ignored, as in the JAX ``create_schedule``."""
    if noise_range is not None:
        raise NotImplementedError("LR noise (noise_range) is not ported")
    t_initial = max(total_steps - warmup_steps, 1)

    def fn(t):
        t = _t(t)
        if cycle_mul == 1.0:
            i = torch.floor(t / t_initial)
            t_i = torch.tensor(float(t_initial))
            t_curr = t - i * t_initial
        else:
            i = torch.floor(torch.log1p(t / t_initial * (cycle_mul - 1.0)) / math.log(cycle_mul))
            t_curr = t - (1.0 - cycle_mul ** i) / (1.0 - cycle_mul) * t_initial
            t_i = cycle_mul ** i * t_initial
        i = i.clamp_max(cycle_limit - 1)
        lr_max = base_lr * cycle_decay ** i
        frac = (t_curr ** k_decay / t_i.to(t.device) ** k_decay).clamp(0.0, 1.0)
        lr = min_lr + 0.5 * (lr_max - min_lr) * (1.0 + torch.cos(math.pi * frac))
        if cycle_mul == 1.0:
            lr = torch.where(t >= t_initial * cycle_limit, torch.full_like(lr, min_lr), lr)
        return lr

    return _with_warmup(fn, warmup_steps, warmup_lr_init, base_lr)


SCHEDULES = {"cosine": cosine_schedule}


def create_schedule(name: str, base_lr: float, total_steps: int, **kwargs) -> Callable:
    """Schedule by name (schedule.py:286-302); ``total_steps`` counts
    optimizer updates."""
    key = name.lower()
    if key not in SCHEDULES:
        raise KeyError(f"unknown or unported schedule {name!r}; available: {sorted(SCHEDULES)}")
    return SCHEDULES[key](base_lr, total_steps, **kwargs)
