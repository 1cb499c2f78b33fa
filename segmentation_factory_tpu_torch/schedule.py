"""Learning-rate schedules, step-indexed.

Port of ``segmentation_factory_tpu/schedule.py`` (:23-302): cosine with
restarts, tanh, step, multistep, poly and constant decay, each behind a
linear warm-up (``_with_warmup``) and seeded multiplicative LR noise
(``_with_noise``), the host-side reduce-on-plateau ``PlateauSchedule`` and
``create_schedule`` over all of them. A schedule maps an optimizer-update
count (an int or an integer tensor on any device) to a float32 tensor,
computed in float32 as the jnp original; the first update reads
schedule(0). Every schedule ignores the knobs of the others, as in the JAX
``create_schedule`` (the CLI passes the union of them).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
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


def noise_factors(noise_range, noise_pct: float, noise_std: float, seed: int,
                  total_steps: int) -> np.ndarray:
    """The (total_steps + 1,) float32 table of LR factors (schedule.py:36-68):
    1 + n for the steps in ``noise_range``, n ~ N(0, noise_std) drawn from
    ``numpy.random.default_rng(seed)`` and redrawn while |n| >= noise_pct;
    1 elsewhere. Drawn on the host, so both packages draw the same."""
    lo, hi = int(noise_range[0]), int(noise_range[1])
    rng = np.random.default_rng(seed)
    factors = np.ones(total_steps + 1, dtype=np.float32)
    for t in range(lo, min(hi, total_steps + 1)):
        while True:
            n = rng.normal() * noise_std
            if abs(n) < noise_pct:
                break
        factors[t] = 1.0 + n
    return factors


def _with_noise(fn: Callable, noise_range: Optional[tuple] = None, noise_pct: float = 0.67,
                noise_std: float = 1.0, seed: int = 42, total_steps: int = 0,
                **_other_schedules_knobs):
    """``fn`` times the step's factor of ``noise_factors`` (the step clipped
    to [0, total_steps]); ``fn`` itself without a noise range."""
    if noise_range is None or total_steps <= 0:
        return fn
    table = torch.from_numpy(noise_factors(noise_range, noise_pct, noise_std, seed, total_steps))
    tables = {}

    def sched(step):
        lr = fn(step)
        idx = torch.as_tensor(step).to(torch.int64).clamp(0, total_steps)
        dev = idx.device
        if dev not in tables:
            tables[dev] = table.to(dev)
        return lr * tables[dev][idx]

    return sched


def cosine_schedule(base_lr: float, total_steps: int, min_lr: float = 1e-5,
                    warmup_steps: int = 0, warmup_lr_init: float = 1e-6,
                    cycle_mul: float = 1.0, cycle_decay: float = 1.0, cycle_limit: int = 1,
                    k_decay: float = 1.0, **noise_kwargs) -> Callable:
    """Cosine with restarts (schedule.py:71-107)."""
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

    fn = _with_warmup(fn, warmup_steps, warmup_lr_init, base_lr)
    return _with_noise(fn, total_steps=total_steps, **noise_kwargs)


def tanh_schedule(base_lr: float, total_steps: int, min_lr: float = 1e-5,
                  warmup_steps: int = 0, warmup_lr_init: float = 1e-6, lb: float = -7.0,
                  ub: float = 3.0, **noise_kwargs) -> Callable:
    """Hyperbolic-tangent decay (schedule.py:110-131)."""
    t_initial = max(total_steps - warmup_steps, 1)

    def fn(t):
        frac = (_t(t) / t_initial).clamp(0.0, 1.0)
        tw = lb + (ub - lb) * frac
        return min_lr + 0.5 * (base_lr - min_lr) * (1.0 - torch.tanh(tw))

    fn = _with_warmup(fn, warmup_steps, warmup_lr_init, base_lr)
    return _with_noise(fn, total_steps=total_steps, **noise_kwargs)


def step_schedule(base_lr: float, decay_steps: int, decay_rate: float = 0.1,
                  warmup_steps: int = 0, warmup_lr_init: float = 1e-6, total_steps: int = 0,
                  **noise_kwargs) -> Callable:
    """Fixed-interval step decay (schedule.py:134-150)."""

    def fn(t):
        return base_lr * decay_rate ** torch.floor(_t(t) / decay_steps)

    fn = _with_warmup(fn, warmup_steps, warmup_lr_init, base_lr)
    return _with_noise(fn, total_steps=total_steps, **noise_kwargs)


def multistep_schedule(base_lr: float, milestones: Optional[Sequence[int]] = None,
                       decay_rate: float = 0.1, warmup_steps: int = 0,
                       warmup_lr_init: float = 1e-6, total_steps: int = 0,
                       **noise_kwargs) -> Callable:
    """Milestone decay (schedule.py:153-175); by default at 1/2 and 3/4 of
    the run."""
    if milestones is None:
        milestones = [max(total_steps // 2, 1), max(3 * total_steps // 4, 2)]
    ms = torch.tensor(sorted(milestones), dtype=torch.float32)

    def fn(t):
        t = _t(t)
        k = (t.unsqueeze(-1) >= ms.to(t.device)).sum(-1).to(torch.float32)
        return base_lr * decay_rate ** k

    fn = _with_warmup(fn, warmup_steps, warmup_lr_init, base_lr)
    return _with_noise(fn, total_steps=total_steps, **noise_kwargs)


def poly_schedule(base_lr: float, total_steps: int, power: float = 0.9, min_lr: float = 0.0,
                  warmup_steps: int = 0, warmup_lr_init: float = 1e-6, k_decay: float = 1.0,
                  **noise_kwargs) -> Callable:
    """Polynomial decay (schedule.py:178-196); power 0.9 is the
    segmentation standard."""
    t_initial = max(total_steps - warmup_steps, 1)

    def fn(t):
        frac = (_t(t) ** k_decay / t_initial ** k_decay).clamp(0.0, 1.0)
        return min_lr + (base_lr - min_lr) * (1.0 - frac) ** power

    fn = _with_warmup(fn, warmup_steps, warmup_lr_init, base_lr)
    return _with_noise(fn, total_steps=total_steps, **noise_kwargs)


def constant_schedule(base_lr: float, **_) -> Callable:
    """``base_lr`` at every step: no warm-up and no noise (schedule.py:199)."""
    return lambda t: torch.full_like(_t(t), base_lr)


class PlateauSchedule:
    """Reduce-on-plateau with a warm-up (schedule.py:203-271). Host-side
    state: the Trainer calls ``step(metric)`` after each eval, and the
    optimizer (``engine.state``) runs its rule at lr 1 and scales the update
    by the current ``lr`` times ``warmup_fraction`` of its update count, as
    the JAX optimizer's injected ``scale`` and ``scale_by_schedule`` stages
    do."""

    def __init__(self, base_lr: float, mode: str = "max", factor: float = 0.1,
                 patience: int = 10, min_lr: float = 1e-6, warmup_steps: int = 0,
                 warmup_lr_init: float = 1e-6, **_other_schedules_knobs):
        self.base_lr = base_lr
        self.lr = base_lr
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.warmup_steps = warmup_steps
        self.warmup_lr_init = warmup_lr_init
        self.best: Optional[float] = None
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        """Record an eval's metric; after more than ``patience`` evals
        without improvement the rate falls by ``factor`` (not below
        ``min_lr``). Returns the current rate."""
        improved = (self.best is None or (self.mode == "max" and metric > self.best)
                    or (self.mode == "min" and metric < self.best))
        if improved:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr

    def warmup_fraction(self, t) -> torch.Tensor:
        """The warm-up ramp over ``base_lr`` at update ``t``; 1 after it."""
        t = _t(t)
        if self.warmup_steps <= 0:
            return torch.ones_like(t)
        frac = (t / self.warmup_steps).clamp(0.0, 1.0)
        warm = self.warmup_lr_init + frac * (self.base_lr - self.warmup_lr_init)
        return torch.where(t < self.warmup_steps, warm / self.base_lr, torch.ones_like(t))

    def current_lr(self, t: int) -> float:
        """The effective rate at update ``t``, on the host (for logging)."""
        return float(self.lr) * float(self.warmup_fraction(t))

    def __call__(self, t) -> torch.Tensor:
        t = _t(t)
        if self.warmup_steps > 0:
            frac = (t / self.warmup_steps).clamp(0.0, 1.0)
            warm = self.warmup_lr_init + frac * (self.base_lr - self.warmup_lr_init)
            return torch.where(t < self.warmup_steps, warm, torch.full_like(t, self.lr))
        return torch.full_like(t, self.lr)


SCHEDULES = {
    "cosine": cosine_schedule,
    "tanh": tanh_schedule,
    "step": step_schedule,
    "multistep": multistep_schedule,
    "poly": poly_schedule,
    "constant": constant_schedule,
    "plateau": lambda base_lr, total_steps=0, **kw: PlateauSchedule(base_lr, **kw),
}


def create_schedule(name: str, base_lr: float, total_steps: int, **kwargs) -> Callable:
    """Schedule by name (schedule.py:286-302); ``total_steps`` counts
    optimizer updates. ``step`` decays every third of the run unless given
    ``decay_steps``."""
    key = name.lower()
    if key not in SCHEDULES:
        raise KeyError(f"unknown schedule {name!r}; available: {sorted(SCHEDULES)}")
    if key == "step" and "decay_steps" not in kwargs:
        kwargs["decay_steps"] = max(total_steps // 3, 1)
    if key in ("step", "multistep", "constant"):
        return SCHEDULES[key](base_lr, total_steps=total_steps, **kwargs)
    return SCHEDULES[key](base_lr, total_steps, **kwargs)
