"""The port's schedules against the JAX package's ``create_schedule`` on the
CPU, step by step: cosine (also with restarts), tanh, step, multistep
(default and given milestones), poly and constant, seeded LR noise on
three of them, and the plateau schedule with its warm-up and its decisions
on a sequence of eval metrics. Every case passes the union of the
schedules' knobs, which each schedule ignores where they are another's.

Tolerance: 1e-6 relative, or 1e-7 of the peak rate (both compute in
float32, but XLA's tanh and cos are not torch's to the last bit, and
1 - tanh near the end of the tanh decay cancels; the noise factors are
the same numpy draws).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_factory_tpu import schedule as JS
from segmentation_factory_tpu_torch import schedule as TS

TOTAL = 40
COMMON = dict(warmup_steps=5, warmup_lr_init=1e-5, min_lr=1e-4)
NOISE = dict(noise_range=(8, 30), noise_pct=0.5, noise_std=0.8, seed=3)
CASES = {
    "cosine": ("cosine", {}),
    "cosine_restarts": ("cosine", dict(cycle_mul=2.0, cycle_decay=0.5, cycle_limit=3,
                                       k_decay=1.5)),
    "tanh": ("tanh", {}),
    "step": ("step", dict(decay_rate=0.5)),
    "multistep": ("multistep", {}),
    "multistep_given": ("multistep", dict(milestones=[7, 20, 33], decay_rate=0.3)),
    "poly": ("poly", dict(power=0.9)),
    "constant": ("constant", {}),
    "cosine_noise": ("cosine", NOISE),
    "step_noise": ("step", dict(NOISE, decay_rate=0.5)),
    "poly_noise": ("poly", dict(NOISE, noise_range=(0, 60))),
    "plateau": ("plateau", dict(patience=1, factor=0.5, mode="max")),
}
# the plateau case's eval metrics, one after every 10 steps
METRICS = [10.0, 12.0, 11.0, 11.5, 9.0, 13.0, 12.0, 12.0]


@pytest.mark.parametrize("case", CASES)
def test_schedule_matches_jax(case):
    name, kw = CASES[case]
    kw = dict(COMMON, **kw)
    want_fn = JS.create_schedule(name, 1e-2, TOTAL, **kw)
    got_fn = TS.create_schedule(name, 1e-2, TOTAL, **kw)
    steps = range(TOTAL + 10)
    if name != "plateau":
        want = np.asarray([float(want_fn(jnp.asarray(t))) for t in steps], np.float32)
        got = np.asarray([float(got_fn(torch.tensor(t))) for t in steps], np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
        distinct = len(set(want.tolist()))
        assert distinct == 1 if name == "constant" else distinct > 3
        if "noise" in case:  # the noise really moves the rate
            plain = {k: v for k, v in kw.items() if not k.startswith(("noise", "seed"))}
            calm = np.asarray([float(TS.create_schedule(name, 1e-2, TOTAL, **plain)(t))
                               for t in steps], np.float32)
            assert np.abs(got / calm - 1).max() > 0.05
        return
    assert isinstance(got_fn, TS.PlateauSchedule)
    lrs = []
    for i, metric in enumerate(METRICS):
        for t in range(10 * i, 10 * i + 10):
            np.testing.assert_allclose(float(got_fn(t)), float(want_fn(jnp.asarray(t))),
                                       rtol=1e-6, atol=0)
            np.testing.assert_allclose(float(got_fn.warmup_fraction(t)),
                                       float(want_fn.warmup_fraction(t)), rtol=1e-6, atol=0)
            assert got_fn.current_lr(t) == pytest.approx(want_fn.current_lr(t), rel=1e-6)
        lrs.append(got_fn.step(metric))
        assert lrs[-1] == want_fn.step(metric)
        assert (got_fn.best, got_fn.bad_epochs) == (want_fn.best, want_fn.bad_epochs)
    assert lrs[0] == 1e-2 and lrs[-1] < lrs[0]
