"""20-step loss trajectories of the port's ``train_step`` against the JAX
package's on the CPU, CE + dice and OHEM + dice, MiT-B0 + SegFormerHead
from the same numpy weights on the same batches (``_torch_train``).

Tolerance: 2e-4 relative per step (twenty updates of a whole MiT-B0
amplify reordered float32 sums through Adam's normalisation), 1e-5 on the
first step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from segmentation_factory_tpu import schedule as JS
from segmentation_factory_tpu.engine import steps as jsteps
from segmentation_factory_tpu.engine.state import TrainState
from segmentation_factory_tpu.engine.state import create_optimizer as j_create_optimizer
from segmentation_factory_tpu.models import build_model as jax_build_model
from segmentation_factory_tpu_torch import schedule
from segmentation_factory_tpu_torch.engine import create_optimizer, train_step

from _torch_port import two_torch_threads  # noqa: F401  (autouse)
from _torch_train import NC, NO_NOISE, batches, no_noise, port_model, weights  # noqa: F401

STEPS = 20
LR = 2e-3


@pytest.mark.parametrize("loss_type", ["ce", "ohem"])
def test_twenty_step_loss_trajectory_matches_jax(weights, loss_type):
    """MiT-B0 + SegFormerHead at 64², batch 2, float32, CE or OHEM plus dice,
    AdamW + AGC 0.02 + weight decay 1e-4 on a cosine schedule with warm-up,
    from the same weights on the same batches; drop-path and dropout off on
    both sides (JAX rates 0; port factors and mask of ones), BatchNorm on
    batch statistics."""
    sd, variables = weights
    data = batches(STEPS, 24)
    kw = dict(warmup_steps=5, warmup_lr_init=1e-6, min_lr=1e-5)

    jmodel = jax_build_model("mit_b0", "segformerhead", NC, dtype=jnp.float32, **NO_NOISE)
    sched = JS.create_schedule("cosine", LR, STEPS, **kw)
    tx = j_create_optimizer("adamw", sched, weight_decay=1e-4, clip_grad=0.02, clip_mode="agc",
                            params=variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]), apply_fn=jmodel.apply, tx=tx)
    step = jax.jit(functools.partial(jsteps.train_step, loss_type=loss_type, use_dice=True,
                                     learning_rate_fn=sched))
    key = jax.random.PRNGKey(0)
    want = []
    for img, lbl in data:
        state, metrics = step(state, {"image": jnp.asarray(img), "label": jnp.asarray(lbl)}, key)
        want.append(float(metrics["loss"]))

    model = port_model(sd)
    opt = create_optimizer("adamw", schedule.create_schedule("cosine", LR, STEPS, **kw),
                           weight_decay=1e-4, clip_grad=0.02, clip_mode="agc",
                           params=model.named_parameters())
    got = [float(train_step(model, opt, {"image": img, "label": lbl}, noise=no_noise(model),
                            loss_type=loss_type, use_dice=True)["loss"])
           for img, lbl in data]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert got[-1] < got[0]
