"""Mask2Former's mask-classification loss (``losses_mask.py``) and its
training route against the JAX package, on the CPU.

Float32 throughout. ``semantic_targets`` within 1e-6 (the area mean, and
``jax.image.resize``'s antialiased linear at a non-integer ratio, both
reordered float32 sums); pair costs within 1e-5 of their largest entry;
``hungarian_match`` equal to optax's assignment (scipy's exact optimum on
random costs, which have one); ``greedy_match`` equal; ``mask2former_loss``
and its gradients within 1e-5 / 1e-4 of the JAX value's / gradient's
largest entry. Two 10-step trajectories, CE + dice on the semantic
log-probabilities and ``mask_loss=True`` on the matched masks, against the
JAX ``train_step`` from the same weights on the same batches: a narrow
MiT (one block a stage) with a Mask2Former head of width 128, 1 pixel-decoder
layer, 2 decoder layers and 8 queries, AdamW (weight decay 1e-4, no
gradient clipping: AGC is the optimizer's, held in
tests/test_torch_train.py) on the cosine schedule; the losses within 2e-4
relative (1e-5 at the first step). The mask-loss trajectory runs at rate
1e-4: at 2e-3 it is chaotic on either framework alone (a switch of the
Hungarian matching turns a rounding difference into a different loss).
"""

import functools
from typing import Any

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_factory_tpu import losses_mask as JLM
from segmentation_factory_tpu import schedule as JS
from segmentation_factory_tpu.engine import steps as jsteps
from segmentation_factory_tpu.engine.state import TrainState
from segmentation_factory_tpu.engine.state import create_optimizer as j_create_optimizer
from segmentation_factory_tpu.models.backbones.mit import MiT as JMiT
from segmentation_factory_tpu.models.heads.mask2former import Mask2FormerHead as JHead
from segmentation_factory_tpu.models.layers import common as JC
from segmentation_factory_tpu_torch import build_model, losses_mask, schedule
from segmentation_factory_tpu_torch.convert import from_jax_variables
from segmentation_factory_tpu_torch.engine import create_optimizer, train_step
from segmentation_factory_tpu_torch.models.backbones.mit import MiT

from _m2f import no_noise, random_tree
from _torch_port import two_torch_threads  # noqa: F401  (autouse)

NC = 5


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _labels(rng, b, h, w, nc=NC):
    """Random classes with void rows, labels outside [0, nc) and, in the
    last image, an absent class."""
    lab = rng.integers(0, nc, (b, h, w)).astype(np.int32)
    lab[:, :2] = 255
    lab[0, -1, :3] = nc + 1
    lab[-1][lab[-1] == nc - 1] = 0
    return lab


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("hw,pred", [((32, 24), (8, 6)), ((30, 22), (8, 6)), ((16, 16), (16, 16))],
                         ids=["integer", "non_integer", "same"])
def test_semantic_targets_match_jax(hw, pred):
    lab = _labels(np.random.default_rng(1), 2, *hw)
    tm, present = losses_mask.semantic_targets(torch.from_numpy(lab), NC, pred)
    jtm, jpresent = jax.jit(functools.partial(JLM.semantic_targets, num_classes=NC,
                                              pred_hw=pred))(lab)
    assert tm.shape == (2, NC, *pred)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jtm), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(present.numpy(), np.asarray(jpresent))
    assert not present[-1, -1]


def _outputs(rng, b=2, q=6, hw=(8, 6), aux=2):
    def one():
        return {"pred_logits": _normal(rng, (b, q, NC + 1)),
                "pred_masks": _normal(rng, (b, q, *hw), 3.0)}

    out = one()
    out["aux_outputs"] = [one() for _ in range(aux)]
    return out


def test_pair_costs_match_jax():
    rng = np.random.default_rng(2)
    out = _outputs(rng)
    lab = _labels(rng, 2, 32, 24)
    tm, _ = losses_mask.semantic_targets(torch.from_numpy(lab), NC, (8, 6))
    got = losses_mask._pair_costs(torch.from_numpy(out["pred_logits"]),
                                  torch.from_numpy(out["pred_masks"]), tm)
    want = jax.jit(JLM._pair_costs)(out["pred_logits"], out["pred_masks"], tm.numpy())
    assert got.shape == (2, 6, NC)
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("q,c", [(12, 7), (7, 7), (5, 9)])
def test_hungarian_match_equals_optax(q, c):
    """Random costs with absent classes, more, as many or fewer queries than
    classes; the port's one-copy batch gives each matrix its own answer."""
    rng = np.random.default_rng(q * 100 + c)
    costs = _normal(rng, (6, q, c))
    valid = rng.random((6, c)) > 0.3
    jmatch = jax.jit(JLM.hungarian_match)
    want = np.stack([np.asarray(jmatch(cm, v)) for cm, v in zip(costs, valid)])
    got = losses_mask.hungarian_match(torch.from_numpy(costs), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    one = losses_mask.hungarian_match(torch.from_numpy(costs[0]), torch.from_numpy(valid[0]))
    np.testing.assert_array_equal(one.numpy(), want[0])


def test_greedy_match_equals_jax():
    rng = np.random.default_rng(3)
    jmatch = jax.jit(JLM.greedy_match)
    for q, c in ((12, 7), (4, 6)):
        cost = _normal(rng, (3, q, c))
        valid = rng.random((3, c)) > 0.3
        got = losses_mask.greedy_match(torch.from_numpy(cost), torch.from_numpy(valid))
        want = np.stack([np.asarray(jmatch(m, v)) for m, v in zip(cost, valid)])
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("matcher", ["hungarian", "greedy"])
def test_mask2former_loss_and_gradients_match_jax(matcher):
    """The final prediction and two aux outputs; labels at 4x the masks'
    size (the exact area mean) with void pixels, labels outside [0, C) and
    an absent class."""
    rng = np.random.default_rng(4)
    out = _outputs(rng)
    lab = _labels(rng, 2, 32, 24)

    def jloss(o):
        return JLM.mask2former_loss(o, lab, NC, matcher=matcher)

    want, want_g = jax.jit(jax.value_and_grad(jloss))(out)
    tout = jax.tree_util.tree_map(lambda a: torch.from_numpy(a).requires_grad_(), out)
    got = losses_mask.mask2former_loss(tout, torch.from_numpy(lab), NC, matcher=matcher)
    leaves = jax.tree_util.tree_leaves(tout)
    grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for g, w in zip(grads, jax.tree_util.tree_leaves(want_g)):
        _close(g.numpy(), w, 1e-4)


# ---------------------------------------------------------------- trajectories

DIMS, DEPTHS = (32, 64, 160, 256), (1, 1, 1, 1)
HEAD = dict(num_queries=8, pixel_layers=1, decoder_layers=2)
STEPS = 10
LR = {False: 2e-3, True: 1e-4}  # by mask_loss
SCHED = dict(warmup_steps=3, warmup_lr_init=1e-6, min_lr=1e-5)


class _JaxNarrow(fnn.Module):
    """A narrow MiT and the Mask2Former head as the JAX ``SegmentationModel``
    composes them (the registry has no narrow MiT); drop-path off."""

    nc: int
    mask_loss: bool = False
    dtype: Any = jnp.float32

    @fnn.compact
    def __call__(self, x, train: bool = False, resize_output: bool = True):
        feats = JMiT(DIMS, DEPTHS, drop_path_rate=0.0, dtype=self.dtype, name="backbone")(
            x, train=train)
        out = JHead(DIMS, self.nc, embed_dim=128, mask_loss=self.mask_loss, dtype=self.dtype,
                    name="decode_head", **HEAD)(feats, train=train)
        if isinstance(out, dict) or not resize_output:
            return out
        return JC.resize(out, (x.shape[1], x.shape[2]))


@pytest.fixture(scope="module")
def narrow():
    """The narrow model's JAX params (random, from its shapes) and the
    batches of both trajectories."""
    shapes = jax.eval_shape(_JaxNarrow(NC).init, jax.random.PRNGKey(0),
                            jnp.zeros((2, 64, 64, 3)))
    params = random_tree(shapes["params"], 5)
    rng = np.random.default_rng(6)
    batches = [(_normal(rng, (2, 64, 64, 3)), _labels(rng, 2, 64, 64)) for _ in range(STEPS)]
    return params, batches


@pytest.mark.parametrize("mask_loss", [False, True], ids=["ce_dice", "mask_loss"])
def test_ten_step_trajectory_matches_jax(narrow, mask_loss):
    params, batches = narrow
    jm = _JaxNarrow(NC, mask_loss)
    sched = JS.create_schedule("cosine", LR[mask_loss], STEPS, **SCHED)
    tx = j_create_optimizer("adamw", sched, weight_decay=1e-4, clip_grad=None, params=params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                       opt_state=tx.init(params), apply_fn=jm.apply, tx=tx)
    step = jax.jit(functools.partial(jsteps.train_step, loss_type="ce", use_dice=True,
                                     learning_rate_fn=sched))
    want = []
    for img, lbl in batches:
        state, metrics = step(state, {"image": img, "label": lbl}, jax.random.PRNGKey(0))
        want.append(float(metrics["loss"]))

    model = build_model("mit_b0", "mask2formerhead", NC, embed_dim=128, dtype=torch.float32,
                        device="cpu", head_kwargs=dict(HEAD, mask_loss=mask_loss))
    model.backbone = MiT(DIMS, DEPTHS, dtype=torch.float32)
    model.load_state_dict(from_jax_variables({"params": params}))
    opt = create_optimizer("adamw", schedule.create_schedule("cosine", LR[mask_loss], STEPS,
                                                             **SCHED),
                           weight_decay=1e-4, clip_grad=None, params=model.named_parameters())
    got = [float(train_step(model, opt, {"image": img, "label": lbl}, noise=no_noise(model, 2),
                            loss_type="ce", use_dice=True)["loss"])
           for img, lbl in batches]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert all(np.isfinite(got))
