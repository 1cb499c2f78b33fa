"""The port's losses (``segmentation_factory_tpu_torch.losses``) against the
JAX package's ``losses.py``, in value and gradient, on the CPU.

Logits and labels come from numpy (void pixels and an out-of-range label
included); both sides compute in float32. Tolerance: values and every
gradient entry within 1e-5 relative (plus 1e-7 absolute for entries near
zero): the same float32 expressions in another summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_factory_tpu import losses as JLS
from segmentation_factory_tpu_torch import losses as L

TOL = dict(rtol=1e-5, atol=1e-7)
NC = 6


def _batch(seed, shape=(2, 12, 10), nc=NC):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(*shape, nc)) * 2.0).astype(np.float32)
    labels = rng.integers(0, nc, shape).astype(np.int32)
    labels[:, :2] = 255
    labels[0, -1, 0] = nc + 1  # valid, outside [0, C): an all-zero one-hot row
    return logits, labels


def _both(jfn, tfn, logits, labels):
    want, dwant = jax.value_and_grad(lambda x: jfn(x, jnp.asarray(labels)))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = tfn(x, torch.from_numpy(labels))
    (dgot,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(dgot.numpy(), np.asarray(dwant), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(dwant)).max())


@pytest.mark.parametrize("name", sorted(JLS.LOSSES))
def test_registered_losses_match_jax(name):
    logits, labels = _batch(0)
    _both(lambda x, y: JLS.get_loss(name)(x, y, ignore_index=255),
          lambda x, y: L.get_loss(name)(x, y, ignore_index=255), logits, labels)


@pytest.mark.parametrize("kw", [dict(class_weights=(1.0, 2.0, 0.5, 1.0, 3.0, 1.0)),
                                dict(label_smoothing=0.1)])
def test_cross_entropy_options_match_jax(kw):
    logits, labels = _batch(1)
    _both(lambda x, y: JLS.cross_entropy(x, y, 255, **kw),
          lambda x, y: L.cross_entropy(x, y, 255, **kw), logits, labels)


def test_ohem_keeps_at_least_n_min_hardest():
    # a batch where few pixels pass the -log(0.7) threshold: the k-th value
    # floor decides the keep-set
    logits, labels = _batch(2)
    rng = np.random.default_rng(3)
    logits = np.where(rng.random(logits.shape[:-1])[..., None] < 0.9,
                      np.eye(NC, dtype=np.float32)[labels.clip(0, NC - 1)] * 8.0, logits)
    logits = logits.astype(np.float32)
    _both(lambda x, y: JLS.ohem_cross_entropy(x, y, 255),
          lambda x, y: L.ohem_cross_entropy(x, y, 255), logits, labels)


@pytest.mark.parametrize("k", [1, 7, 50, 120])
def test_kth_largest_matches_bit_search(k):
    rng = np.random.default_rng(4)
    x = rng.normal(size=120).astype(np.float32)
    x[::7] = -np.inf  # void pixels
    x[3] = x[4]  # a tie
    want = float(JLS.kth_largest(jnp.asarray(x), jnp.asarray(k)))
    assert L.kth_largest(torch.from_numpy(x), torch.tensor(k)).item() == want
    assert L.kth_largest(torch.from_numpy(x), k).item() == want


def test_dice_empty_set_rule_matches_jax():
    # image 1 has no pixel of class 2 in its labels: the empty-set rule and
    # the per-image sums decide the value
    logits, labels = _batch(5)
    labels[1][labels[1] == 2] = 3
    logits[1, ..., 2] = -30.0
    _both(lambda x, y: JLS.dice_loss(x, y, 255), lambda x, y: L.dice_loss(x, y, 255),
          logits, labels)


@pytest.mark.parametrize("loss_type", ["ce", "ohem", "focal", "dicebce"])
@pytest.mark.parametrize("use_dice", [True, False])
def test_criterion_matches_jax(loss_type, use_dice):
    logits, labels = _batch(6)
    _both(lambda x, y: JLS.criterion(x, y, 255, use_dice=use_dice, loss_type=loss_type),
          lambda x, y: L.criterion(x, y, 255, use_dice=use_dice, loss_type=loss_type),
          logits, labels)


@pytest.mark.parametrize("loss_type", ["ce", "ohem", "focal", "tversky"])
def test_criterion_low_resolution_branch_matches_jax(loss_type):
    # head-resolution logits, full-resolution labels (losses.py:250-256): CE
    # and OHEM take the fused path (the plain K7f version here), the others
    # resize -> criterion; the JAX side runs its XLA composition on the CPU
    rng = np.random.default_rng(7)
    logits = (rng.normal(size=(2, 6, 5, NC)) * 2.0).astype(np.float32)
    labels = rng.integers(0, NC, (2, 24, 20)).astype(np.int32)
    labels[:, :3] = 255
    _both(lambda x, y: JLS.criterion(x, y, 255, use_dice=True, loss_type=loss_type),
          lambda x, y: L.criterion(x, y, 255, use_dice=True, loss_type=loss_type),
          logits, labels)


def test_unknown_loss_name_lists_the_registry():
    with pytest.raises(KeyError, match="available"):
        L.get_loss("nope")
    assert sorted(L.LOSSES) == sorted(JLS.LOSSES)
