"""The backward halves of the port's kernel modules (K1b, K2b, K5b) and the
fused loss (K7f/K7b) against the JAX package's ``custom_vjp`` backwards, on
the CPU.

The JAX side runs its Pallas kernels in interpret mode
(``pltpu.force_tpu_interpret_mode()``, ``use_pallas=True``), forward and
backward; the port side runs each wrapper's plain version and autograd,
which is what a CPU tensor gets. Inputs and cotangents come from numpy,
float32 on both sides. Tolerance: every gradient within 2e-5 of its
largest reference entry (the same float32 products and sums in another
order); loss values within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from segmentation_factory_tpu.ops import pallas_attention as JA
from segmentation_factory_tpu.ops import pallas_ffn as JF
from segmentation_factory_tpu.ops import pallas_loss as JL
from segmentation_factory_tpu.ops import pallas_resize_sum as JR
from segmentation_factory_tpu_torch.ops import lowres_loss, mixffn, resize_sum, sra_attention

from _torch_port import two_torch_threads  # noqa: F401  (autouse)

REL = 2e-5


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _jax_grads(fn, args, g):
    """Value and gradients of fn in Pallas interpret mode: the kernels'
    custom_vjp backwards."""
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(fn, *map(jnp.asarray, args))
        return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _torch_grads(fn, args, g):
    xs = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fn(*xs)
    return out.detach().numpy(), [x.numpy() for x in torch.autograd.grad(out, xs,
                                                                       torch.from_numpy(g))]


def _assert_grads(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        err = np.abs(a - b).max()
        assert err <= REL * np.abs(b).max(), (i, err, np.abs(b).max())


# ---------------------------------------------------------------- K1b


@pytest.mark.parametrize("n,m", [(256, 64), (300, 16)])
def test_sra_attention_backward_matches_pallas(n, m):
    rng = np.random.default_rng(10)
    b, h, d = 2, 2, 32
    q, k, v, g = (_normal(rng, (b, s, h, d)) for s in (n, m, m, n))
    scale = d ** -0.5
    want_out, want = _jax_grads(
        lambda q, k, v: JA.sra_attention(q, k, v, scale, tile_q=128, use_pallas=True),
        [q, k, v], g)
    got_out, got = _torch_grads(lambda q, k, v: sra_attention.sra_attention(q, k, v, scale),
                                [q, k, v], g)
    _assert_grads([got_out], [want_out])
    _assert_grads(got, want)


# ---------------------------------------------------------------- K2b


@pytest.mark.parametrize("shape", [
    (2, 8, 8, 32, 128),
    (1, 8, 8, 512, 2048),  # C = 512: the JAX backward exits to its XLA recompute-VJP
])
def test_mixffn_backward_matches_pallas(shape):
    b, h, w, c, hc = shape
    rng = np.random.default_rng(11)
    args = [_normal(rng, s, sc) for s, sc in [
        ((b, h, w, c), 1.0), ((c, hc), c ** -0.5), ((hc,), 0.1), ((3, 3, 1, hc), 0.3),
        ((hc,), 0.1), ((hc, c), hc ** -0.5), ((c,), 0.1)]]
    g = _normal(rng, (b, h, w, c))
    want_out, want = _jax_grads(lambda *a: JF.mixffn_apply(*a, use_pallas=True), args, g)
    got_out, got = _torch_grads(mixffn.mixffn_apply, args, g)
    _assert_grads([got_out], [want_out])
    _assert_grads(got, want)


# ---------------------------------------------------------------- K5b


def test_resize_sum_backward_matches_pallas():
    rng = np.random.default_rng(12)
    levels = [_normal(rng, (1, s, s, 128)) for s in (2, 4, 8, 16)]  # top level first
    g = _normal(rng, (1, 16, 16, 128))
    want_out, want = _jax_grads(lambda *z: JR.resize_sum(list(z), use_pallas=True), levels, g)
    got_out, got = _torch_grads(lambda *z: resize_sum.resize_sum(list(z)), levels, g)
    _assert_grads([got_out], [want_out])
    _assert_grads(got, want)


# ---------------------------------------------------------------- K7f / K7b


def _loss_batch(seed, nc=19):
    rng = np.random.default_rng(seed)
    lo = _normal(rng, (1, 4, 128, nc), 2.0)  # the fused JAX path: W_lo % 128 == 0, s = 4
    lab = rng.integers(0, nc, (1, 16, 512)).astype(np.int32)
    lab[:, :3] = 255  # void rows
    lab[0, -1, :7] = 255
    return lo, lab


@pytest.mark.parametrize("loss_type", ["ce", "ohem"])
@pytest.mark.parametrize("use_dice", [True, False])
def test_fused_loss_matches_pallas(loss_type, use_dice):
    lo, lab = _loss_batch(13)
    with pltpu.force_tpu_interpret_mode():
        want, dwant = jax.value_and_grad(lambda x: JL.lowres_criterion(
            x, jnp.asarray(lab), 255, use_dice=use_dice, loss_type=loss_type,
            use_pallas=True))(jnp.asarray(lo))
    x = torch.from_numpy(lo).requires_grad_()
    got = lowres_loss.lowres_criterion(x, torch.from_numpy(lab), 255, use_dice=use_dice,
                                       loss_type=loss_type)
    (dgot,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    _assert_grads([dgot.numpy()], [np.asarray(dwant)])


def test_fused_loss_class_weights_and_two_classes():
    # class weights ride the fused CE path only (pallas_loss.py:598-612)
    lo, lab = _loss_batch(14, nc=2)
    with pltpu.force_tpu_interpret_mode():
        want, dwant = jax.value_and_grad(lambda x: JL.lowres_criterion(
            x, jnp.asarray(lab), 255, use_dice=True, loss_type="ce", use_pallas=True,
            class_weights=(1.0, 2.0)))(jnp.asarray(lo))
    x = torch.from_numpy(lo).requires_grad_()
    got = lowres_loss.lowres_criterion(x, torch.from_numpy(lab), 255, use_dice=True,
                                       loss_type="ce", class_weights=(1.0, 2.0))
    (dgot,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    _assert_grads([dgot.numpy()], [np.asarray(dwant)])


def test_loss_map_and_dice_partials_match_jax_forward_kernel():
    lo, lab = _loss_batch(15)
    lo_t, lab_p = JL._prep(jnp.asarray(lo), jnp.asarray(lab), 4)
    with pltpu.force_tpu_interpret_mode():
        loss_map, parts = JL._forward(lo_t, lab_p, 4, 255, JL._pick_tile(4, 4, 24, 128))
    # undo the phase-blocked (B, H, s, W_lo) layout of the TPU kernel
    loss_map = np.asarray(loss_map).transpose(0, 1, 3, 2).reshape(lab.shape)
    parts = np.asarray(parts)[:, :, :19].sum(-1)
    got_map, got_parts = lowres_loss.lowres_loss_fwd(torch.from_numpy(lo), torch.from_numpy(lab))
    valid = lab != 255  # the TPU kernel picks class 0's logit at void pixels
    np.testing.assert_allclose(got_map.numpy()[valid], loss_map[valid], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_parts.numpy(), parts, rtol=1e-5, atol=1e-4)


def test_loss_backward_matches_jax_backward_kernel():
    # K7b alone: the same weight map (zero at void pixels, as the glue makes
    # it) and dice coefficients into the TPU kernel and the plain version
    lo, lab = _loss_batch(16)
    rng = np.random.default_rng(17)
    wmap = rng.random(lab.shape).astype(np.float32) * (lab != 255)
    dcoef = _normal(rng, (1, 2, 19), 0.01)
    lo_t, lab_p = JL._prep(jnp.asarray(lo), jnp.asarray(lab), 4)
    wmap_p = jnp.asarray(wmap).reshape(1, 16, 128, 4).transpose(0, 1, 3, 2)
    dc = jnp.broadcast_to(jnp.pad(jnp.asarray(dcoef), ((0, 0), (0, 0), (0, 5)))[..., None],
                          (1, 2, 24, 128))
    with pltpu.force_tpu_interpret_mode():
        dlo_t = JL._backward(lo_t, lab_p, wmap_p, dc, 4, 255, JL._pick_tile(4, 4, 24, 128))
    want = np.asarray(dlo_t)[:, :, :19, :].transpose(0, 1, 3, 2)
    got = lowres_loss.lowres_loss_bwd(torch.from_numpy(lo), torch.from_numpy(lab),
                                      torch.from_numpy(wmap), torch.from_numpy(dcoef))
    _assert_grads([got.numpy()], [want])


# ---------------------------------------------------------------- no fallback


def test_backward_wrappers_refuse_non_cuda_tensors():
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    q = meta(1, 64, 1, 32)
    with pytest.raises(ValueError, match="CUDA"):
        sra_attention.sra_attention_bwd(q, q, q, q, meta(1, 1, 64), q, 1.0)
    y = meta(1, 8, 8, 32)
    with pytest.raises(ValueError, match="CUDA"):
        mixffn.mixffn_bwd(y, meta(32, 128), meta(128), meta(3, 3, 1, 128), meta(128),
                          meta(128, 32), y)
    with pytest.raises(ValueError, match="CUDA"):
        resize_sum.resize_sum_bwd(y, [(1, 4, 4, 32), (1, 8, 8, 32)])
    lo, lab = meta(1, 4, 4, 19), torch.empty((1, 16, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        lowres_loss.lowres_loss_fwd(lo, lab)
    with pytest.raises(ValueError, match="CUDA"):
        lowres_loss.lowres_loss_bwd(lo, lab, meta(1, 16, 16), meta(1, 2, 19))
