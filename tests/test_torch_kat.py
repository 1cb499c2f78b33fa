"""KAT (the rational-KAN ViT with its pyramid adapter) against the JAX
package, on the CPU.

The JAX model's own init is filled with numpy draws and carried to the port
by ``from_jax_variables`` (the adapter has no JAX converter; flax's
per-head attention kernels are fused into the reference's ``qkv``, its
transposed-conv kernels flipped); the round trip goes the other way,
through the JAX package's ``convert_full_model``. Both sides compute in
float32. In training the port takes the JAX drop-path factors
(``DropPath`` wrapped to record each call's factor). Tolerances: outputs
within 1e-4 of the JAX output's largest magnitude, gradients within 1e-3
of each tensor's largest JAX entry plus 1e-6 of the model's largest
(``GRAD_FLOOR``), BatchNorm running statistics within 1e-4 of each
tensor's largest entry.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from segmentation_factory_tpu import convert as JCV
from segmentation_factory_tpu.models import build as jbuild
from segmentation_factory_tpu.models.backbones import kat as JK
from segmentation_factory_tpu.models.layers import common as JC
from segmentation_factory_tpu_torch import convert as PC
from segmentation_factory_tpu_torch.convert import from_jax_variables
from segmentation_factory_tpu_torch.models.backbones import kat as K
from segmentation_factory_tpu_torch.models.build import SegmentationModel

from _torch_port import (
    jax_vjp,
    random_state_dict,
    rel_close,
    torch_vjp,
    trees_close,
)
from _torch_port import two_torch_threads  # noqa: F401  (autouse)

NC, E = 5, 32
GRAD_FLOOR = 1e-6
RATE = 0.2
NAME = "kat_tiny_gelu"
TINY_CUT = (192, 4, 3)  # kat_tiny's width and heads, 4 blocks (one a tap)
# 4 images in training: the PPM's 1 x 1 scale normalises over the batch
# alone, and over 2 images its training-mode BatchNorm maps every pair to
# +-1, whose outputs and gradients are rounding (either framework's)
B_TRAIN = 4


def _normal(rng, shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


@pytest.fixture
def recorded_drop_path(monkeypatch):
    """Every active ``DropPath`` call appends its (B,) float32 factor."""
    factors = []

    def call(self, x, deterministic=True):
        if self.rate == 0.0 or deterministic:
            return x
        keep = 1.0 - self.rate
        mask = jax.random.bernoulli(self.make_rng("droppath"), keep,
                                    (x.shape[0],) + (1,) * (x.ndim - 1))
        factors.append(jnp.where(mask, 1.0 / keep, 0.0).reshape(-1).astype(jnp.float32))
        return jnp.where(mask, x / keep, jnp.zeros_like(x)).astype(x.dtype)

    monkeypatch.setattr(JC.DropPath, "__call__", call)
    return factors


# ---------------------------------------------------------------- the rational


@pytest.mark.parametrize("act", ["identity", "gelu", "swish"])
def test_rational_matches_jax(act):
    """RationalActivation at its init (8 groups of 4 channels): value and
    the gradients of a random projection with respect to ``a``, ``b`` and
    x. The identity starts with Q = 0: JAX's |Q| has gradient 1 there
    (torch's ``abs`` 0), so ``b``'s gradient is not 0 and equals JAX's."""
    port = K.RationalActivation(act)
    rng = np.random.default_rng(1)
    x = _normal(rng, (2, 5, 32), 2.0)
    cts = [_normal(rng, (2, 5, 32))]
    params = {"a": port.weight_numerator.detach().numpy(),
              "b": port.weight_denominator.detach().numpy()}
    out, gp, gx, _ = jax_vjp(JK.RationalActivation(base_act=act), {"params": params}, x, cts)
    got, got_gp, got_gx = torch_vjp(port, x, cts)
    rel_close(got[0], out)
    rel_close(got_gx, gx, 1e-3)
    trees_close({"a": got_gp["weight_numerator"], "b": got_gp["weight_denominator"]}, gp)
    if act == "identity":
        assert np.abs(gp["b"]).max() > 0 and np.abs(got_gp["weight_denominator"]).max() > 0
        q = torch.zeros(3, requires_grad=True)
        assert torch.equal(torch.autograd.grad(K.abs_jax(q).sum(), q)[0], torch.ones(3))


def test_fit_rational_equals_jax():
    """The least-squares coefficients, bit for bit."""
    for act in ("identity", "gelu", "swish"):
        for got, want in zip(K.fit_rational_to(act), JK._fit_rational_to(act)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_in,n_out", [(2, (3, 3)), (4, (6, 6)), (6, (4, 4)), (4, (6, 3))])
def test_resample_pos_embed_matches_jax(n_in, n_out):
    """``jax.image.resize``'s bicubic (Keys' a = -0.5, antialiased when it
    shrinks) of an n_in² grid of 8-wide tokens, against the JAX
    ``resample_pos_embed``: 2 -> 3, 4 -> 6, 6 -> 4 and 4 -> 6 x 3."""
    pos = _normal(np.random.default_rng(2), (n_in * n_in, 8))
    want = np.asarray(JK.resample_pos_embed(jnp.asarray(pos), n_out))
    got = K.resample_pos_embed(torch.from_numpy(pos), n_out).numpy()
    assert got.shape == (n_out[0] * n_out[1], 8)
    rel_close(got, want, 1e-6)


def test_conv_transpose_is_flax_flipped():
    """flax ``nn.ConvTranspose(k=2, s=2)`` (``SAME``) equals
    ``F.conv_transpose2d`` with the kernel ``from_jax_variables`` gives it
    (spatially flipped, (in, out, kh, kw)); unflipped, it does not."""
    rng = np.random.default_rng(3)
    x = _normal(rng, (2, 5, 4, 6))
    p = {"kernel": _normal(rng, (2, 2, 6, 7)), "bias": _normal(rng, (7,))}
    want = np.asarray(fnn.ConvTranspose(7, (2, 2), strides=(2, 2)).apply({"params": p}, x))
    sd = {}
    PC._conv_transpose(sd, "up", p)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = F.conv_transpose2d(xt, sd["up.weight"], sd["up.bias"], stride=2).permute(0, 2, 3, 1)
    rel_close(got.numpy(), want, 1e-6)
    raw = torch.from_numpy(p["kernel"].transpose(2, 3, 0, 1).copy())
    plain = F.conv_transpose2d(xt, raw, sd["up.bias"], stride=2).permute(0, 2, 3, 1)
    assert np.abs(plain.numpy() - want).max() > 1e-2


# ---------------------------------------------------------------- the model


def _filled(shapes, seed):
    """numpy draws of a JAX variables' shapes: kernels N(0, 1/fan_in),
    biases, means and ``pos_embed`` N(0, 0.1²), scales 1 + N(0, 0.1²),
    variances in [0.5, 1.5), the rationals at their fits."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if "rational" in name:
            act = "identity" if "rational1" in name else "gelu"
            a, b = JK._fit_rational_to(act)
            return np.tile(a if "'a'" in name else b, (8, 1))
        if "'var'" in name:
            return (0.5 + rng.random(leaf.shape)).astype(np.float32)
        if leaf.ndim == 1 or "pos_embed" in name:
            base = 1.0 if "scale" in name else 0.0
            return (base + 0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        if "'out'" in name:  # (heads, d, D): contracted over heads and d
            fan_in = int(np.prod(leaf.shape[:2]))
        elif "'query'" in name or "'key'" in name or "'value'" in name:  # (D, heads, d)
            fan_in = leaf.shape[0]
        return (rng.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def _pair(init_size, train):
    kw = {"drop_path_rate": RATE}
    jm = jbuild.SegmentationModel(NAME, "uperhead", NC, embed_dim=E, dtype=jnp.float32,
                                  backbone_kwargs=kw)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, init_size, init_size, 3)))
    variables = _filled(shapes, 4)
    port = SegmentationModel(NAME, "uperhead", NC, embed_dim=E, dtype=torch.float32,
                             img_size=init_size, backbone_kwargs=kw).train(train)
    port.load_state_dict(from_jax_variables(variables))
    return jm, port, variables


def _port_keys(tree, stats):
    """A JAX tree (params or their gradients) under the port's parameter
    keys (``from_jax_variables``; running statistics dropped)."""
    sd = from_jax_variables({"params": tree, "batch_stats": stats})
    return {k: v.numpy() for k, v in sd.items() if "running" not in k and "num_batches" not in k}


@pytest.mark.parametrize("size,train", [(64, False), (64, True), (96, True)])
def test_kat_uperhead_matches_jax(monkeypatch, recorded_drop_path, size, train):
    """``kat_tiny_gelu`` (192 wide, 3 heads, the adapter; its 12 blocks cut
    to 4 on both sides) + ``uperhead`` (E = 32, 5 classes), built for 64² (a
    4 x 4 ``pos_embed``): the stride-4 logits at 64² in eval and training,
    and at 96² (the embedding resampled to 6 x 6, bicubic) in training; in
    training (4 images, drop path 0.2, the JAX factors through ``noise``,
    the head's dropout off on both sides) the gradients of a random
    projection of them with respect to every parameter (``pos_embed``
    through the resample) and the image, and the head's BatchNorm
    statistics after the step."""
    monkeypatch.setitem(K.KAT_SETTINGS, "tiny", TINY_CUT)
    monkeypatch.setitem(JK.KAT_SETTINGS, "tiny", TINY_CUT)
    jm, port, variables = _pair(64, train)
    b = B_TRAIN if train else 2
    rng = np.random.default_rng(5)
    x = _normal(rng, (b, size, size, 3))
    cts = [_normal(rng, (b, size // 4, size // 4, NC))]
    if train:
        monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        kw = dict(train=True, mutable=["batch_stats"], rngs={"droppath": jax.random.PRNGKey(6)})
    else:
        kw = dict(train=False)
    out, gp, gx, extra = jax_vjp(jm, variables, x, cts, record=recorded_drop_path,
                                 resize_output=False, **kw)
    noise = None
    if train:
        it = iter(extra["record"])
        factors = torch.stack([
            torch.stack([torch.from_numpy(np.array(next(it))) for _ in range(2)])
            if blk.drop_path_rate > 0 else torch.ones((2, b)) for blk in port.backbone.blocks])
        assert next(it, None) is None and len(extra["record"]) == 2 * (TINY_CUT[1] - 1)
        noise = {"drop_path": factors, "dropout": None}
    got, got_gp, got_gx = torch_vjp(port, x, cts, resize_output=False, noise=noise)
    assert got[0].shape == (b, size // 4, size // 4, NC)
    rel_close(got[0], out)
    rel_close(got_gx, gx, 1e-3)
    trees_close(got_gp, _port_keys(gp, variables["batch_stats"]), of_largest=GRAD_FLOOR)
    if train:
        new = from_jax_variables({"params": variables["params"],
                                  "batch_stats": extra["state"]["batch_stats"]})
        for k, v in port.state_dict().items():
            if "running" in k:
                w = new[k].numpy()
                np.testing.assert_allclose(v.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                           err_msg=k)


def test_sample_noise_and_feature_sizes():
    """``sample_noise`` draws (blocks, 2, batch) factors; the adapter's
    four levels at a size 16 does not divide (the ``SAME`` patch conv: a
    ceil(side / 16) grid, times 4 and 2, halved rounding up)."""
    port = SegmentationModel(NAME, "uperhead", NC, embed_dim=E, dtype=torch.float32,
                             img_size=64, backbone_kwargs={"drop_path_rate": RATE}).train()
    f = port.sample_noise(3, torch.Generator().manual_seed(0), (64, 64))["drop_path"]
    assert tuple(f.shape) == (12, 2, 3) and torch.equal(f[0], torch.ones((2, 3)))
    with torch.no_grad():
        feats = port.eval().backbone(torch.zeros((1, 100, 70, 3)))
    assert [tuple(t.shape[1:3]) for t in feats] == port.feature_sizes(100, 70)
    assert port.feature_sizes(100, 70) == [(28, 20), (14, 10), (7, 5), (4, 3)]


def test_from_jax_variables_round_trips():
    """Port weights (``kat_tiny_gelu`` + ``uperhead``, built for 64²) ->
    the JAX tree (``convert_full_model``, the adapter's kernels unflipped
    into flax's layout here: no JAX converter names them) ->
    ``from_jax_variables`` gives the port's ``state_dict`` back bit for bit
    (dispatched as KAT by ``pos_embed``); the tree's shapes are the JAX
    model's."""
    port = SegmentationModel(NAME, "uperhead", NC, dtype=torch.float32, img_size=64)
    sd = random_state_dict(port, seed=8)
    variables = JCV.convert_full_model(sd, NAME, "uperhead")
    bb = variables["params"]["backbone"]
    for name in ("up2a", "up2b", "up1"):
        w = sd[f"backbone.{name}.weight"][:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
        bb[name] = {"kernel": w, "bias": sd[f"backbone.{name}.bias"]}
    bb["LayerNorm_0"] = JCV.t_ln(sd, "backbone.up2a_norm")
    bb["down1"] = JCV.t_conv(sd, "backbone.down1")
    jm = jbuild.SegmentationModel(NAME, "uperhead", NC, dtype=jnp.float32)
    want = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    assert (jax.tree_util.tree_map(np.shape, variables)
            == jax.tree_util.tree_map(lambda a: a.shape, dict(want)))
    back = from_jax_variables(variables)
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
