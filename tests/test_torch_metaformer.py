"""The MetaFormer family (IdentityFormer, RandFormer, PoolFormerV2,
ConvFormer, CAFormer) against the JAX package, on the CPU.

Weights are numpy, drawn for the port's reference-layout ``state_dict``
(``_torch_port.random_state_dict``) and carried to the JAX tree by the JAX
package's converters (``convert_convformer``, ``convert_poolformer_like``);
RandomMixing's matrix, which no JAX converter names, goes into the JAX
``constants`` by hand. Models are narrow (dims (32, 32, 64, 64), depths
(1, 1, 2, 1): stage 3 has 2 heads of 32 over 16 tokens at 64²) except one
registered full-width model. Tolerances: float32 outputs within 1e-4 of the
JAX output's largest magnitude, gradients within 1e-3 of each parameter's
largest JAX entry; a 5-step loss trajectory within 2e-4 relative.
"""

import functools
from typing import Any

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_factory_tpu import schedule as JS
from segmentation_factory_tpu.convert import (
    convert_convformer,
    convert_full_model,
    convert_poolformer_like,
    convert_uperhead,
)
from segmentation_factory_tpu.engine import steps as jsteps
from segmentation_factory_tpu.engine.state import TrainState
from segmentation_factory_tpu.engine.state import create_optimizer as j_create_optimizer
from segmentation_factory_tpu.models import build_model as jax_build_model
from segmentation_factory_tpu.models.backbones import metaformer as JM
from segmentation_factory_tpu.models.heads.upernet import UPerHead as JUPerHead
from segmentation_factory_tpu.models.layers import common as JC
from segmentation_factory_tpu.registry import BACKBONES as J_BACKBONES
from segmentation_factory_tpu_torch import build_model, schedule
from segmentation_factory_tpu_torch.convert import from_jax_variables
from segmentation_factory_tpu_torch.engine import create_optimizer, train_step
from segmentation_factory_tpu_torch.models.backbones import metaformer as M
from segmentation_factory_tpu_torch.models.build import SegmentationModel
from segmentation_factory_tpu_torch.models.layers import CastLayerNorm
from segmentation_factory_tpu_torch.registry import BACKBONES

from _torch_port import (
    jax_vjp,
    jit_apply,
    load_numpy,
    random_state_dict,
    rel_close,
    strip,
    torch_vjp,
    trees_close,
)
from _torch_port import two_torch_threads  # noqa: F401  (autouse)

DIMS, DEPTHS = (32, 32, 64, 64), (1, 1, 2, 1)
SIZE = 64
FAMILIES = list(M.FAMILY_MIXERS)


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _mixing(n, seed):
    """A row-softmax (n, n) float32 matrix, as RandomMixing holds."""
    u = np.random.default_rng(seed).random((n, n))
    e = np.exp(u - u.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _narrow(family, seed):
    """The narrow port backbone of ``family`` (float32, built for 64²) with
    seeded weights, RandomMixing's matrices row-softmax."""
    norm = "ln" if family in M.CONV_FAMILIES else "mln"
    port = M.MetaFormer(DIMS, DEPTHS, M.FAMILY_MIXERS[family], norm, dtype=torch.float32,
                        img_size=SIZE)
    sd = random_state_dict(port, seed)
    for k, v in sd.items():
        if k.endswith("random_matrix"):
            sd[k] = _mixing(v.shape[0], seed)
    return load_numpy(port, sd), sd


def _jax_tree(family, sd, prefix=""):
    """The JAX params (and RandomMixing's constants) of a port
    ``state_dict`` of ``family``'s backbone."""
    bb = strip(sd, prefix)
    if family in M.CONV_FAMILIES:
        params = convert_convformer(bb, DEPTHS, M.FAMILY_MIXERS[family])
    else:
        params = convert_poolformer_like(bb, DEPTHS)
    consts = {}
    for k, v in bb.items():
        if k.endswith("random_matrix"):
            _, i, j = k.split(".")[:3]
            consts[f"block{i}_{j}"] = {"token_mixer": {"mix": np.asarray(v)}}
    return params, consts


def _jax_metaformer(family, dtype=jnp.float32, **kwargs):
    return JM.MetaFormer(dims=DIMS, depths=DEPTHS, mixers=JM._FAMILY_MIXERS[family],
                         block_norm="ln" if family in JM._CONV_FAMILIES else "mln", dtype=dtype,
                         **kwargs)


# ---------------------------------------------------------------- modules


def _sepconv_tree(sd):
    return {"pw1": {"kernel": sd["pwconv1.weight"].T},
            "act1": {"scale": sd["act1.scale"], "bias": sd["act1.bias"]},
            "dw": {"kernel": sd["dwconv.weight"].transpose(2, 3, 1, 0)},
            "pw2": {"kernel": sd["pwconv2.weight"].T}}


MODULES = {
    # name: (port module, JAX module, port state_dict -> JAX params, channels)
    "star_relu": (lambda: M.StarReLU(), lambda: JM.StarReLU(),
                  lambda sd: {"scale": sd["scale"], "bias": sd["bias"]}, 16),
    "modified_layer_norm": (lambda: M.ModifiedLayerNorm(16), lambda: JM.ModifiedLayerNorm(),
                            lambda sd: {"scale": sd["weight"]}, 16),
    "scale_only_layer_norm": (lambda: CastLayerNorm(16, torch.float32, bias=False),
                              lambda: fnn.LayerNorm(use_bias=False, dtype=jnp.float32),
                              lambda sd: {"scale": sd["weight"]}, 16),
    "pooling": (lambda: M.Pooling(), lambda: JM.Pooling(), lambda sd: {}, 16),
    "sepconv": (lambda: M.SepConv(16, torch.float32), lambda: JM.SepConv(dtype=jnp.float32),
                _sepconv_tree, 16),
    "attention": (lambda: M.VanillaAttention(64, torch.float32),
                  lambda: JM.VanillaAttention(dtype=jnp.float32),
                  lambda sd: {"Dense_0": {"kernel": sd["qkv.weight"].T},
                              "Dense_1": {"kernel": sd["proj.weight"].T}}, 64),
}


@pytest.mark.parametrize("name", list(MODULES))
def test_module_matches_jax(name):
    """Each block part on a (2, 5, 7, C) map (the attention 2 heads over 35
    tokens), forward and the gradients of a random projection of its
    output with respect to its parameters and input."""
    make_port, make_jax, to_jax, c = MODULES[name]
    port = make_port()
    sd = random_state_dict(port, seed=1)
    load_numpy(port, sd)
    rng = np.random.default_rng(2)
    x = _normal(rng, (2, 5, 7, c))
    ct = _normal(rng, (2, 5, 7, c))
    out, gp, gx, _ = jax_vjp(make_jax(), {"params": to_jax(sd)}, x, [ct])
    (got,), got_gp, got_gx = torch_vjp(port, x, [ct])
    rel_close(got, out)
    rel_close(got_gx, gx, 1e-3)
    if sd:
        trees_close(to_jax(got_gp), gp)


@pytest.mark.parametrize("side", [6, 9, 4])
def test_random_mixing_resamples_as_jax(side):
    """RandomMixing initialised on a 6 x 6 grid, called at it, at 9 x 9 and
    at 4 x 4: the matrix resized over its four grid axes (antialiased when
    it shrinks) and its rows renormalised as ``jax.image.resize`` and the
    JAX module do; forward and the input's gradient."""
    port = M.RandomMixing(36)
    m = _mixing(36, 3)
    port.random_matrix.copy_(torch.from_numpy(m))
    rng = np.random.default_rng(4)
    x = _normal(rng, (2, side, side, 8))
    ct = _normal(rng, (2, side, side, 8))
    out, _, gx, _ = jax_vjp(JM.RandomMixing(), {"params": {}, "constants": {"mix": m}}, x, [ct])
    (got,), _, got_gx = torch_vjp(port, x, [ct])
    rel_close(got, out)
    rel_close(got_gx, gx, 1e-3)


def test_resample_weights_match_jax_image_resize():
    """The per-axis weights against ``jax.image.resize`` of the identity,
    shrinking (antialiased) and growing."""
    for n_in, n_out in ((6, 4), (8, 3), (6, 9)):
        want = np.asarray(jax.image.resize(jnp.eye(n_in), (n_out, n_in), "bilinear"))
        rel_close(M.resample_weights(n_in, n_out).numpy(), want, 1e-6)


# ---------------------------------------------------------------- backbones


@pytest.mark.parametrize("family", FAMILIES)
def test_narrow_backbone_matches_jax(family):
    """Each family's narrow backbone at 64², its five mixers among them:
    the four features and the gradients of a random projection of them
    with respect to every parameter and the image."""
    port, sd = _narrow(family, seed=5)
    params, consts = _jax_tree(family, sd)
    rng = np.random.default_rng(6)
    x = _normal(rng, (2, SIZE, SIZE, 3))
    sides = M.stage_sides(SIZE)
    cts = [_normal(rng, (2, s, s, c)) for s, c in zip(sides, DIMS)]
    variables = {"params": params, **({"constants": consts} if consts else {})}
    out, gp, gx, _ = jax_vjp(_jax_metaformer(family), variables, x, cts)
    got, got_gp, got_gx = torch_vjp(port, x, cts)
    assert [g.shape for g in got] == [o.shape for o in out]
    for g, o in zip(got, out):
        rel_close(g, o)
    rel_close(got_gx, gx, 1e-3)
    trees_close(_jax_tree(family, {**sd, **got_gp})[0], gp)


@pytest.mark.parametrize("family", ["poolformerv2", "randformer", "caformer"])
def test_narrow_backbone_bf16_within_twice_jax_bf16(family):
    """bfloat16 compute: the features' dtypes are the JAX module's (a
    PoolFormerV2 stream turns float32 after its first block: the pooling
    divides by a float32 count), and the port's error from the JAX float32
    features is at most twice the JAX bfloat16 features' own (the port's
    pooling sums in float32 on the card, flax in bfloat16)."""
    _, sd = _narrow(family, seed=13)
    norm = "ln" if family in M.CONV_FAMILIES else "mln"
    port = load_numpy(M.MetaFormer(DIMS, DEPTHS, M.FAMILY_MIXERS[family], norm,
                                   dtype=torch.bfloat16, img_size=SIZE), sd)
    params, consts = _jax_tree(family, sd)
    variables = {"params": params, **({"constants": consts} if consts else {})}
    x = _normal(np.random.default_rng(14), (2, SIZE, SIZE, 3))
    want = {name: jit_apply(_jax_metaformer(family, dt), variables, jnp.asarray(x))
            for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16))}
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert [str(g.dtype).split(".")[-1] for g in got] == [str(w.dtype) for w in want["bf16"]]
    for g, w32, w16 in zip(got, want["f32"], want["bf16"]):
        w32 = np.asarray(w32)
        err = np.abs(g.float().numpy() - w32).max()
        err_jax = np.abs(np.asarray(w16, np.float32) - w32).max()
        assert np.isfinite(err) and err <= 2 * err_jax, (err, err_jax)


def test_from_jax_variables_both_ways():
    """Port weights -> the JAX converters -> ``from_jax_variables`` gives
    the port's ``state_dict`` back, RandomMixing's matrix through the
    ``constants``, for a CAFormer and a RandFormer backbone (with
    UPerHead's weights beside them)."""
    from segmentation_factory_tpu_torch.models.heads.upernet import UPerHead

    head = UPerHead(DIMS, 5, embed_dim=16, dtype=torch.float32)
    hsd = {f"decode_head.{k}": v for k, v in random_state_dict(head, 7).items()}
    hp, hs = convert_uperhead(strip(hsd, "decode_head."))
    for family in ("caformer", "randformer"):
        _, bsd = _narrow(family, seed=8)
        sd = {**{f"backbone.{k}": v for k, v in bsd.items()}, **hsd}
        params, consts = _jax_tree(family, sd, "backbone.")
        back = from_jax_variables({"params": {"backbone": params, "decode_head": hp},
                                   "batch_stats": {"decode_head": hs},
                                   "constants": {"backbone": consts}})
        assert set(back) == set(sd)
        for k, v in back.items():
            np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def test_registry_names_equal_jax():
    """The port registers the JAX registry's MetaFormer names (23 variants
    and 32 weight-tag aliases, ``caformer_m364_in21k`` among them), its 8
    ConvNeXtV2 and its 3 ResNet names, and the ``deeplabv3`` head;
    ``frozen_bn`` and an unported family raise "not ported"."""
    from segmentation_factory_tpu.registry import HEADS as J_HEADS
    from segmentation_factory_tpu_torch.registry import HEADS, get_backbone, get_head

    fams = tuple(M.FAMILY_MIXERS) + ("convnextv2", "resnet")
    pick = lambda names: sorted(n for n in names if n.split("_")[0].startswith(fams))  # noqa: E731
    get_backbone("mit_b0")  # imports the zoo
    ours, theirs = pick(BACKBONES), pick(J_BACKBONES)
    assert ours == theirs and len(ours) == 55 + 8 + 3
    assert "caformer_m364_in21k" in ours and "deeplabv3" in HEADS and "deeplabv3" in J_HEADS
    with pytest.raises(NotImplementedError, match="not ported"):
        get_backbone("resnet50", frozen_bn=True)
    with pytest.raises(NotImplementedError, match="not ported"):
        get_head("maskrcnnsegmentationhead")


def test_caformer_s18_uperhead_full_width_matches_jax():
    """The registered ``caformer_s18`` + ``uperhead`` at full width (E = 128,
    150 classes) at 64², float32 logits: stage 3 runs 5 heads (of 32) over
    16 tokens, stage 4 8 heads over 4."""
    port = SegmentationModel("caformer_s18", "uperhead", 150, embed_dim=128,
                             dtype=torch.float32, img_size=SIZE).eval()
    sd = random_state_dict(port, seed=9)  # every tensor replaced: no seeded init needed
    load_numpy(port, sd)
    variables = convert_full_model(sd, "caformer_s18", "uperhead")
    x = _normal(np.random.default_rng(10), (2, SIZE, SIZE, 3))
    jm = jax_build_model("caformer_s18", "uperhead", 150, embed_dim=128, dtype=jnp.float32)
    want = np.asarray(jit_apply(jm, variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (2, SIZE, SIZE, 150)
    rel_close(got, want)


# ---------------------------------------------------------------- training


class _JaxNarrowA(fnn.Module):
    """Narrow CAFormer + UPerHead as the JAX ``SegmentationModel`` composes
    them; the head's dropout off."""

    nc: int
    dtype: Any = jnp.float32

    @fnn.compact
    def __call__(self, x, train: bool = False, resize_output: bool = True):
        feats = _jax_metaformer("caformer", self.dtype, name="backbone")(x, train=train)
        lo = JUPerHead(DIMS, self.nc, embed_dim=16, dropout=0.0, dtype=self.dtype,
                       name="decode_head")(feats, train=train)
        return lo if not resize_output else JC.resize(lo, (x.shape[1], x.shape[2]))


STEPS, LR = 5, 2e-3
SCHED = dict(warmup_steps=2, warmup_lr_init=1e-6, min_lr=1e-5)


def test_five_step_trajectory_of_narrow_model_a(monkeypatch):
    """Model A's recipe on a narrow CAFormer + UPerHead (E = 16, 150
    classes): CE + dice through the fused low-resolution loss (its plain
    version on the CPU), AdamW + AGC 0.02 + weight decay 0.05 on the cosine
    schedule, batch 2 at 64², float32, from the same weights on the same
    batches; drop-path rate 0 (MetaFormer's default) and the head's
    dropout off on both sides."""
    nc = 150

    def narrow(dtype=torch.float32, img_size=SIZE):
        return M.MetaFormer(DIMS, DEPTHS, M.FAMILY_MIXERS["caformer"], "ln", dtype=dtype,
                            img_size=img_size), list(DIMS)

    monkeypatch.setitem(BACKBONES, "narrow_caformer", narrow)
    model = build_model("narrow_caformer", "uperhead", nc, embed_dim=16, dtype=torch.float32,
                        device="cpu", img_size=SIZE)
    sd = random_state_dict(model, seed=11)
    load_numpy(model, sd)
    hp, hs = convert_uperhead(strip(sd, "decode_head."))
    params = {"backbone": _jax_tree("caformer", sd, "backbone.")[0], "decode_head": hp}
    rng = np.random.default_rng(12)
    batches = []
    for _ in range(STEPS):
        lbl = rng.integers(0, nc, (2, SIZE, SIZE)).astype(np.int32)
        lbl[:, :4] = 255
        batches.append((_normal(rng, (2, SIZE, SIZE, 3)), lbl))

    jm = _JaxNarrowA(nc)
    sched = JS.create_schedule("cosine", LR, STEPS, **SCHED)
    tx = j_create_optimizer("adamw", sched, weight_decay=0.05, clip_grad=0.02, clip_mode="agc",
                            params=params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats={"decode_head": hs}, opt_state=tx.init(params),
                       apply_fn=jm.apply, tx=tx)
    step = jax.jit(functools.partial(jsteps.train_step, loss_type="ce", use_dice=True,
                                     learning_rate_fn=sched))
    want = []
    for img, lbl in batches:
        state, metrics = step(state, {"image": jnp.asarray(img), "label": jnp.asarray(lbl)},
                              jax.random.PRNGKey(0))
        want.append(float(metrics["loss"]))

    opt = create_optimizer("adamw", schedule.create_schedule("cosine", LR, STEPS, **SCHED),
                           weight_decay=0.05, clip_grad=0.02, clip_mode="agc",
                           params=model.named_parameters())
    noise = {"drop_path": torch.ones((sum(DEPTHS), 2, 2)), "dropout": torch.ones((2, 16))}
    got = [float(train_step(model, opt, {"image": img, "label": lbl}, noise=noise,
                            loss_type="ce", use_dice=True)["loss"])
           for img, lbl in batches]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert got[-1] < got[0]
