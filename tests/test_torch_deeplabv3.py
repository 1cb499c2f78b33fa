"""ResNet + the DeepLabV3 head (with its FCN aux head), and a head that
returns a list through ``SegmentationModel``, against the JAX package, on
the CPU.

Weights are numpy, drawn for the port's reference-layout ``state_dict``
(``_torch_port.random_state_dict``) and carried to the JAX tree by the JAX
package's converters (``convert_resnet``, ``convert_deeplabv3``). In
training the heads take the JAX dropout masks: ``flax.linen.Dropout`` is
wrapped to record each mask (``recorded_dropout``) and the port takes them
as its noise. Tolerances: float32 outputs within 1e-4 of the JAX output's
largest magnitude, gradients within 1e-3 of each parameter's largest JAX
entry, BatchNorm running statistics within 1e-5; a 5-step loss trajectory
within 2e-4 relative.
"""

import functools
from typing import Any

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen.module import merge_param

from segmentation_factory_tpu import schedule as JS
from segmentation_factory_tpu.convert import convert_deeplabv3, convert_full_model, convert_resnet
from segmentation_factory_tpu.engine import steps as jsteps
from segmentation_factory_tpu.engine.state import TrainState
from segmentation_factory_tpu.engine.state import create_optimizer as j_create_optimizer
from segmentation_factory_tpu.models import build as jbuild
from segmentation_factory_tpu.models import build_model as jax_build_model
from segmentation_factory_tpu.models.backbones.resnet import ResNet as JResNet
from segmentation_factory_tpu.models.heads import deeplabv3 as JD
from segmentation_factory_tpu.models.layers import common as JC
from segmentation_factory_tpu.registry import BACKBONES as J_BACKBONES
from segmentation_factory_tpu.registry import HEADS as J_HEADS
from segmentation_factory_tpu_torch import build_model, schedule
from segmentation_factory_tpu_torch.convert import from_jax_variables
from segmentation_factory_tpu_torch.engine import create_optimizer, train_step
from segmentation_factory_tpu_torch.models.backbones.resnet import ResNet
from segmentation_factory_tpu_torch.models.build import SegmentationModel
from segmentation_factory_tpu_torch.models.heads.deeplabv3 import DeepLabV3Head
from segmentation_factory_tpu_torch.registry import BACKBONES, HEADS

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

LAYERS = (1, 1, 1, 1)  # ResNet's widths, one Bottleneck a stage
CHANNELS = (16, 32, 64, 128)  # a narrow pyramid for the head alone
E, NC = 32, 7


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.fixture
def recorded_dropout(monkeypatch):
    """Every ``flax.linen.Dropout`` call appends its mask (1 / keep or 0, as
    float32) to the returned list: the wrapper takes the call's key once
    and applies the original to the input and to ones with it."""
    masks = []
    orig = fnn.Dropout.__call__

    def call(self, inputs, deterministic=None, rng=None):
        det = merge_param("deterministic", self.deterministic, deterministic)
        if self.rate == 0.0 or det:
            return orig(self, inputs, deterministic, rng)
        if rng is None:
            rng = self.make_rng(self.rng_collection)
        masks.append(orig(self, jnp.ones(inputs.shape, jnp.float32), deterministic, rng))
        return orig(self, inputs, deterministic, rng)

    monkeypatch.setattr(fnn.Dropout, "__call__", call)
    return masks


def _running_stats_close(port, state_tree, pairs):
    """Each (port BatchNorm key, JAX path) pair's running mean and variance
    against the JAX ``batch_stats`` after the step."""
    for key, path in pairs:
        st = state_tree
        for p in path:
            st = st[p]
        bn = port.get_submodule(key)
        for ours, theirs in ((bn.running_mean, st["mean"]), (bn.running_var, st["var"])):
            np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), rtol=1e-5,
                                       atol=1e-6, err_msg=key)


# ---------------------------------------------------------------- the list repair


class _JaxListBackbone(fnn.Module):
    dtype: Any = None

    @fnn.compact
    def __call__(self, x, train: bool = False):
        return [x[:, ::s, ::s] for s in (4, 8, 16, 32)]


class _JaxListHead(fnn.Module):
    """Two float32 1x1 classifiers of the coarsest level: ``[main, aux]``."""

    num_classes: int

    @fnn.compact
    def __call__(self, feats, train: bool = False):
        return [fnn.Dense(self.num_classes, name=n)(feats[-1]) for n in ("main", "aux")]


class _ListBackbone(torch.nn.Module):
    def forward(self, x, factors=None):
        return [x[:, ::s, ::s] for s in (4, 8, 16, 32)]


class _ListHead(torch.nn.Module):
    def __init__(self, num_classes):
        super().__init__()
        self.main = torch.nn.Linear(3, num_classes)
        self.aux = torch.nn.Linear(3, num_classes)

    def dropout_mask(self, batch, generator, device=None, sizes=None):
        return None

    def forward(self, feats, dmask=None):
        return [self.main(feats[-1]), self.aux(feats[-1])]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("resize_output", [False, True])
def test_list_head_through_segmentation_model_matches_jax(monkeypatch, train, resize_output):
    """A head that returns ``[main, aux]``: in eval the model returns
    ``main``; in training the list; each resized to the input with
    ``resize_output`` (JAX ``build.py:89-95``)."""
    monkeypatch.setitem(J_BACKBONES, "list_stub", lambda dtype=None: (_JaxListBackbone(), [3] * 4))
    monkeypatch.setitem(J_HEADS, "list_stub",
                        lambda channels, num_classes, embed_dim, dtype: _JaxListHead(num_classes))
    monkeypatch.setitem(BACKBONES, "list_stub",
                        lambda dtype=None, img_size=512: (_ListBackbone(), [3] * 4))
    monkeypatch.setitem(HEADS, "list_stub",
                        lambda channels, num_classes, embed_dim, dtype: _ListHead(num_classes))
    rng = np.random.default_rng(1)
    x = _normal(rng, (2, 64, 64, 3))
    w = {n: (_normal(rng, (3, NC)), _normal(rng, (NC,))) for n in ("main", "aux")}
    jm = jbuild.SegmentationModel("list_stub", "list_stub", NC, dtype=jnp.float32)
    want = jm.apply({"params": {"decode_head": {n: {"kernel": k, "bias": b}
                                                for n, (k, b) in w.items()}}},
                    jnp.asarray(x), train=train, resize_output=resize_output)
    port = build_model("list_stub", "list_stub", NC, dtype=torch.float32, device="cpu")
    for n, (k, b) in w.items():
        getattr(port.decode_head, n).weight.data.copy_(torch.from_numpy(k.T))
        getattr(port.decode_head, n).bias.data.copy_(torch.from_numpy(b))
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(x), resize_output=resize_output,
                   generator=torch.Generator().manual_seed(0))
    assert isinstance(got, list) == isinstance(want, list) == train
    for g, o in zip(got if train else [got], want if train else [want]):
        assert g.shape == o.shape
        rel_close(g.numpy(), o)


# ---------------------------------------------------------------- ResNet


@pytest.mark.parametrize("train", [False, True])
def test_resnet_matches_jax(train):
    """ResNet with one Bottleneck a stage at 64² (levels 16² to 2², widths
    256 to 2048): features and the gradients of a random projection of them
    with respect to every parameter and the image; in training the
    BatchNorms take batch statistics and update their running ones."""
    port = ResNet(LAYERS, dtype=torch.float32).train(train)
    sd = random_state_dict(port, seed=2)
    load_numpy(port, sd)
    variables = convert_resnet(sd, LAYERS)
    rng = np.random.default_rng(3)
    x = _normal(rng, (2, 64, 64, 3))
    cts = [_normal(rng, (2, 16 >> i, 16 >> i, c)) for i, c in enumerate((256, 512, 1024, 2048))]
    kw = dict(train=True, mutable=["batch_stats"]) if train else dict(train=False)
    out, gp, gx, extra = jax_vjp(JResNet(layers=LAYERS, dtype=jnp.float32), variables, x, cts,
                                 **kw)
    got, got_gp, got_gx = torch_vjp(port, x, cts)
    for g, o in zip(got, out):
        rel_close(g, o)
    rel_close(got_gx, gx, 1e-3)
    trees_close(convert_resnet({**sd, **got_gp}, LAYERS)["params"], gp)
    if train:
        pairs = [("bn1", ("stem", "BatchNorm_0", "BatchNorm_0"))] + [
            (f"layer{i}.0.downsample.1", (f"layer{i}_0", "downsample", "BatchNorm_0",
                                          "BatchNorm_0")) for i in range(1, 5)]
        _running_stats_close(port, extra["state"]["batch_stats"], pairs)


# ---------------------------------------------------------------- DeepLabV3


@pytest.fixture(scope="module")
def head_weights():
    """A narrow DeepLabV3 head's numpy ``state_dict`` and the JAX (params,
    batch_stats) of it."""
    head = DeepLabV3Head(CHANNELS, NC, embed_dim=E, dtype=torch.float32)
    sd = random_state_dict(head, seed=4)
    return sd, convert_deeplabv3(sd)


def _part(name, sd, jax_vars, train):
    """(port module, JAX module, its variables, inputs, cotangents, port's
    extra args) of the ASPP, the aux head or the whole head."""
    hp, hs = jax_vars
    rng = np.random.default_rng(5)
    top = _normal(rng, (2, 5, 6, CHANNELS[-1]))
    nxt = _normal(rng, (2, 10, 12, CHANNELS[-2]))
    head = load_numpy(DeepLabV3Head(CHANNELS, NC, embed_dim=E, dtype=torch.float32), sd)
    head.train(train)
    if name == "aspp":
        return (head.head.aspp, JD.ASPP(E, dtype=jnp.float32),
                {"params": hp["aspp"], "batch_stats": hs["aspp"]}, top,
                [_normal(rng, (2, 5, 6, E))])
    if name == "aux":
        return (head.auxlayer.block, JD.FCNAuxHead(None, NC, dtype=jnp.float32),
                {"params": hp["aux"], "batch_stats": hs["aux"]}, nxt,
                [_normal(rng, (2, 10, 12, NC))])
    cts = [_normal(rng, (2, 5, 6, NC))] * (2 if train else 1)
    return (head, JD.DeepLabV3Head(CHANNELS, NC, embed_dim=E, dtype=jnp.float32),
            {"params": hp, "batch_stats": hs}, [nxt[:, :0], nxt[:, :0], nxt, top], cts)


class _Feats(torch.nn.Module):
    """The head on a pyramid whose third level is the differentiated input."""

    def __init__(self, head, feats):
        super().__init__()
        self.head, self.feats = head, feats

    def forward(self, x, dmask=None):
        return self.head([torch.from_numpy(self.feats[0]), torch.from_numpy(self.feats[1]),
                          torch.from_numpy(self.feats[2]), x], dmask)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", ["aspp", "aux", "head"])
def test_deeplabv3_parts_match_jax(recorded_dropout, head_weights, name, train):
    """The ASPP (rates 12 / 24 / 36 on a 5 x 6 map: most taps in the
    padding), the FCN aux head (width 64 // 4) and the whole head (its aux
    output resized from 10 x 12 to 5 x 6 in training): outputs and the
    gradients of a random projection of them with respect to the
    parameters and the coarsest input; in training with the JAX dropout
    masks (elementwise over (B, h, w, C)) and the BatchNorms' batch
    statistics."""
    sd, jax_vars = head_weights
    port, jmod, variables, x, cts = _part(name, sd, jax_vars, train)
    feats = None
    if name == "head":
        feats, x = x, x[-1]
    kw = (dict(train=True, mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(6)})
          if train else dict(train=False))
    if feats is None:
        out, gp, gx, extra = jax_vjp(jmod, variables, x, cts, record=recorded_dropout, **kw)
    else:
        wrapped = _JaxHeadOnTop(jmod, [jnp.asarray(f) for f in feats[:3]])
        out, gp, gx, extra = jax_vjp(wrapped, {k: {"head": v} for k, v in variables.items()},
                                     x, cts, record=recorded_dropout, **kw)
        gp = gp["head"]
    masks = [torch.from_numpy(np.array(m)) for m in extra["record"]]
    assert len(masks) == (({"aspp": 1, "aux": 1, "head": 3}[name]) if train else 0)
    if name == "head":
        module = _Feats(port, feats)
        got, got_gp, got_gx = torch_vjp(module, x, cts, masks or None)
        got_gp = strip(got_gp, "head.")
    else:
        got, got_gp, got_gx = torch_vjp(port, x, cts, *(masks or [None]))
    outs = out if isinstance(out, list) else [out]
    assert len(got) == len(outs)
    for g, o in zip(got, outs):
        rel_close(g, o)
    rel_close(got_gx, gx, 1e-3)
    prefix = {"aspp": "head.aspp.", "aux": "auxlayer.block."}.get(name, "")
    full = {**sd, **{prefix + k: v for k, v in got_gp.items()}}
    hp = convert_deeplabv3(full)[0]
    trees_close({"aspp": hp["aspp"], "aux": hp["aux"]}.get(name, hp), gp)


class _JaxHeadOnTop(fnn.Module):
    """A JAX head applied to fixed finer levels and the differentiated
    coarsest one."""

    head: Any
    fixed: Any

    @fnn.compact
    def __call__(self, x, train: bool = False):
        return self.head(list(self.fixed) + [x], train=train)


def test_resnet50_deeplabv3_full_width_matches_jax():
    """The registered ``resnet50`` + ``deeplabv3`` at full width (E = 768 by
    the default rule, 21 classes) at 64², float32 logits in eval, and its
    weights back through ``from_jax_variables``."""
    port = SegmentationModel("resnet50", "deeplabv3", 21, dtype=torch.float32).eval()
    sd = random_state_dict(port, seed=7)  # every tensor replaced: no seeded init needed
    load_numpy(port, sd)
    variables = convert_full_model(sd, "resnet50", "deeplabv3")
    back = from_jax_variables(variables)
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    x = _normal(np.random.default_rng(8), (2, 64, 64, 3))
    jm = jax_build_model("resnet50", "deeplabv3", 21, dtype=jnp.float32)
    want = np.asarray(jit_apply(jm, variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 64, 64, 21)
    rel_close(got, want)


def test_sample_noise_draws_the_elementwise_masks():
    """``sample_noise`` with the input size: DeepLabV3's three masks at the
    backbone's feature sizes (ResNet at 100 x 70: 4 x 3 and 7 x 5), each
    entry 0 or 1 / keep; without the size it refuses."""
    port = SegmentationModel("resnet50", "deeplabv3", 21, embed_dim=32, dtype=torch.float32)
    noise = port.sample_noise(2, torch.Generator().manual_seed(0), (100, 70))
    shapes = [tuple(m.shape) for m in noise["dropout"]]
    assert shapes == [(2, 4, 3, 32), (2, 4, 3, 32), (2, 7, 5, 256)] and "drop_path" not in noise
    for m, keep in zip(noise["dropout"], (0.5, 0.9, 0.9)):
        assert set(m.unique().tolist()) <= {0.0, float(torch.tensor(1.0) / keep)}
    with pytest.raises(ValueError, match="feature sizes"):
        port.sample_noise(2, torch.Generator().manual_seed(0))
    port.train()
    out = port(torch.zeros((2, 100, 70, 3)), resize_output=False,
               generator=torch.Generator().manual_seed(0))
    assert [tuple(o.shape) for o in out] == [(2, 4, 3, 21)] * 2


# ---------------------------------------------------------------- training


class _JaxNarrowB(fnn.Module):
    """Narrow ResNet + DeepLabV3 as the JAX ``SegmentationModel`` composes
    them."""

    nc: int
    dtype: Any = jnp.float32

    @fnn.compact
    def __call__(self, x, train: bool = False, resize_output: bool = True):
        feats = JResNet(layers=LAYERS, dtype=self.dtype, name="backbone")(x, train=train)
        out = JD.DeepLabV3Head([256, 512, 1024, 2048], self.nc, embed_dim=E, dtype=self.dtype,
                               name="decode_head")(feats, train=train)
        if not isinstance(out, list):
            return out if not resize_output else JC.resize(out, (x.shape[1], x.shape[2]))
        return out if not resize_output else [JC.resize(o, (x.shape[1], x.shape[2]))
                                              for o in out]


# at 2e-3 the float32 trajectory is chaotic on either framework (the
# image-pool branch's BatchNorm normalises over the batch's 2 pixels): a
# difference of rounding grows tenfold a step from the third on
STEPS, LR = 5, 1e-4
SCHED = dict(warmup_steps=2, warmup_lr_init=1e-6, min_lr=1e-5)


def test_five_step_trajectory_of_narrow_model_b(monkeypatch):
    """Model B's recipe on ResNet with one Bottleneck a stage + DeepLabV3
    (E = 32, 21 classes): CE + dice on ``[main, aux]`` weighted (1, 0.4),
    both through the fused low-resolution loss at ratio 32 (its plain
    version on the CPU), AdamW + AGC 0.02 + weight decay 1e-4 on the cosine
    schedule to 1e-4, batch 2 at 64², float32, BatchNorm batch statistics,
    from the same weights on one batch five times; dropout off on both
    sides (the JAX ``Dropout`` made the identity, the port's masks ones)."""
    nc = 21
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setitem(BACKBONES, "narrow_resnet",
                        lambda dtype=torch.float32, img_size=512: (
                            ResNet(LAYERS, dtype=dtype), [256, 512, 1024, 2048]))
    model = build_model("narrow_resnet", "deeplabv3", nc, embed_dim=E, dtype=torch.float32,
                        device="cpu")
    sd = random_state_dict(model, seed=9)
    load_numpy(model, sd)
    bb = convert_resnet(strip(sd, "backbone."), LAYERS)
    hp, hs = convert_deeplabv3(strip(sd, "decode_head."))
    params = {"backbone": bb["params"], "decode_head": hp}
    rng = np.random.default_rng(10)
    lbl = rng.integers(0, nc, (2, 64, 64)).astype(np.int32)
    lbl[:, :4] = 255
    batches = [(_normal(rng, (2, 64, 64, 3)), lbl)] * STEPS  # one batch, learnable

    jm = _JaxNarrowB(nc)
    sched = JS.create_schedule("cosine", LR, STEPS, **SCHED)
    tx = j_create_optimizer("adamw", sched, weight_decay=1e-4, clip_grad=0.02, clip_mode="agc",
                            params=params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats={"backbone": bb["batch_stats"], "decode_head": hs},
                       opt_state=tx.init(params), apply_fn=jm.apply, tx=tx)
    step = jax.jit(functools.partial(jsteps.train_step, loss_type="ce", use_dice=True,
                                     learning_rate_fn=sched))
    want = []
    for img, lbl in batches:
        state, metrics = step(state, {"image": jnp.asarray(img), "label": jnp.asarray(lbl)},
                              jax.random.PRNGKey(0))
        want.append(float(metrics["loss"]))

    opt = create_optimizer("adamw", schedule.create_schedule("cosine", LR, STEPS, **SCHED),
                           weight_decay=1e-4, clip_grad=0.02, clip_mode="agc",
                           params=model.named_parameters())
    noise = {"dropout": [torch.ones((2, 2, 2, E)), torch.ones((2, 2, 2, E)),
                         torch.ones((2, 4, 4, 256))]}
    got = [float(train_step(model, opt, {"image": img, "label": lbl}, noise=noise,
                            loss_type="ce", use_dice=True)["loss"])
           for img, lbl in batches]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert got[-1] < got[0]
