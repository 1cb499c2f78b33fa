"""EfficientViT (b / L series), its LiteMLA, the EfficientViT-Seg head and
the new shared layers (tanh GELU, hard sigmoid, sigmoid, SqueezeExcite,
torch's bicubic resize) against the JAX package, on the CPU.

Weights are numpy, drawn for the port's reference-layout ``state_dict``
(``_torch_port.random_state_dict``) and carried to the JAX tree by the JAX
package's converters (``_evit_litemla``, ``convert_efficientvitseg`` with
the head's ``decode_head.`` keys renamed to the reference's ``head.``).
LiteMLA's qkv channels are per head [q | k | v] in the reference's layout
and [all q | all k | all v] in the JAX tree, so these tests fail for a port
that splits them as the JAX module does. Tolerances: float32 outputs within
1e-4 of the JAX output's largest magnitude, gradients within 1e-3 of each
parameter's largest JAX entry plus 1e-6 of the model's largest (``GRAD_FLOOR``,
the bar of ``chip_smoke.py``'s gradients: in training a BatchNorm bias whose
every path leads into another BatchNorm has a gradient of 0 but for
rounding), BatchNorm running statistics within 1e-4 of each tensor's
largest entry (momentum 0.9).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import segmentation_factory_tpu.models.backbones  # noqa: F401  (registration)
import segmentation_factory_tpu.models.heads  # noqa: F401  (registration)
from segmentation_factory_tpu import convert as JCV
from segmentation_factory_tpu.models import build as jbuild
from segmentation_factory_tpu.models.backbones import efficientvit as JE
from segmentation_factory_tpu.models.layers import common as JC
from segmentation_factory_tpu.models.layers.act import build_act as j_build_act
from segmentation_factory_tpu.registry import BACKBONES as J_BACKBONES
from segmentation_factory_tpu.registry import HEADS as J_HEADS
import segmentation_factory_tpu_torch.models.heads  # noqa: F401  (registration)
from segmentation_factory_tpu_torch.convert import from_jax_variables
from segmentation_factory_tpu_torch.models.backbones import efficientvit as E
from segmentation_factory_tpu_torch.models.build import SegmentationModel
from segmentation_factory_tpu_torch.models.layers import SqueezeExcite, resize_torch_bicubic
from segmentation_factory_tpu_torch.models.layers.act import build_act
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

NC = 5
L1_CUT = [1, 1, 1, 1, 1]  # l1's depths [1, 1, 1, 6, 6] cut to a block of each kind
GRAD_FLOOR = 1e-6


def _normal(rng, shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _ref(sd: dict) -> dict:
    """The port's keys -> the reference's EfficientViTSeg keys (``head.``)."""
    return {("head." + k[len("decode_head."):] if k.startswith("decode_head.") else k): v
            for k, v in sd.items()}


def _stats_close(got_tree, want_tree):
    for path, leaf in jax.tree_util.tree_leaves_with_path(got_tree):
        ref = np.asarray(dict(jax.tree_util.tree_leaves_with_path(want_tree))[path])
        np.testing.assert_allclose(np.asarray(leaf), ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------- shared layers


@pytest.mark.parametrize("name", ["gelu", "hsigmoid", "sigmoid"])
def test_new_activations_match_jax(name):
    """``"gelu"`` is the tanh form (``jax.nn.gelu``'s default), ``"hsigmoid"``
    relu6(x + 3) / 6, over [-8, 8] and its ends."""
    x = np.concatenate([np.linspace(-8, 8, 4001, dtype=np.float32), [-3.0, 3.0, 0.0]])
    want = np.asarray(j_build_act(name)(jnp.asarray(x)))
    got = build_act(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("gate,act", [("hsigmoid", "relu"), ("sigmoid", "gelu")])
def test_squeeze_excite_matches_jax(gate, act):
    port = SqueezeExcite(24, 8, gate=gate, act=act, dtype=torch.float32)
    sd = random_state_dict(port, seed=1)
    load_numpy(port, sd)
    x = _normal(np.random.default_rng(2), (2, 6, 7, 24))
    params = {"Conv_0": JCV.t_conv(sd, "fc1"), "Conv_1": JCV.t_conv(sd, "fc2")}
    want = jit_apply(JC.SqueezeExcite(8, gate=gate, act=act, dtype=jnp.float32),
                     {"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    rel_close(got.numpy(), want)


@pytest.mark.parametrize("src,dst", [((8, 8), (16, 16)), ((8, 6), (32, 24)), ((5, 7), (13, 11)),
                                     ((9, 12), (4, 5))],
                         ids=["ratio2", "ratio4", "ragged", "down"])
def test_resize_torch_bicubic_matches_jax(src, dst):
    """Against the JAX matmul form at ratios 2 and 4, a ragged size and a
    downsample, float32 and bf16 (computed in float32, cast back)."""
    x = _normal(np.random.default_rng(3), (2, *src, 3))
    jax_resize = jax.jit(lambda a: JC.resize_torch_bicubic(a, dst))
    want = np.asarray(jax_resize(jnp.asarray(x)))
    got = resize_torch_bicubic(torch.from_numpy(x), dst)
    assert got.shape == want.shape and got.is_contiguous()
    rel_close(got.numpy(), want, 1e-5)
    got16 = resize_torch_bicubic(torch.from_numpy(x).bfloat16(), dst)
    want16 = np.asarray(jax_resize(jnp.asarray(x, jnp.bfloat16)), np.float32)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(), want16, rtol=2 ** -7, atol=1e-6)


# ---------------------------------------------------------------- LiteMLA


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("head_dim", [16, 32])
def test_litemla_matches_jax(head_dim, train):
    """LiteMLA on carried weights (64 channels: 4 or 2 heads a scale): its
    output and the gradients of a random projection of it; pixel (0, 0, 0)
    of the input is zero, so its plain-scale q and normaliser are 0 (the
    row is 0 / (0 + 1e-15)); in training the projection's BatchNorm takes
    batch statistics and updates its running ones."""
    c = 64
    port = E.LiteMLA(c, c, head_dim, dtype=torch.float32).train(train)
    sd = {f"m.{k}": v for k, v in random_state_dict(port, seed=4).items()}
    load_numpy(port, strip(sd, "m."))
    params, stats = JCV._evit_litemla(sd, "m", head_dim)
    rng = np.random.default_rng(5)
    x = _normal(rng, (2, 6, 5, c))
    x[0, 0, 0] = 0.0
    cts = [_normal(rng, (2, 6, 5, c))]
    kw = dict(train=True, mutable=["batch_stats"]) if train else dict(train=False)
    out, gp, gx, extra = jax_vjp(JE.LiteMLA(c, head_dim=head_dim, dtype=jnp.float32),
                                 {"params": params, "batch_stats": stats}, x, cts, **kw)
    got, got_gp, got_gx = torch_vjp(port, x, cts)
    rel_close(got[0], out)
    rel_close(got_gx, gx, 1e-3)
    back = JCV._evit_litemla({**sd, **{f"m.{k}": v for k, v in got_gp.items()}}, "m", head_dim)
    trees_close(back[0], gp)
    if train:
        new = {f"m.{k}": v.numpy() for k, v in port.state_dict().items() if "running" in k}
        _stats_close(JCV._evit_litemla({**sd, **new}, "m", head_dim)[1],
                     extra["state"]["batch_stats"])


# ---------------------------------------------------------------- whole models


def _cut_l1(monkeypatch):
    widths = JE.EFFICIENTVIT_LARGE_SETTINGS["l1"][0]
    monkeypatch.setitem(JE.EFFICIENTVIT_LARGE_SETTINGS, "l1", (widths, L1_CUT))
    monkeypatch.setitem(E.EFFICIENTVIT_LARGE_SETTINGS, "l1", (widths, L1_CUT))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("variant", ["b0", "l1"])
def test_efficientvitseg_matches_jax(monkeypatch, variant, train):
    """``efficientvit_<v>`` + ``efficientvitseg_<v>`` (l1 with one block a
    stage) at 64², 5 classes: the stride-8 logits (8 x 8,
    ``resize_output=False``); in training also the gradients of a random
    projection of them with respect to every parameter and the image, and
    every BatchNorm's running statistics after the step."""
    if variant == "l1":
        _cut_l1(monkeypatch)
    port = SegmentationModel(f"efficientvit_{variant}", f"efficientvitseg_{variant}", NC,
                             dtype=torch.float32).train(train)
    sd = random_state_dict(port, seed=6)
    load_numpy(port, sd)
    variables = JCV.convert_efficientvitseg(_ref(sd), variant)
    rng = np.random.default_rng(7)
    x = _normal(rng, (2, 64, 64, 3))
    cts = [_normal(rng, (2, 8, 8, NC))]
    jm = jbuild.SegmentationModel(f"efficientvit_{variant}", f"efficientvitseg_{variant}", NC,
                                  dtype=jnp.float32)
    if not train:
        want = jit_apply(jm, variables, jnp.asarray(x), train=False, resize_output=False)
        with torch.no_grad():
            got = port(torch.from_numpy(x), resize_output=False)
        assert got.shape == (2, 8, 8, NC)
        rel_close(got.numpy(), want)
        return
    out, gp, gx, extra = jax_vjp(jm, variables, x, cts, resize_output=False, train=True,
                                 mutable=["batch_stats"])
    got, got_gp, got_gx = torch_vjp(port, x, cts, resize_output=False, noise={"dropout": None})
    assert got[0].shape == (2, 8, 8, NC)
    rel_close(got[0], out)
    rel_close(got_gx, gx, 1e-3)
    trees_close(JCV.convert_efficientvitseg(_ref({**sd, **got_gp}), variant)["params"], gp,
                of_largest=GRAD_FLOOR)
    new = {k: v.numpy() for k, v in port.state_dict().items() if "running" in k}
    _stats_close(JCV.convert_efficientvitseg(_ref({**sd, **new}), variant)["batch_stats"],
                 extra["state"]["batch_stats"])


PAIRS = [(f"efficientvit_{v}", f"efficientvitseg_{v}") for v in ("b0", "b1", "b2", "b3")] + [
    ("efficientvit_l0", "efficientvitseg_l1"), ("efficientvit_l1", "efficientvitseg_l1"),
    ("efficientvit_l2", "efficientvitseg_l2"), ("efficientvit_l3", "efficientvitseg_l2")]


@pytest.mark.parametrize("backbone,head", PAIRS, ids=[p[0][13:] for p in PAIRS])
def test_layouts_equal_jax(backbone, head):
    """Every registered backbone at its full depth with a preset head: the
    port's ``state_dict`` shapes through ``convert_efficientvitseg`` are the
    JAX model's variable shapes (``jax.eval_shape`` of its init), and
    ``from_jax_variables`` of them gives the port's keys and shapes back.
    Built on the meta device: no weights are drawn."""
    with torch.device("meta"):
        port = SegmentationModel(backbone, head, NC, dtype=torch.float32)
    shapes = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    sd = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    variables = JCV.convert_efficientvitseg(_ref(sd), backbone[13:])
    jm = jbuild.SegmentationModel(backbone, head, NC, dtype=jnp.float32)
    want = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    assert (jax.tree_util.tree_map(np.shape, variables)
            == jax.tree_util.tree_map(lambda a: a.shape, dict(want)))
    back = from_jax_variables(variables)
    assert {k: tuple(v.shape) for k, v in back.items()} == shapes


@pytest.mark.parametrize("variant", ["b0", "b2", "l1"])
def test_from_jax_variables_round_trips(variant, monkeypatch):
    """Port weights -> ``convert_efficientvitseg`` -> ``from_jax_variables``
    gives the port's ``state_dict`` back bit for bit (LiteMLA's kernels
    through the JAX permutation and back; head dims 16 and 32)."""
    if variant == "l1":
        _cut_l1(monkeypatch)
    port = SegmentationModel(f"efficientvit_{variant}", f"efficientvitseg_{variant}", NC,
                             dtype=torch.float32)
    sd = random_state_dict(port, seed=8)
    back = from_jax_variables(JCV.convert_efficientvitseg(_ref(sd), variant))
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def test_registry_names_equal_jax():
    """The port registers the JAX registry's 8 EfficientViT names with the
    same feature widths, ``efficientvitseghead`` and the 6 presets; the
    generic head takes ``embed_dim`` (the presets pin theirs)."""
    names = sorted(n for n in J_BACKBONES if n.startswith("efficientvit_"))
    assert names == sorted(n for n in BACKBONES if n.startswith("efficientvit_"))
    assert len(names) == 8
    for n in names:
        with torch.device("meta"):
            assert BACKBONES[n](dtype=torch.float32)[1] == J_BACKBONES[n]()[1]
    heads = sorted(n for n in J_HEADS if n.startswith("efficientvitseg"))
    assert heads == sorted(n for n in HEADS if n.startswith("efficientvitseg")) and len(heads) == 7
    with torch.device("meta"):
        generic = SegmentationModel("efficientvit_b1", "efficientvitseghead", NC, embed_dim=48,
                                    dtype=torch.float32)
        preset = SegmentationModel("efficientvit_b1", "efficientvitseg_b1", NC, embed_dim=48,
                                   dtype=torch.float32)
    assert generic.decode_head.embed_dim == 48 and preset.decode_head.embed_dim == 64


@pytest.mark.parametrize("family", ["maskrcnnsegmentationhead"])
def test_unported_families_raise(family):
    """The families still to be ported (``registry.NOT_PORTED``): each of
    their JAX names raises "not ported" in the port."""
    from segmentation_factory_tpu_torch.registry import NOT_PORTED, get_backbone, get_head

    assert family in NOT_PORTED
    names = [(n, get_backbone) for n in J_BACKBONES if n.split("_")[0] == family]
    names += [(n, get_head) for n in J_HEADS if n.split("_")[0] == family]
    assert names
    for name, get in names:
        with pytest.raises(NotImplementedError, match="not ported"):
            get(name)


@pytest.mark.parametrize("family", ["crossformer", "crossformerpp", "iformer", "kat"])
def test_last_backbone_families_build(family):
    """The four backbone families that left ``registry.NOT_PORTED``: each of
    their JAX names builds in the port (on the meta device, no weights
    drawn) with the JAX feature channels."""
    from segmentation_factory_tpu_torch.registry import NOT_PORTED, get_backbone

    assert family not in NOT_PORTED
    names = [n for n in J_BACKBONES if n.split("_")[0] == family]
    assert names
    for name in names:
        with torch.device("meta"):
            model, channels = get_backbone(name, dtype=torch.float32)
        assert channels == J_BACKBONES[name]()[1], name
        assert all(p.device.type == "meta" for p in model.parameters()), name


def test_every_other_jax_name_is_registered():
    """Every JAX backbone and head name outside ``NOT_PORTED`` is registered
    in the port, and the port registers no name the JAX package lacks."""
    from segmentation_factory_tpu_torch.registry import NOT_PORTED, get_backbone

    get_backbone("mit_b0")  # imports the zoo
    for ours, theirs in ((BACKBONES, J_BACKBONES), (HEADS, J_HEADS)):
        assert sorted(n for n in theirs if n.split("_")[0] not in NOT_PORTED) == sorted(ours)
