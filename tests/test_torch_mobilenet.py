"""MobileNetV2 / V3 (with DeepLabV3) against the JAX package, on the CPU.

Weights are numpy, drawn for the port's reference-layout ``state_dict``
(``_torch_port.random_state_dict``) and carried to the JAX tree by the JAX
package's ``convert_mobilenetv2`` and ``convert_deeplabv3``; V3's
squeeze-excite, which the reference never wires in and no JAX converter
names, is added to each block's tree here (``_jax_backbone``). Tolerances:
float32 outputs within 1e-4 of the JAX output's largest magnitude,
gradients within 1e-3 of each parameter's largest JAX entry plus 1e-6 of
the model's largest, BatchNorm running statistics within 1e-4 of each
tensor's largest entry (momentum 0.9). The whole network in training is
compared with both sides in float64 (``test_mobilenet_deeplabv3_matches_jax``).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_factory_tpu import convert as JCV
from segmentation_factory_tpu.models import build as jbuild
from segmentation_factory_tpu.models.backbones import mobilenet as JM
from segmentation_factory_tpu.registry import BACKBONES as J_BACKBONES
from segmentation_factory_tpu_torch.convert import from_jax_variables
from segmentation_factory_tpu_torch.models.backbones import mobilenet as M
from segmentation_factory_tpu_torch.models.build import SegmentationModel

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

E, NC = 32, 21
B = 4  # the image-pool branch's BatchNorm normalises over B values
GRAD_FLOOR = 1e-6


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _se(sd, prefix):
    return {"Conv_0": JCV.t_conv(sd, f"{prefix}.se.fc1"),
            "Conv_1": JCV.t_conv(sd, f"{prefix}.se.fc2")}


def _jax_backbone(sd):
    """The JAX ``MobileNet`` tree of a backbone ``state_dict`` (V3's
    squeeze-excites added to ``convert_mobilenetv2``'s blocks)."""
    plain = {k: v for k, v in sd.items() if ".se." not in k}
    tree = JCV.convert_mobilenetv2(plain)
    for i in range(1, 18):
        if f"features.{i}.se.fc1.weight" in sd:
            tree["params"][f"block{i}"]["SqueezeExcite_0"] = _se(sd, f"features.{i}")
    return tree


def _jax_model(sd):
    bb = _jax_backbone(strip(sd, "backbone."))
    hp, hs = JCV.convert_deeplabv3(strip(sd, "decode_head."))
    return {"params": {"backbone": bb["params"], "decode_head": hp},
            "batch_stats": {"backbone": bb["batch_stats"], "decode_head": hs}}


@pytest.mark.parametrize("v", [3, 8, 11.9, 16, 24.5, 36, 60, 100.5, 240, 1000])
def test_make_divisible_matches_jax(v):
    assert M.make_divisible(v) == JM.make_divisible(v)
    assert M.make_divisible(v, 16, 32) == JM.make_divisible(v, 16, 32)


BLOCKS = [(1, 32, 16, 1, False), (6, 16, 24, 2, False), (6, 24, 24, 1, False),
          (6, 24, 24, 1, True), (1, 32, 16, 1, True), (6, 32, 64, 2, True)]


@pytest.mark.parametrize("t,cin,cout,stride,se", BLOCKS,
                         ids=[f"t{b[0]}_{b[1]}to{b[2]}_s{b[3]}{'_se' if b[4] else ''}"
                              for b in BLOCKS])
def test_inverted_residual_matches_jax(t, cin, cout, stride, se):
    """A train-mode block (relu6, or hswish with the squeeze-excite): its
    output and every BatchNorm's running statistics after the step; the
    identity is added only at stride 1 with equal widths."""
    act = "hswish" if se else "relu6"
    port = M.InvertedResidual(cin, cout, stride, t, se, act, dtype=torch.float32).train()
    sd = {f"features.1.{k}": v for k, v in random_state_dict(port, seed=1).items()}
    load_numpy(port, strip(sd, "features.1."))
    # the block as block 1 of convert_mobilenetv2's table: its keys alone
    p, s = {}, {}
    n = 2 if t != 1 else 1
    for k in range(n):
        pre = f"features.1.conv.{k}"
        bp, bs = JCV.t_bn(sd, f"{pre}.1")
        p[f"ConvModule_{k}"] = {"Conv_0": JCV.t_conv(sd, f"{pre}.0"),
                                "BatchNorm_0": {"BatchNorm_0": bp}}
        s[f"ConvModule_{k}"] = {"BatchNorm_0": {"BatchNorm_0": bs}}
    bp, bs = JCV.t_bn(sd, f"features.1.conv.{n + 1}")
    p[f"ConvModule_{n}"] = {"Conv_0": JCV.t_conv(sd, f"features.1.conv.{n}"),
                            "BatchNorm_0": {"BatchNorm_0": bp}}
    s[f"ConvModule_{n}"] = {"BatchNorm_0": {"BatchNorm_0": bs}}
    if se:
        p["SqueezeExcite_0"] = _se(sd, "features.1")
    x = _normal(np.random.default_rng(2), (2, 10, 9, cin))
    want, new = jit_apply(JM.InvertedResidual(cout, stride, t, se, act, dtype=jnp.float32),
                          {"params": p, "batch_stats": s}, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
    got = port(torch.from_numpy(x)).detach()
    assert got.shape == want.shape
    rel_close(got.numpy(), want)
    for k in range(n + 1):
        key = f"conv.{k}.1" if k < n else f"conv.{n + 1}"
        st = new["batch_stats"][f"ConvModule_{k}"]["BatchNorm_0"]["BatchNorm_0"]
        bn = port.get_submodule(key)
        for ours, theirs in ((bn.running_mean, st["mean"]), (bn.running_var, st["var"])):
            np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-6,
                                       err_msg=key)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", ["mobilenetv2", "mobilenetv3"])
def test_mobilenet_deeplabv3_matches_jax(monkeypatch, name, train):
    """``<name>`` + ``deeplabv3`` (E = 32, 21 classes) at 64², batch 4: the
    stride-32 logits in eval, float32 on both sides, within 1e-4 of the JAX
    package's largest. In training (dropout off on both sides: the masks
    are held in ``test_torch_deeplabv3.py``) ``[main, aux]`` within 1e-4,
    the gradients of a random projection of both with respect to every
    parameter and the image within 1e-3 (plus ``GRAD_FLOOR`` of the
    model's largest), and every BatchNorm's running statistics after the
    step within 1e-4, with the port and the JAX package both in float64
    (the port's classifiers stay float32, as built). At random weights the
    training network is ill-conditioned in float32 on either framework:
    the JAX package's own float32 gradients lie farther from its float64
    ones than these bars, at every batch and size tried up to 128², batch
    8."""
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    dtype = torch.float64 if train else torch.float32
    port = SegmentationModel(name, "deeplabv3", NC, embed_dim=E, dtype=dtype).train(train)
    sd = random_state_dict(port, seed=3)
    load_numpy(port, sd)
    variables = _jax_model(sd)
    rng = np.random.default_rng(4)
    x = _normal(rng, (B, 64, 64, 3))
    if not train:
        jm = jbuild.SegmentationModel(name, "deeplabv3", NC, embed_dim=E, dtype=jnp.float32)
        want = jit_apply(jm, variables, jnp.asarray(x), train=False, resize_output=False)
        with torch.no_grad():
            got = port(torch.from_numpy(x), resize_output=False)
        assert got.shape == (B, 2, 2, NC)
        rel_close(got.numpy(), want)
        return
    port.double()
    as64 = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
    x, cts = as64(x), [as64(_normal(rng, (B, 2, 2, NC))) for _ in range(2)]
    with jax.enable_x64(True):
        jm = jbuild.SegmentationModel(name, "deeplabv3", NC, embed_dim=E, dtype=jnp.float64)
        out, gp, gx, extra = jax_vjp(jm, as64(variables), x, cts, resize_output=False,
                                     train=True, mutable=["batch_stats"])
    got, got_gp, got_gx = torch_vjp(port, x, cts, resize_output=False,
                                    noise={"dropout": [None] * 3})
    for g, o in zip(got, out):
        assert g.shape == o.shape
        rel_close(g, o)
    rel_close(got_gx, gx, 1e-3)
    trees_close(_jax_model({**sd, **got_gp})["params"], gp, of_largest=GRAD_FLOOR)
    new = {k: v.numpy() for k, v in port.state_dict().items() if "running" in k}
    trees_close(_jax_model({**sd, **new})["batch_stats"], extra["state"]["batch_stats"], 1e-4)


@pytest.mark.parametrize("name", ["mobilenetv2", "mobilenetv3"])
def test_from_jax_variables_round_trips(name):
    """Port weights (E = 768 by the default rule) -> the JAX tree ->
    ``from_jax_variables`` gives the port's ``state_dict`` back bit for bit;
    the JAX tree's shapes are the JAX model's (``jax.eval_shape`` of its
    init)."""
    port = SegmentationModel(name, "deeplabv3", NC, dtype=torch.float32)
    sd = random_state_dict(port, seed=6)
    variables = _jax_model(sd)
    jm = jbuild.SegmentationModel(name, "deeplabv3", NC, dtype=jnp.float32)
    want = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    assert (jax.tree_util.tree_map(np.shape, variables)
            == jax.tree_util.tree_map(lambda a: a.shape, dict(want)))
    back = from_jax_variables(variables)
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def test_registry_and_taps():
    """Both names are registered with the JAX registry's widths; the taps
    are blocks 3 / 6 / 13 / 17 at strides 4 to 32."""
    for name in ("mobilenetv2", "mobilenetv3"):
        from segmentation_factory_tpu_torch.registry import get_backbone

        bb, ch = get_backbone(name, dtype=torch.float32)
        assert ch == J_BACKBONES[name]()[1] == [24, 32, 96, 320]
        with torch.no_grad():
            feats = bb(torch.zeros((1, 64, 96, 3)))
        assert [tuple(f.shape) for f in feats] == [(1, 64 // s, 96 // s, c) for s, c in
                                                   zip((4, 8, 16, 32), ch)]
