"""MobileNetV4 (conv variants) + FPNHead (pinned config #3's family) against
the JAX package, on the CPU.

Weights are numpy, drawn for the port's reference-layout ``state_dict``
(``_torch_port.random_state_dict``) and carried to the JAX tree by the JAX
package's converters. Tolerances: float32 outputs within 1e-4 of the
reference's largest entry (reordered float32 sums); BatchNorm running
statistics after a train-mode forward of one block within 1e-5 relative;
in a whole backbone within 1e-4 of each tensor's largest entry, the bar of
the outputs whose statistics they are (a deep BatchNorm's input carries
the reordered sums of every layer before it, and the variance
E[x^2] - E[x]^2 cancels); a 10-step loss trajectory within 2e-4 relative
(its first loss 1e-5).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_factory_tpu import convert as JCV
from segmentation_factory_tpu import schedule as JS
from segmentation_factory_tpu.engine import steps as jsteps
from segmentation_factory_tpu.engine.state import TrainState
from segmentation_factory_tpu.engine.state import create_optimizer as j_create_optimizer
from segmentation_factory_tpu.models import build_model as jax_build_model
from segmentation_factory_tpu.models.backbones import mobilenetv4 as JM
from segmentation_factory_tpu.models.heads.fpn import FPNHead as JFPNHead
from segmentation_factory_tpu_torch import build_model, schedule
from segmentation_factory_tpu_torch.engine import create_optimizer, train_step
from segmentation_factory_tpu_torch.models.backbones.mobilenetv4 import (
    UIB,
    FusedIB,
    MobileNetV4,
)
from segmentation_factory_tpu_torch.models.heads.fpn import FPNHead

from _torch_port import load_numpy, random_state_dict
from _torch_port import two_torch_threads  # noqa: F401  (autouse)

TOL_STATS = dict(rtol=1e-5, atol=1e-7)


def _rel_close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max())


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _apply(module, variables, *args, **kwargs):
    """``module.apply`` compiled (an eager flax apply dispatches op by op)."""
    return jax.jit(functools.partial(module.apply, **kwargs))(variables, *args)


def _check_stats(port, jax_stats, pairs):
    """Each (port BatchNorm key, path into the JAX batch_stats) pair's
    running mean and variance."""
    for key, path in pairs:
        st = jax_stats
        for p in path:
            st = st[p]
        bn = port.get_submodule(key)
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(st["mean"]), **TOL_STATS,
                                   err_msg=key)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(st["var"]), **TOL_STATS,
                                   err_msg=key)


BN = ("BatchNorm_0", "BatchNorm_0")
UIB_PARTS = (("start_dw", "dw_start"), ("expand", "pw_exp"), ("middle_dw", "dw_mid"),
             ("project", "pw_proj"))


@pytest.mark.parametrize("start,middle,stride", [
    (3, 0, 1), (0, 3, 1), (3, 5, 1), (0, 0, 1),  # start only, middle only, both, neither
    (5, 5, 2), (3, 0, 2), (0, 5, 2)])
def test_uib_train_forward_matches_jax(start, middle, stride):
    """A train-mode UIB (batch statistics, running statistics updated):
    its output, and every BatchNorm's running statistics after the step."""
    c_in, c_out = 16, 16 if stride == 1 else 24
    port = UIB(c_in, c_out, start, middle, True, stride, 2, dtype=torch.float32).train()
    sd = random_state_dict(port, seed=11)
    load_numpy(port, sd)
    params, stats = {}, {}
    for jax_name, ref in UIB_PARTS:
        if ref in port._modules:
            params[jax_name], stats[jax_name] = JCV._t_convnormact(sd, ref)
    x = _normal(np.random.default_rng(12), (2, 12, 12, c_in))
    want, new = _apply(JM.UIB(c_out, start, middle, True, stride, 2, dtype=jnp.float32),
                       {"params": params, "batch_stats": stats}, jnp.asarray(x), train=True,
                       mutable=["batch_stats"])
    got = port(torch.from_numpy(x)).detach()
    assert got.shape == want.shape
    _rel_close(got.numpy(), want)
    _check_stats(port, new["batch_stats"], [(f"{ref}.bn", (jax_name, *BN))
                                            for jax_name, ref in UIB_PARTS
                                            if ref in port._modules])


def test_fused_ib_train_forward_matches_jax():
    port = FusedIB(16, 24, 2, 4.0, dtype=torch.float32).train()
    sd = random_state_dict(port, seed=13)
    load_numpy(port, sd)
    p0, s0 = JCV._t_conv_bn_pair(sd, "conv_exp", "bn1")
    p1, s1 = JCV._t_conv_bn_pair(sd, "conv_pwl", "bn2")
    x = _normal(np.random.default_rng(14), (2, 12, 12, 16))
    want, new = _apply(JM.FusedIB(24, 2, 4.0, dtype=jnp.float32),
                       {"params": {"ConvModule_0": p0, "ConvModule_1": p1},
                        "batch_stats": {"ConvModule_0": s0, "ConvModule_1": s1}},
                       jnp.asarray(x), train=True, mutable=["batch_stats"])
    got = port(torch.from_numpy(x)).detach()
    _rel_close(got.numpy(), want)
    _check_stats(port, new["batch_stats"], [("bn1", ("ConvModule_0", *BN)),
                                            ("bn2", ("ConvModule_1", *BN))])


@pytest.mark.parametrize("variant,train", [("small", False), ("medium", False),
                                           ("small", True), ("medium", True)])
def test_mobilenetv4_matches_jax(variant, train):
    """The whole backbone at 64²: its four levels, and in training every
    BatchNorm's running statistics after the step."""
    port = MobileNetV4(variant, dtype=torch.float32).train(train)
    sd = random_state_dict(port, seed=15)
    load_numpy(port, sd)
    variables = JCV.convert_mobilenetv4(sd, variant)
    x = _normal(np.random.default_rng(16), (2, 64, 64, 3))
    out = _apply(JM.MobileNetV4(variant, dtype=jnp.float32), variables, jnp.asarray(x),
                 train=train, mutable=["batch_stats"] if train else False)
    want, new = out if train else (out, None)
    got = port(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        _rel_close(g.detach().numpy(), w)
    if train:
        back = JCV.convert_mobilenetv4({**sd, **{k: v.numpy() for k, v in port.state_dict().items()
                                                 if "running" in k}}, variant)
        flat_want = dict(jax.tree_util.tree_leaves_with_path(new["batch_stats"]))
        for path, leaf in jax.tree_util.tree_leaves_with_path(back["batch_stats"]):
            ref = np.asarray(flat_want[path])
            np.testing.assert_allclose(leaf, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("torch_parity", [False, True])
def test_fpnhead_matches_jax(torch_parity):
    """Both modes over a pyramid at 64²'s strides: bilinear top-down at the
    finest stride, or the reference's nearest top-down with a 2x upsample
    before each smoothing conv (logits at half the finest stride)."""
    channels, nc, e = [24, 32, 48, 64], 5, 32
    port = FPNHead(channels, nc, embed_dim=e, torch_parity=torch_parity,
                   dtype=torch.float32).eval()
    sd = random_state_dict(port, seed=17)
    load_numpy(port, sd)
    rng = np.random.default_rng(18)
    feats = [_normal(rng, (2, 16 >> i, 16 >> i, c)) for i, c in enumerate(channels)]
    hp, hs = JCV.convert_fpnhead(sd, num_levels=4)
    want = _apply(JFPNHead(channels, nc, embed_dim=e, torch_parity=torch_parity,
                           dtype=jnp.float32), {"params": hp, "batch_stats": hs},
                  [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = port([torch.from_numpy(f) for f in feats])
    assert got.shape == want.shape == (2, 32 if torch_parity else 16, 32 if torch_parity else 16,
                                       nc)
    assert got.is_contiguous() and got.dtype == torch.float32
    _rel_close(got.numpy(), want)


@pytest.mark.parametrize("variant", ["hybrid_medium", "hybrid_large"])
def test_hybrid_variants_are_not_ported(variant):
    with pytest.raises(NotImplementedError, match="not ported"):
        build_model(f"mobilenetv4_{variant}", "fpnhead", 2, device="cpu")


def test_ten_step_trajectory_matches_jax():
    """A config-#3-like model (mobilenetv4_small + FPNHead, E = 128, 2
    classes), ``dicebce`` without the dice term (the resize path, not K7),
    AdamW + AGC 0.02 + weight decay 1e-4 on the cosine schedule, batch 2 at
    64², float32, from the same weights on the same batches; dropout off on
    both sides (JAX rate 0, port mask of ones).

    The peak rate is 1e-4, not the MiT test's 2e-3: at 2e-3 this net's
    float32 trajectory is chaotic on either framework alone (BatchNorm
    biases that feed another BatchNorm have gradients that are 0 but for
    rounding, which Adam scales to full steps, so a change of one weight in
    its last bits moves the port's own later losses beyond this bar).
    Config #3's own rate over its first ten steps is below 1e-5 (1e-3 after
    1500 warm-up steps)."""
    steps, lr = 10, 1e-4
    kw = dict(warmup_steps=3, warmup_lr_init=1e-6, min_lr=1e-5)
    model = build_model("mobilenetv4_small", "fpnhead", 2, dtype=torch.float32, device="cpu")
    sd = random_state_dict(model, seed=19)
    load_numpy(model, sd)
    variables = JCV.convert_full_model(sd, "mobilenetv4_small", "fpnhead")
    rng = np.random.default_rng(20)
    batches = []
    for _ in range(steps):
        lbl = rng.integers(0, 2, (2, 64, 64)).astype(np.int32)
        lbl[:, :4] = 255
        batches.append((_normal(rng, (2, 64, 64, 3)), lbl))

    jm = jax_build_model("mobilenetv4_small", "fpnhead", 2, dtype=jnp.float32,
                         head_kwargs={"dropout": 0.0})
    sched = JS.create_schedule("cosine", lr, steps, **kw)
    tx = j_create_optimizer("adamw", sched, weight_decay=1e-4, clip_grad=0.02, clip_mode="agc",
                            params=variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]), apply_fn=jm.apply, tx=tx)
    step = jax.jit(functools.partial(jsteps.train_step, loss_type="dicebce", use_dice=False,
                                     learning_rate_fn=sched))
    want = []
    for img, lbl in batches:
        state, metrics = step(state, {"image": jnp.asarray(img), "label": jnp.asarray(lbl)},
                              jax.random.PRNGKey(0))
        want.append(float(metrics["loss"]))

    opt = create_optimizer("adamw", schedule.create_schedule("cosine", lr, steps, **kw),
                           weight_decay=1e-4, clip_grad=0.02, clip_mode="agc",
                           params=model.named_parameters())
    noise = {"dropout": torch.ones((2, 128))}
    got = [float(train_step(model, opt, {"image": img, "label": lbl}, noise=noise,
                            loss_type="dicebce", use_dice=False)["loss"])
           for img, lbl in batches]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert got[-1] < got[0]
