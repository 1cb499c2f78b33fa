"""ConvNeXt + UPerHead (pinned config #2's family), and ConvNeXtV2's GRN,
against the JAX package, on the CPU.

Weights are numpy, drawn for the port's reference-layout ``state_dict``
(``_torch_port.random_state_dict``) and carried to the JAX tree by the JAX
package's converters. Tolerances: float32 features and logits within 1e-4
of the reference's largest entry (reordered float32 sums); in bfloat16 the
port's error from the JAX float32 output at most twice the JAX bfloat16
output's own; a 10-step loss trajectory within 2e-4 relative (its first
loss 1e-5). The conversion round trip and config #2's file through the
Trainer are in tests/test_torch_pinned_configs.py.
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
    convert_convnext,
    convert_convnextv2,
    convert_full_model,
    convert_uperhead,
    t_convmodule,
)
from segmentation_factory_tpu.engine import steps as jsteps
from segmentation_factory_tpu.engine.state import TrainState
from segmentation_factory_tpu.engine.state import create_optimizer as j_create_optimizer
from segmentation_factory_tpu.models import build_model as jax_build_model
from segmentation_factory_tpu.models.backbones.convnext import ConvNeXt as JConvNeXt
from segmentation_factory_tpu.models.heads.upernet import UPerHead as JUPerHead
from segmentation_factory_tpu.models.layers import common as JC
from segmentation_factory_tpu.models.layers.norm import GRN as JGRN
from segmentation_factory_tpu.models.modules.ppm import PPM as JPPM
from segmentation_factory_tpu_torch import build_model, schedule
from segmentation_factory_tpu_torch.engine import create_optimizer, train_step
from segmentation_factory_tpu_torch.models.backbones.convnext import ConvNeXt
from segmentation_factory_tpu_torch.models.heads.upernet import UPerHead
from segmentation_factory_tpu_torch.models.layers import GRN
from segmentation_factory_tpu_torch.models.modules.ppm import PPM

from _torch_port import jax_vjp, load_numpy, random_state_dict, rel_close, strip, torch_vjp
from _torch_port import two_torch_threads  # noqa: F401  (autouse)

DEPTHS, DIMS = (1, 1, 2, 1), (32, 64, 96, 128)  # ConvNeXt at narrow widths
E = 32


def _rel_close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max())


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _apply(module, variables, *args, **kwargs):
    """``module.apply`` compiled (an eager flax apply dispatches op by op)."""
    return jax.jit(functools.partial(module.apply, **kwargs))(variables, *args)


# ---------------------------------------------------------------- modules


@pytest.mark.parametrize("size", [64, 67, 70])
def test_convnext_features_match_jax(size):
    """Eval features per level at narrow widths. 67 and 70 are sizes the
    stem's stride does not divide: flax pads SAME, (0, 1) and (1, 1) rows
    and columns at the stem, (0, 1) at each downsample."""
    port = ConvNeXt(DEPTHS, DIMS, 0.0, dtype=torch.float32).eval()
    sd = random_state_dict(port, seed=1)
    load_numpy(port, sd)
    x = _normal(np.random.default_rng(2), (2, size, size, 3))
    want = _apply(JConvNeXt(DEPTHS, DIMS, dtype=jnp.float32),
                  {"params": convert_convnext(sd, DEPTHS)}, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        _rel_close(g.numpy(), w)


def test_grn_matches_jax():
    """ConvNeXtV2's GRN on a (2, 5, 7, 24) map in float32: forward and the
    gradients of a random projection of its output with respect to gamma,
    beta and the input (the reference's (1, 1, 1, C) parameters, (C,) in
    the JAX tree)."""
    port = GRN(24)
    sd = random_state_dict(port, seed=11)
    load_numpy(port, sd)
    rng = np.random.default_rng(12)
    x, ct = _normal(rng, (2, 5, 7, 24)), _normal(rng, (2, 5, 7, 24))
    flat = lambda d: {k: np.asarray(v).reshape(-1) for k, v in d.items()}  # noqa: E731
    out, gp, gx, _ = jax_vjp(JGRN(), {"params": flat(sd)}, x, [ct])
    (got,), got_gp, got_gx = torch_vjp(port, x, [ct])
    rel_close(got, out)
    rel_close(got_gx, gx, 1e-3)
    for k, v in flat(got_gp).items():
        rel_close(v, gp[k], 1e-3)


@pytest.mark.parametrize("size", [64, 67])
def test_convnextv2_features_match_jax(size):
    """ConvNeXt with ``use_grn`` (ConvNeXtV2: GRN after the GELU, no layer
    scale) at narrow widths, eval features per level, the weights carried
    by ``convert_convnextv2``."""
    port = ConvNeXt(DEPTHS, DIMS, 0.0, dtype=torch.float32, use_grn=True).eval()
    sd = random_state_dict(port, seed=13)
    load_numpy(port, sd)
    assert not any(k.endswith(".gamma") and "grn" not in k for k in sd)
    x = _normal(np.random.default_rng(14), (2, size, size, 3))
    want = _apply(JConvNeXt(DEPTHS, DIMS, use_grn=True, dtype=jnp.float32),
                  {"params": convert_convnextv2(sd, DEPTHS)}, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for g, w in zip(got, want):
        _rel_close(g.numpy(), w)


def _ppm_jax_vars(sd, n):
    params, stats = {}, {}
    for k in range(n + 1):
        key = f"stages.{k}.1" if k < n else "bottleneck"
        params[f"ConvModule_{k}"], stats[f"ConvModule_{k}"] = t_convmodule(sd, key)
    return {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("side,train", [(16, False), (12, False), (16, True)])
def test_ppm_matches_jax(side, train):
    """At 16 x 16 the bins 3 and 6 take the bilinear resize (no antialias)
    and 1 and 2 the mean of windows; at 12 x 12 every bin divides. In
    training the BatchNorms take batch statistics and update their running
    ones."""
    c = 24
    port = PPM(c, E, dtype=torch.float32).train(train)
    sd = random_state_dict(port, seed=3)
    load_numpy(port, sd)
    x = _normal(np.random.default_rng(4), (2, side, side, c))
    out = _apply(JPPM(E, dtype=jnp.float32), _ppm_jax_vars(sd, 4), jnp.asarray(x), train=train,
                 mutable=["batch_stats"] if train else False)
    want, new = out if train else (out, None)
    got = port(torch.from_numpy(x)).detach()
    _rel_close(got.numpy(), want)
    if train:
        for k in range(5):
            key = f"stages.{k}.1.1" if k < 4 else "bottleneck.1"
            st = new["batch_stats"][f"ConvModule_{k}"]["BatchNorm_0"]["BatchNorm_0"]
            bn = port.get_submodule(key)
            np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(st["mean"]),
                                       rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(st["var"]),
                                       rtol=1e-5, atol=1e-7)


def test_uperhead_matches_jax():
    """UPerHead over a narrow pyramid at 64²'s strides (16² to 2²: the PPM's
    bins 3 and 6 upsample the 2 x 2 top level), eval."""
    nc = 7
    port = UPerHead(DIMS, nc, embed_dim=E, dtype=torch.float32).eval()
    sd = random_state_dict(port, seed=5)
    load_numpy(port, sd)
    rng = np.random.default_rng(6)
    feats = [_normal(rng, (2, 16 >> i, 16 >> i, c)) for i, c in enumerate(DIMS)]
    hp, hs = convert_uperhead(sd)
    want = _apply(JUPerHead(DIMS, nc, embed_dim=E, dtype=jnp.float32),
                  {"params": hp, "batch_stats": hs}, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = port([torch.from_numpy(f) for f in feats])
    assert got.is_contiguous() and got.dtype == torch.float32
    _rel_close(got.numpy(), want)


def test_drop_path_factors_follow_the_variant_rate():
    """One factor a block (18 for tiny) at the rates of
    ``drop_path_rates(0.1, depths)``: 1 / keep or 0, the first block never
    dropped; MobileNetV4 (no drop-path) draws only the head's mask."""
    model = build_model("convnext_tiny", "uperhead", 150, dtype=torch.float32, device="cpu")
    rates = [r for stage in JC.drop_path_rates(0.1, [3, 3, 9, 3]) for r in stage]
    assert [blk.drop_path_rate for blk in model.backbone.blocks()] == rates
    noise = model.sample_noise(64, torch.Generator().manual_seed(0))
    f = noise["drop_path"]
    assert f.shape == (18, 64) and noise["dropout"].shape == (64, 128)
    assert torch.equal(f[0], torch.ones(64))
    for row, rate in zip(f[1:], rates[1:]):
        assert set(row.tolist()) <= {0.0, float(torch.tensor(1.0) / (1.0 - rate))}
    mnv4 = build_model("mobilenetv4_small", "fpnhead", 2, dtype=torch.float32, device="cpu")
    assert set(mnv4.sample_noise(2, torch.Generator().manual_seed(0))) == {"dropout"}
    mnv4.train()(torch.zeros((2, 64, 64, 3)), generator=torch.Generator().manual_seed(0))


# ---------------------------------------------------------------- config #2's model


@pytest.fixture(scope="module")
def tiny():
    """convnext_tiny + uperhead at full width, 150 classes: the port's
    random weights, the JAX variables, and the JAX models in float32 and
    bfloat16."""
    port = build_model("convnext_tiny", "uperhead", 150, dtype=torch.float32, device="cpu")
    sd = random_state_dict(port, seed=7)
    load_numpy(port, sd)
    variables = convert_full_model(sd, "convnext_tiny", "uperhead")
    x = _normal(np.random.default_rng(8), (2, 64, 64, 3))
    outs = {}
    for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        jm = jax_build_model("convnext_tiny", "uperhead", 150, dtype=dt)
        outs[name] = np.asarray(_apply(jm, variables, jnp.asarray(x), train=False), np.float32)
    return sd, x, outs


def test_convnext_tiny_uperhead_matches_jax(tiny):
    sd, x, want = tiny
    port = build_model("convnext_tiny", "uperhead", 150, dtype=torch.float32, device="cpu")
    load_numpy(port, sd)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (2, 64, 64, 150)
    _rel_close(got.numpy(), want["f32"])


def test_convnext_tiny_uperhead_bf16_within_twice_jax_bf16(tiny):
    """bfloat16 compute: the port's error from the JAX float32 logits is at
    most twice the JAX bfloat16 logits' own."""
    sd, x, want = tiny
    port = build_model("convnext_tiny", "uperhead", 150, dtype=torch.bfloat16, device="cpu")
    load_numpy(port, sd)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).float().numpy()
    err = np.abs(got - want["f32"]).max()
    err_jax = np.abs(want["bf16"] - want["f32"]).max()
    assert np.isfinite(got).all() and 0 < err <= 2 * err_jax, (err, err_jax)


# ---------------------------------------------------------------- training


class _JaxNarrow(fnn.Module):
    """Narrow ConvNeXt + UPerHead as the JAX ``SegmentationModel`` composes
    them (the registry has no narrow ConvNeXt); drop-path and dropout off."""

    nc: int
    dtype: Any = jnp.float32

    @fnn.compact
    def __call__(self, x, train: bool = False, resize_output: bool = True):
        feats = JConvNeXt(DEPTHS, DIMS, drop_path_rate=0.0, dtype=self.dtype,
                          name="backbone")(x, train=train)
        lo = JUPerHead(DIMS, self.nc, embed_dim=E, dropout=0.0, dtype=self.dtype,
                       name="decode_head")(feats, train=train)
        return lo if not resize_output else JC.resize(lo, (x.shape[1], x.shape[2]))


def _batches(n, seed, nc, size=64):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        img = _normal(rng, (2, size, size, 3))
        lbl = rng.integers(0, nc, (2, size, size)).astype(np.int32)
        lbl[:, :4] = 255
        out.append((img, lbl))
    return out


STEPS, LR = 10, 2e-3
SCHED = dict(warmup_steps=3, warmup_lr_init=1e-6, min_lr=1e-5)


def test_ten_step_trajectory_matches_jax():
    """A config-#2-like model (narrow ConvNeXt + UPerHead, 150 classes),
    CE + dice through the fused low-resolution loss (its plain version on
    the CPU), AdamW + AGC 0.02 + weight decay 0.05 on the cosine schedule,
    batch 2 at 64², float32, from the same weights on the same batches;
    drop-path and dropout off on both sides (JAX rates 0; port factors and
    mask of ones)."""
    nc = 150
    model = build_model("convnext_tiny", "uperhead", nc, dtype=torch.float32, device="cpu")
    model.backbone = ConvNeXt(DEPTHS, DIMS, 0.0, dtype=torch.float32)
    model.decode_head = UPerHead(DIMS, nc, embed_dim=E, dtype=torch.float32)
    sd = random_state_dict(model, seed=9)
    load_numpy(model, sd)
    hp, hs = convert_uperhead(strip(sd, "decode_head."))
    params = {"backbone": convert_convnext(strip(sd, "backbone."), DEPTHS), "decode_head": hp}
    batches = _batches(STEPS, 10, nc)

    jm = _JaxNarrow(nc)
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
    noise = {"drop_path": torch.ones((sum(DEPTHS), 2)), "dropout": torch.ones((2, E))}
    got = [float(train_step(model, opt, {"image": img, "label": lbl}, noise=noise,
                            loss_type="ce", use_dice=True)["loss"])
           for img, lbl in batches]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert got[-1] < got[0]
