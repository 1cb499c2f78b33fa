"""The training slice against the JAX package, on the CPU: train-mode
BatchNorm, the head tail with a given dropout mask, drop-path rates, one
AdamW + AGC + no-decay-mask update, the cosine schedule, the non-finite
skip, and 20-step loss trajectories of ``train_step`` for CE + dice and
OHEM + dice.

Weights, batches, gradients and masks come from numpy and reach both
frameworks through the weights bridge. Tolerances (all float32): layer
outputs 1e-5 (reordered sums); BatchNorm running statistics 1e-6; the
schedule 1e-6 relative or 1e-6 of the peak rate (float32 cos near
the end of a cycle); parameters after three optimizer
updates 1e-6 absolute (a few float32 roundings of values of order 0.1);
loss trajectories 2e-4 relative per step (twenty updates of a whole MiT-B0
amplify reordered float32 sums through Adam's normalisation).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from segmentation_factory_tpu import schedule as JS
from segmentation_factory_tpu.convert import convert_full_model
from segmentation_factory_tpu.engine import steps as jsteps
from segmentation_factory_tpu.engine.state import TrainState
from segmentation_factory_tpu.engine.state import create_optimizer as j_create_optimizer
from segmentation_factory_tpu.models import build_model as jax_build_model
from segmentation_factory_tpu.models.layers import common as JC
from segmentation_factory_tpu.models.layers.norm import BatchNorm as JBatchNorm
from segmentation_factory_tpu.ops.pallas_head_tail import head_tail_xla
from segmentation_factory_tpu_torch import build_model, schedule
from segmentation_factory_tpu_torch.convert import from_jax_variables
from segmentation_factory_tpu_torch.engine import create_optimizer, train_step
from segmentation_factory_tpu_torch.models.heads.segformer import SegFormerHead
from segmentation_factory_tpu_torch.models.layers import BatchNorm, drop_path_rates

from _torch_port import random_state_dict

NC = 19
TOL = dict(rtol=1e-5, atol=1e-5)
NO_NOISE = dict(backbone_kwargs={"drop_path_rate": 0.0}, head_kwargs={"dropout": 0.0})


def _no_noise(model, batch=2):
    """Drop-path factors and dropout mask of ones: rates 0 on the port side."""
    return {"drop_path": torch.ones((len(model.backbone.blocks()), 2, batch)),
            "dropout": torch.ones((batch, model.decode_head.embed_dim))}


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------- layers


def test_batch_norm_train_matches_flax():
    rng = np.random.default_rng(20)
    x = _normal(rng, (2, 5, 7, 16), 2.0) + 0.5
    p = {"scale": 1 + _normal(rng, (16,), 0.1), "bias": _normal(rng, (16,), 0.1)}
    s = {"mean": _normal(rng, (16,), 0.5), "var": 0.5 + rng.random(16).astype(np.float32)}
    want, new = JBatchNorm().apply(
        {"params": {"BatchNorm_0": p}, "batch_stats": {"BatchNorm_0": s}},
        jnp.asarray(x), train=True, mutable=["batch_stats"])
    bn = BatchNorm(16).train()
    with torch.no_grad():
        for name, v in [("weight", p["scale"]), ("bias", p["bias"]),
                        ("running_mean", s["mean"]), ("running_var", s["var"])]:
            getattr(bn, name).copy_(torch.from_numpy(v))
    got = bn(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    stats = new["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), atol=1e-6)


def test_head_tail_with_dropout_mask_matches_jax():
    rng = np.random.default_rng(21)
    e = 32
    acc = _normal(rng, (2, 6, 8, e), 2.0)
    gamma, beta = 1 + _normal(rng, (e,), 0.1), _normal(rng, (e,), 0.1)
    dmask = ((rng.random((2, e)) < 0.9) / 0.9).astype(np.float32)
    wcls, bcls = _normal(rng, (e, NC), e ** -0.5), _normal(rng, (NC,), 0.1)
    logits, mu, var = head_tail_xla(jnp.asarray(acc), jnp.asarray(gamma), jnp.asarray(beta),
                                    jnp.asarray(dmask), jnp.asarray(wcls), jnp.asarray(bcls),
                                    1e-5)
    head = SegFormerHead([8, 8, 8, 8], NC, embed_dim=e, dtype=torch.float32).train()
    bn = head.linear_fuse.bn
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(gamma))
        bn.bias.copy_(torch.from_numpy(beta))
        bn.running_mean.zero_()
        bn.running_var.fill_(1.0)
        head.linear_pred.weight.copy_(torch.from_numpy(wcls.T[:, :, None, None].copy()))
        head.linear_pred.bias.copy_(torch.from_numpy(bcls))
    got = head.tail(torch.from_numpy(acc), torch.from_numpy(dmask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(logits), **TOL)
    # the running-stat update of segformer.py:161-163, flax momentum 0.9
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.1 * np.asarray(mu), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 + 0.1 * np.asarray(var), atol=1e-6)


def test_drop_path_rates_match_jax():
    for rate, depths in [(0.1, [3, 4, 6, 3]), (0.1, [2, 2, 2, 2]), (0.3, [1]), (0.0, [2, 3])]:
        assert drop_path_rates(rate, depths) == JC.drop_path_rates(rate, depths)


# ---------------------------------------------------------------- optimizer, schedule


@pytest.mark.parametrize("kw", [
    dict(warmup_steps=5, warmup_lr_init=1e-6, min_lr=1e-5),
    dict(warmup_steps=0, min_lr=1e-5, cycle_limit=3),
    dict(warmup_steps=3, cycle_mul=2.0, cycle_decay=0.5, cycle_limit=3, k_decay=1.5),
])
def test_cosine_schedule_matches_jax(kw):
    want_fn = JS.create_schedule("cosine", 1e-3, 40, **kw)
    got_fn = schedule.create_schedule("cosine", 1e-3, 40, **kw)
    steps = np.arange(0, 130)
    want = np.asarray([float(want_fn(jnp.asarray(t))) for t in steps])
    got = got_fn(torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    assert float(got_fn(7)) == pytest.approx(float(want_fn(7)), rel=1e-6)


@pytest.fixture(scope="module")
def weights():
    """MiT-B0 + SegFormerHead weights as numpy (the port's state_dict) and as
    JAX variables."""
    port = build_model("mit_b0", "segformerhead", NC, dtype=torch.float32, device="cpu",
                        fused_blocks=False)
    sd = random_state_dict(port, seed=3)
    return sd, convert_full_model(sd, "mit_b0", "segformerhead")


def _port_model(sd):
    model = build_model("mit_b0", "segformerhead", NC, dtype=torch.float32, device="cpu",
                        fused_blocks=False)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    return model


# a sub-tree with every kind of unit: a 7x7 conv, LayerNorms, Linears, the
# depthwise conv, a strided conv, 1x1 convs, BatchNorm and 1-D biases
SUBTREE = ("backbone.patch_embed1.", "backbone.block1.0.", "decode_head.")


def _jax_subtree(tree):
    return {"backbone": {k: tree["backbone"][k] for k in ("patch_embed1", "block1_0")},
            "decode_head": tree["decode_head"]}


def test_adamw_agc_update_matches_optax(weights):
    sd, variables = weights
    model = _port_model(sd)
    rng = np.random.default_rng(22)
    params = {k: p for k, p in model.named_parameters() if k.startswith(SUBTREE)}
    # per-tensor gradient scales from 1e-4 to 1e-1: AGC clips some units and
    # leaves others
    grad_sets = [{k: _normal(rng, p.shape, 10 ** rng.uniform(-4, -1)) for k, p in params.items()}
                 for _ in range(3)]
    sched_j = JS.create_schedule("cosine", 1e-3, 100, warmup_steps=2, warmup_lr_init=1e-6,
                                 min_lr=1e-5)
    jp = _jax_subtree(variables["params"])
    tx = j_create_optimizer("adamw", sched_j, weight_decay=1e-4, clip_grad=0.02,
                            clip_mode="agc", params=jp)
    state = tx.init(jp)
    update = jax.jit(tx.update)
    opt = create_optimizer("adamw", schedule.create_schedule(
        "cosine", 1e-3, 100, warmup_steps=2, warmup_lr_init=1e-6, min_lr=1e-5),
        weight_decay=1e-4, clip_grad=0.02, clip_mode="agc", params=params.items())
    for grads in grad_sets:
        gj = _jax_subtree(convert_full_model(dict(sd, **grads), "mit_b0", "segformerhead")["params"])
        updates, state = update(gj, state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step([torch.from_numpy(grads[k]) for k in params])
    full = jax.tree_util.tree_map(np.asarray, variables["params"])
    full["backbone"].update(jax.tree_util.tree_map(np.asarray, jp["backbone"]))
    full["decode_head"] = jax.tree_util.tree_map(np.asarray, jp["decode_head"])
    want = from_jax_variables({"params": full, "batch_stats": variables["batch_stats"]})
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert int(opt.count) == 3


def test_no_decay_mask_and_agc_units():
    model = build_model("mit_b0", "segformerhead", NC, dtype=torch.float32, device="cpu",
                        fused_blocks=False)
    opt = create_optimizer("adamw", lambda t: torch.tensor(1e-3), params=model.named_parameters())
    for name, p, decay in zip(opt.names, opt.params, opt.decay):
        assert decay == (p.dim() > 1), name
        if name.endswith("bias") or ".norm" in name or ".bn." in name:
            assert not decay, name
    with pytest.raises(KeyError, match="adamw"):
        create_optimizer("sgd", lambda t: 0.1, params=model.named_parameters())


def test_flat_buffer_keeps_parameters_aligned():
    # the kernels take float32 parameters as they are: each view must start
    # 16-byte aligned, whatever the sizes before it
    params = [("a.bias", torch.nn.Parameter(torch.randn(19))),
              ("b.weight", torch.nn.Parameter(torch.randn(6, 5))),
              ("c.weight", torch.nn.Parameter(torch.randn(3, 2, 3, 3)))]
    opt = create_optimizer("adamw", lambda t: torch.tensor(1e-2), params=params)
    assert all(p.data_ptr() % 16 == 0 for _, p in params)
    before = [p.detach().clone() for _, p in params]
    opt.step([torch.ones_like(p) for _, p in params])
    for (_, p), b in zip(params, before):  # adam's first step: lr * sign(g) (+ decay)
        assert torch.all(p < b)
    assert float(opt.flat[19:20]) == 0.0  # the padding stays zero


# ---------------------------------------------------------------- train_step


def _batches(n, seed, size=64):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        img = _normal(rng, (2, size, size, 3))
        lbl = rng.integers(0, NC, (2, size, size)).astype(np.int32)
        lbl[:, :4] = 255
        out.append((img, lbl))
    return out


def test_nonfinite_loss_changes_nothing(weights):
    sd, _ = weights
    model = _port_model(sd)
    opt = create_optimizer("adamw", schedule.create_schedule("cosine", 1e-3, 10),
                           params=model.named_parameters())
    g = torch.Generator().manual_seed(0)
    img, lbl = _batches(1, 23)[0]
    train_step(model, opt, {"image": img, "label": lbl}, generator=g, loss_type="ohem")
    before = ({k: v.clone() for k, v in model.state_dict().items()},
              opt.mu.clone(), opt.nu.clone(), opt.count.clone())
    img[0, 5, 5, 1] = np.nan
    out = train_step(model, opt, {"image": img, "label": lbl}, generator=g, loss_type="ohem")
    assert int(out["skipped_nonfinite"]) == 1 and not np.isfinite(float(out["loss"]))
    for k, v in model.state_dict().items():  # parameters and BatchNorm statistics
        assert torch.equal(v, before[0][k]), k
    assert torch.equal(opt.mu, before[1]) and torch.equal(opt.nu, before[2])
    assert int(opt.count) == int(before[3]) == 1


def test_training_forward_needs_explicit_randomness(weights):
    model = _port_model(weights[0]).train()
    with pytest.raises(ValueError, match="generator"):
        model(torch.zeros((1, 64, 64, 3)))


STEPS = 20
LR = 2e-3


@pytest.mark.parametrize("loss_type", ["ce", "ohem"])
def test_twenty_step_loss_trajectory_matches_jax(weights, loss_type):
    """MiT-B0 + SegFormerHead at 64², batch 2, float32, CE or OHEM plus dice,
    AdamW + AGC 0.02 + weight decay 1e-4 on a cosine schedule with warm-up,
    from the same weights on the same batches; drop-path and dropout off on
    both sides (JAX rates 0; port factors and mask of ones), BatchNorm on
    batch statistics."""
    sd, variables = weights
    batches = _batches(STEPS, 24)
    kw = dict(warmup_steps=5, warmup_lr_init=1e-6, min_lr=1e-5)

    jmodel = jax_build_model("mit_b0", "segformerhead", NC, dtype=jnp.float32, **NO_NOISE)
    sched = JS.create_schedule("cosine", LR, STEPS, **kw)
    tx = j_create_optimizer("adamw", sched, weight_decay=1e-4, clip_grad=0.02, clip_mode="agc",
                            params=variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]), apply_fn=jmodel.apply, tx=tx)
    step = jax.jit(functools.partial(jsteps.train_step, loss_type=loss_type, use_dice=True,
                                     learning_rate_fn=sched))
    key = jax.random.PRNGKey(0)
    want = []
    for img, lbl in batches:
        state, metrics = step(state, {"image": jnp.asarray(img), "label": jnp.asarray(lbl)}, key)
        want.append(float(metrics["loss"]))

    model = _port_model(sd)
    opt = create_optimizer("adamw", schedule.create_schedule("cosine", LR, STEPS, **kw),
                           weight_decay=1e-4, clip_grad=0.02, clip_mode="agc",
                           params=model.named_parameters())
    got = [float(train_step(model, opt, {"image": img, "label": lbl}, noise=_no_noise(model),
                            loss_type=loss_type, use_dice=True)["loss"])
           for img, lbl in batches]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert got[-1] < got[0]
