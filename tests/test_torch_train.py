"""The training slice against the JAX package, on the CPU: train-mode
BatchNorm, the head tail with a given dropout mask, drop-path rates, one
AdamW + AGC + no-decay-mask update, the cosine schedule and the non-finite
skip (the 20-step loss trajectories of ``train_step``:
``test_torch_train_trajectory.py``).

Weights, batches, gradients and masks come from numpy and reach both
frameworks through the weights bridge. Tolerances (all float32): layer
outputs 1e-5 (reordered sums); BatchNorm running statistics 1e-6; the
schedule 1e-6 relative or 1e-6 of the peak rate (float32 cos near
the end of a cycle); parameters after three optimizer
updates 1e-6 absolute (a few float32 roundings of values of order 0.1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from segmentation_factory_tpu import schedule as JS
from segmentation_factory_tpu.convert import convert_full_model
from segmentation_factory_tpu.engine.state import create_optimizer as j_create_optimizer
from segmentation_factory_tpu.models.layers import common as JC
from segmentation_factory_tpu.models.layers.norm import BatchNorm as JBatchNorm
from segmentation_factory_tpu.ops.pallas_head_tail import head_tail_xla
from segmentation_factory_tpu_torch import build_model, schedule
from segmentation_factory_tpu_torch.convert import from_jax_variables
from segmentation_factory_tpu_torch.engine import create_optimizer, train_step
from segmentation_factory_tpu_torch.models.heads.segformer import SegFormerHead
from segmentation_factory_tpu_torch.models.layers import BatchNorm, drop_path_rates

from _torch_port import two_torch_threads  # noqa: F401  (autouse)
from _torch_train import NC, batches, normal, port_model, weights  # noqa: F401  (fixture)

TOL = dict(rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- layers


def test_batch_norm_train_matches_flax():
    rng = np.random.default_rng(20)
    x = normal(rng, (2, 5, 7, 16), 2.0) + 0.5
    p = {"scale": 1 + normal(rng, (16,), 0.1), "bias": normal(rng, (16,), 0.1)}
    s = {"mean": normal(rng, (16,), 0.5), "var": 0.5 + rng.random(16).astype(np.float32)}
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
    acc = normal(rng, (2, 6, 8, e), 2.0)
    gamma, beta = 1 + normal(rng, (e,), 0.1), normal(rng, (e,), 0.1)
    dmask = ((rng.random((2, e)) < 0.9) / 0.9).astype(np.float32)
    wcls, bcls = normal(rng, (e, NC), e ** -0.5), normal(rng, (NC,), 0.1)
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


# a sub-tree with every kind of unit: a 7x7 conv, LayerNorms, Linears, the
# depthwise conv, a strided conv, 1x1 convs, BatchNorm and 1-D biases
SUBTREE = ("backbone.patch_embed1.", "backbone.block1.0.", "decode_head.")


def _jax_subtree(tree):
    return {"backbone": {k: tree["backbone"][k] for k in ("patch_embed1", "block1_0")},
            "decode_head": tree["decode_head"]}


def test_adamw_agc_update_matches_optax(weights):
    sd, variables = weights
    model = port_model(sd)
    rng = np.random.default_rng(22)
    params = {k: p for k, p in model.named_parameters() if k.startswith(SUBTREE)}
    # per-tensor gradient scales from 1e-4 to 1e-1: AGC clips some units and
    # leaves others
    grad_sets = [{k: normal(rng, p.shape, 10 ** rng.uniform(-4, -1)) for k, p in params.items()}
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
        create_optimizer("sgdx", lambda t: 0.1, params=model.named_parameters())


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


def test_nonfinite_loss_changes_nothing(weights):
    sd, _ = weights
    model = port_model(sd)
    opt = create_optimizer("adamw", schedule.create_schedule("cosine", 1e-3, 10),
                           params=model.named_parameters())
    g = torch.Generator().manual_seed(0)
    img, lbl = batches(1, 23)[0]
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
    model = port_model(weights[0]).train()
    with pytest.raises(ValueError, match="generator"):
        model(torch.zeros((1, 64, 64, 3)))
