"""K6, SegFormerHead's fused training tail, against the JAX package on the
CPU: the op, the head in training, and a whole fused-configuration train
step.

The JAX side runs its Pallas head-tail kernels in interpret mode
(``pltpu.force_tpu_interpret_mode``; for the head and the model the gate
``SFT_PALLAS_TAIL=1``, with ``SFT_PALLAS_V3=1`` for the model's half-blocks,
set through ``monkeypatch``); the port runs ``head_tail_plain``, which its
wrapper takes for CPU tensors, with autograd through the batch statistics.
Inputs, weights and dropout masks come from numpy with a seed (the JAX
head's mask draw is replaced by the same numpy mask).

Tolerances: float32 outputs within 1e-5 and gradients within 2e-5 of the
largest reference entry (float32 sums reordered; the Pallas backward is the
closed form of the BatchNorm-train cotangent, the port's autograd through
the statistics), the model's gradients plus 1e-6 of its largest gradient
entry (biases whose gradients the train-mode BatchNorm cancels to
rounding). bfloat16 fuse tensors: the statistics as float32, the logits and
every gradient within 2^-6 of the largest reference entry (y1 is rounded to
bfloat16 on both sides, but a one-ulp difference in float32 before the
rounding moves a value by a bf16 ulp, 2^-8 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from segmentation_factory_tpu.convert import convert_full_model, convert_segformer_head
from segmentation_factory_tpu.engine import steps as jsteps
from segmentation_factory_tpu.models import build_model as jax_build_model
from segmentation_factory_tpu.models.heads.segformer import SegFormerHead as JaxHead
from segmentation_factory_tpu.ops import pallas_head_tail as JT
from segmentation_factory_tpu_torch import build_model
from segmentation_factory_tpu_torch.convert import _segformer_head, from_jax_variables
from segmentation_factory_tpu_torch.engine import compute_loss
from segmentation_factory_tpu_torch.models.heads.segformer import SegFormerHead
from segmentation_factory_tpu_torch.ops import head_tail

from _torch_port import load_numpy, random_state_dict

EPS = 1e-5
OUT_REL = 1e-5
GRAD_REL = 2e-5
GRAD_ABS = 1e-6
BF16_REL = 2.0 ** -6
NAMES = ["ds", "dgamma", "dbeta", "dw", "db"]


def _close(got, want, rel, name="", floor=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max() + floor, (name, err, np.abs(want).max())


def _mask(rng, b, e, keep=0.9):
    return ((rng.random((b, e)) < keep) / keep).astype(np.float32)


def _op_inputs(seed, b=2, h=8, w=16, e=64, nc=5, dropout=True):
    rng = np.random.default_rng(seed)
    n = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    s = n(b, h, w, e, sc=2.0) + 0.5
    dmask = _mask(rng, b, e) if dropout else np.ones((b, e), np.float32)
    return s, 1 + n(e, sc=0.2), n(e, sc=0.1), dmask, n(e, nc, sc=e ** -0.5), n(nc, sc=0.1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dropout", [False, True])
def test_head_tail_matches_pallas(dtype, dropout):
    """Logits, mean, var and the five gradients (s, gamma, beta, the
    classifier's weight and bias) for a random cotangent of the logits."""
    s, gamma, beta, dmask, wcls, bcls = _op_inputs(int(dropout), dropout=dropout)
    r = np.random.default_rng(7).normal(size=s.shape[:3] + (wcls.shape[1],)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16

    def jloss(s_, g_, b_, w_, c_):
        out, mu, var = JT.head_tail_train(s_, g_, b_, jnp.asarray(dmask), w_, c_, EPS)
        return jnp.sum(out * r), (out, mu, var)

    ja = (jnp.asarray(s, jdt), *map(jnp.asarray, (gamma, beta, wcls, bcls)))
    with pltpu.force_tpu_interpret_mode():
        (_, (want, wmu, wvar)), jgrads = jax.jit(jax.value_and_grad(
            jloss, argnums=tuple(range(5)), has_aux=True))(*ja)

    ts = [torch.from_numpy(s).to(tdt)] + [torch.from_numpy(a) for a in (gamma, beta)]
    ts += [torch.from_numpy(wcls.T[:, :, None, None].copy()), torch.from_numpy(bcls)]
    ts = [t.requires_grad_() for t in ts]
    got, mu, var = head_tail.head_tail_train(ts[0], ts[1], ts[2], torch.from_numpy(dmask),
                                             ts[3], ts[4], EPS)
    grads = torch.autograd.grad((got * torch.from_numpy(r)).sum(), ts)
    assert got.dtype == torch.float32 and grads[0].dtype == tdt
    out_rel = OUT_REL if dtype == "float32" else BF16_REL
    grad_rel = GRAD_REL if dtype == "float32" else BF16_REL
    _close(got.detach(), want, out_rel, "logits")
    _close(mu.detach(), wmu, OUT_REL, "mean")
    _close(var.detach(), wvar, OUT_REL, "var")
    jgrads = [np.asarray(jgrads[0], np.float32), *jgrads[1:3], np.asarray(jgrads[3]).T,
              jgrads[4]]
    for name, a, e in zip(NAMES, grads, jgrads):
        _close(a.float().reshape(np.shape(e)), e, grad_rel, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_tail_bwd_passes_match_pallas(dtype):
    """K6b's two passes through their plain versions (``head_tail_bwd`` on
    CPU tensors: ``bwd_reduce_plain``, then ``bwd_ds_plain`` on the sums
    divided by N) against the Pallas ``_bwd_rule``'s five gradients, with a
    dropout mask and a cotangent of the logits, pixels (2 x 9 x 7) that fill
    no tile evenly."""
    s, gamma, beta, dmask, wcls, bcls = _op_inputs(11, h=9, w=7, e=40, nc=6)
    r = np.random.default_rng(12).normal(size=s.shape[:3] + (wcls.shape[1],)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16

    def jloss(s_, g_, b_, w_, c_):
        out, _, _ = JT.head_tail_train(s_, g_, b_, jnp.asarray(dmask), w_, c_, EPS)
        return jnp.sum(out * r)

    ja = (jnp.asarray(s, jdt), *map(jnp.asarray, (gamma, beta, wcls, bcls)))
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(jax.grad(jloss, argnums=tuple(range(5))))(*ja)
    st = torch.from_numpy(s).to(tdt)
    mean, var = head_tail.stats_plain(st)
    w4 = torch.from_numpy(wcls.T[:, :, None, None].copy())
    before = head_tail.head_tail_bwd.launches
    got = head_tail.head_tail_bwd(st, torch.from_numpy(gamma), torch.from_numpy(beta),
                                  torch.from_numpy(dmask), w4, mean, torch.rsqrt(var + EPS),
                                  torch.from_numpy(r))
    assert head_tail.head_tail_bwd.launches == before  # CPU tensors launch no kernel
    assert got[0].dtype == tdt and got[3].shape == w4.shape
    want = [np.asarray(want[0], np.float32), *want[1:3], np.asarray(want[3]).T, want[4]]
    rel = GRAD_REL if dtype == "float32" else BF16_REL
    for name, a, e in zip(NAMES, got, want):
        _close(a.float().reshape(np.shape(e)), e, rel, name)


CHANNELS = [32, 64, 160, 256]
EMBED = 128


def _head_feats(rng):
    return [rng.normal(size=(2, 16 >> i, 16 >> i, c)).astype(np.float32)
            for i, c in enumerate(CHANNELS)]


def _tail_on(monkeypatch, mask=None):
    """The JAX head's fused-tail gate on, its kernels interpreted, and its
    dropout draw replaced by ``mask``."""
    monkeypatch.setenv("SFT_PALLAS_TAIL", "1")
    if mask is not None:
        monkeypatch.setattr(jax.random, "bernoulli",
                            lambda key, p, shape: jnp.asarray(mask > 0))
    return pltpu.force_tpu_interpret_mode()


@pytest.mark.parametrize("dropout", [False, True])
def test_head_training_matches_jax_tail(dropout, monkeypatch):
    """SegFormerHead in training (folded head, BatchNorm on batch
    statistics, the channel-dropout mask): logits, the running statistics
    after the update and every head parameter's gradient."""
    rng = np.random.default_rng(30 + int(dropout))
    nc = 5
    port = SegFormerHead(CHANNELS, nc, embed_dim=EMBED, dtype=torch.float32).train()
    sd = random_state_dict(port, seed=31)
    load_numpy(port, sd)
    feats = _head_feats(rng)
    mask = _mask(rng, 2, EMBED) if dropout else None
    r = rng.normal(size=(2, 16, 16, nc)).astype(np.float32)

    params, stats = convert_segformer_head(sd)
    jhead = JaxHead(channels=CHANNELS, num_classes=nc, embed_dim=EMBED, dtype=jnp.float32,
                    dropout=0.1 if dropout else 0.0)

    def jloss(p):
        out, new = jhead.apply({"params": p, "batch_stats": stats},
                               [jnp.asarray(f) for f in feats], train=True,
                               mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(out * r), (out, new["batch_stats"])

    with _tail_on(monkeypatch, mask):
        (_, (want, new_stats)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)

    names = [n for n, _ in port.named_parameters()]
    got = port([torch.from_numpy(f) for f in feats],
               None if mask is None else torch.from_numpy(mask))
    grads = torch.autograd.grad((got * torch.from_numpy(r)).sum(), list(port.parameters()))
    _close(got.detach(), want, OUT_REL, "logits")
    wsd = {}
    _segformer_head(wsd, jax.tree_util.tree_map(np.asarray, jgrads),
                    jax.tree_util.tree_map(np.asarray, new_stats))
    bn = port.linear_fuse.bn
    _close(bn.running_mean, wsd["decode_head.linear_fuse.bn.running_mean"], OUT_REL, "mean")
    _close(bn.running_var, wsd["decode_head.linear_fuse.bn.running_var"], OUT_REL, "var")
    assert int(bn.num_batches_tracked) == 1
    for name, g in zip(names, grads):
        want_g = wsd[f"decode_head.{name}"]
        # the fuse conv's gradient reaches both sides through the folded
        # projections; the BatchNorm cancels its mean, hence the floor
        _close(g, want_g, GRAD_REL, name, GRAD_ABS * max(float(a.abs().max())
                                                         for a in wsd.values()))


def test_head_eval_and_unfolded_keep_the_unfused_tail():
    """Eval and ``fused=False`` run ``tail``: no K6 launch is counted, and
    in eval the running statistics stay as they are."""
    port = SegFormerHead(CHANNELS, 5, embed_dim=EMBED, dtype=torch.float32).eval()
    load_numpy(port, random_state_dict(port, seed=32))
    feats = [torch.from_numpy(f) for f in _head_feats(np.random.default_rng(33))]
    before = head_tail.head_tail_train.launches
    with torch.no_grad():
        port(feats)
    assert int(port.linear_fuse.bn.num_batches_tracked) == 0
    unfolded = SegFormerHead(CHANNELS, 5, embed_dim=EMBED, dtype=torch.float32,
                             fused=False).train()
    unfolded(feats, torch.ones((2, EMBED)))
    assert int(unfolded.linear_fuse.bn.num_batches_tracked) == 1
    assert head_tail.head_tail_train.launches == before == 0


NC = 5


def test_fused_train_step_matches_jax_with_tail(monkeypatch):
    """One training forward and backward of MiT-B0 + SegFormerHead at 64²,
    CE + dice on head-resolution logits, both fused configurations on each
    side (the JAX half-block and head-tail gates on, interpreted; the
    port's defaults), drop-path and dropout off: the loss and every
    parameter's gradient."""
    port = build_model("mit_b0", "segformerhead", NC, dtype=torch.float32, device="cpu")
    sd = random_state_dict(port, seed=40)
    variables = convert_full_model(sd, "mit_b0", "segformerhead")
    rng = np.random.default_rng(41)
    img = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    lbl = rng.integers(0, NC, (2, 64, 64)).astype(np.int32)
    lbl[:, :4] = 255

    jmodel = jax_build_model("mit_b0", "segformerhead", NC, dtype=jnp.float32,
                             backbone_kwargs={"drop_path_rate": 0.0},
                             head_kwargs={"dropout": 0.0})

    def loss_fn(params):
        logits, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(img),
            train=True, resize_output=False, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0), "droppath": jax.random.PRNGKey(1)})
        return jsteps.compute_loss(logits, jnp.asarray(lbl), 255, "ce", True)

    monkeypatch.setenv("SFT_PALLAS_V3", "1")
    with _tail_on(monkeypatch):
        jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    want = from_jax_variables({"params": jgrads, "batch_stats": variables["batch_stats"]})

    load_numpy(port, sd).train()
    noise = {"drop_path": torch.ones((len(port.backbone.blocks()), 2, 2)),
             "dropout": torch.ones((2, port.decode_head.embed_dim))}
    before = head_tail.head_tail_train.launches
    logits = port(torch.from_numpy(img), resize_output=False, noise=noise)
    loss = compute_loss(logits, torch.from_numpy(lbl), 255, "ce", True)
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in port.named_parameters()])
    assert head_tail.head_tail_train.launches == before  # the CPU runs the plain version
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=OUT_REL)
    floor = GRAD_ABS * max(float(np.abs(np.asarray(want[n])).max()) for n in names)
    for n, g in zip(names, grads):
        _close(g.numpy(), want[n].numpy(), GRAD_REL, n, floor)
