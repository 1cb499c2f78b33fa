"""The fused MiT configuration of the port (K3 and K4, the attention and FFN
half-blocks) against the JAX package on the CPU, in float32.

The JAX side runs its Pallas half-block kernels in interpret mode
(``pltpu.force_tpu_interpret_mode``, the gate ``SFT_PALLAS_V3=1`` set
through ``monkeypatch`` where a whole module is compared) and its XLA twins
``attn_block_xla`` / ``ffn_block_xla``; the port runs the plain versions,
which its wrappers take for CPU tensors. Inputs and weights come from numpy
with a seed.

Tolerances: outputs within 1e-5 of the largest reference entry; each
gradient within 2e-5 of its own largest entry (float32 sums reordered; the
TPU kernels' softmax is exact over M where the plain version's is torch's).
The whole-model gradients add 1e-6 of the model's largest gradient entry,
for the biases whose gradients the train-mode BatchNorm cancels to rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from segmentation_factory_tpu.convert import convert_full_model, convert_mit
from segmentation_factory_tpu.engine import steps as jsteps
from segmentation_factory_tpu.models import build_model as jax_build_model
from segmentation_factory_tpu.models.backbones.mit import MiT as JaxMiT
from segmentation_factory_tpu.models.backbones.mit import MiTBlock as JaxMiTBlock
from segmentation_factory_tpu.ops import pallas_block as JB
from segmentation_factory_tpu_torch import build_model
from segmentation_factory_tpu_torch.convert import from_jax_variables
from segmentation_factory_tpu_torch.engine import compute_loss
from segmentation_factory_tpu_torch.models.backbones.mit import MIT_SETTINGS, MiT
from segmentation_factory_tpu_torch.ops import block

from _torch_port import load_numpy, random_state_dict, two_torch_threads  # noqa: F401  (autouse)

OUT_REL = 1e-5
GRAD_REL = 2e-5
GRAD_ABS = 1e-6
NC = 5
ATTN_NAMES = ["x", "k", "v", "lg", "lb", "wq", "bq", "wo", "bo"]
FFN_NAMES = ["x", "lg", "lb", "w1", "b1", "dw", "db", "w2", "b2"]


def _close(got, want, rel, name="", floor=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max() + floor, (name, err, np.abs(want).max())


def _attn_inputs(rng, b, h, w, c, m, fac):
    n = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    return [n(b, h, w, c), n(b, m, c, sc=0.5), n(b, m, c, sc=0.5), 1 + n(c, sc=0.2),
            n(c, sc=0.1), n(c, c, sc=c ** -0.5), n(c, sc=0.1), n(c, c, sc=c ** -0.5),
            n(c, sc=0.1), np.asarray(fac, np.float32)]


def _ffn_inputs(rng, b, h, w, c, fac):
    n = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    hc = 4 * c
    return [n(b, h, w, c), 1 + n(c, sc=0.2), n(c, sc=0.1), n(c, hc, sc=c ** -0.5),
            n(hc, sc=0.1), n(3, 3, 1, hc, sc=0.3), n(hc, sc=0.1), n(hc, c, sc=hc ** -0.5),
            n(c, sc=0.1), np.asarray(fac, np.float32)]


def _torch_value_and_grads(fn, args, r):
    ts = [torch.from_numpy(a).requires_grad_(i < len(args) - 1) for i, a in enumerate(args)]
    out = fn(*ts)
    grads = torch.autograd.grad((out * torch.from_numpy(r)).sum(), ts[:-1])
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax_value_and_grads(fn, args, r):
    ja = [jnp.asarray(a) for a in args]

    def loss(*a):
        out = fn(*a, ja[-1])
        return jnp.sum(out * r), out

    vg = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(len(ja) - 1)), has_aux=True))
    (_, out), grads = vg(*ja[:-1])
    return np.asarray(out), [np.asarray(g) for g in grads]


# (b, h, w, c, m, heads, fac): one tile; two heads with a dropped image; a
# row-tiled case (the JAX budgets shrunk so dk/dv accumulate across tiles);
# MiT-B0's C = 160 with 5 heads of 32 and C = 256 with 8 (the K3f kernel's
# column blocks past C zero-padded)
ATTN_CASES = [(1, 8, 8, 64, 8, 1, [1.0]), (2, 8, 8, 64, 16, 2, [0.0, 2.0]),
              (2, 16, 8, 64, 8, 1, [1.25, 0.0]), (2, 8, 8, 160, 16, 5, [0.0, 1.25]),
              (1, 8, 8, 256, 16, 8, [1.0])]


@pytest.mark.parametrize("case", range(len(ATTN_CASES)))
def test_attn_block_matches_pallas_and_xla(case, monkeypatch):
    b, h, w, c, m, heads, fac = ATTN_CASES[case]
    if case == 2:
        monkeypatch.setattr(JB, "_ATTN_FWD_BUDGET", 64 * 1024)
        monkeypatch.setattr(JB, "_ATTN_BWD_BUDGET", 64 * 1024)
    rng = np.random.default_rng(case)
    args = _attn_inputs(rng, b, h, w, c, m, fac)
    r = rng.normal(size=args[0].shape).astype(np.float32)
    scale = (c // heads) ** -0.5
    # the JAX weights are (in, out), the port's nn.Linear's (out, in)
    got, dgot = _torch_value_and_grads(
        lambda x, k, v, lg, lb, wq, bq, wo, bo, f: block.attn_block_plain(
            x, k, v, lg, lb, wq.t(), bq, wo.t(), bo, f, heads, scale), args, r)
    with pltpu.force_tpu_interpret_mode():
        want_p, dwant_p = _jax_value_and_grads(
            lambda *a: JB.attn_block_apply(*a, heads, scale, use_pallas=True), args, r)
    want_x, dwant_x = _jax_value_and_grads(
        lambda *a: JB.attn_block_xla(*a, heads, scale), args, r)
    for want, dwant in ((want_p, dwant_p), (want_x, dwant_x)):
        _close(got, want, OUT_REL, "out")
        for name, a, e in zip(ATTN_NAMES, dgot, dwant):
            _close(a, e, GRAD_REL, name)
    if fac[0] == 0.0:  # a dropped image passes through
        np.testing.assert_array_equal(got[0], args[0][0])


# ... and MiT-B0's C = 160 and 256 (K4f's fc2 blocks zero-padded, C = 160
# not a multiple of its 64-column blocks)
FFN_CASES = [(1, 16, 8, 32, [1.0]), (2, 16, 8, 32, [0.0, 2.0]), (2, 16, 8, 32, [1.25, 0.5]),
             (1, 8, 8, 160, [1.0]), (2, 8, 8, 256, [0.0, 1.25])]


@pytest.mark.parametrize("case", range(len(FFN_CASES)))
def test_ffn_block_matches_pallas_and_xla(case, monkeypatch):
    b, h, w, c, fac = FFN_CASES[case]
    if case == 2:  # two row tiles: the halo rows come from the neighbour tile
        monkeypatch.setattr(JB, "_FFN_FWD_BUDGET", 100_000)
        assert JB._ffn_pick_tile(h, w, 4 * c) == 8
    rng = np.random.default_rng(10 + case)
    args = _ffn_inputs(rng, b, h, w, c, fac)
    r = rng.normal(size=args[0].shape).astype(np.float32)
    got, dgot = _torch_value_and_grads(block.ffn_block_plain, args, r)
    with pltpu.force_tpu_interpret_mode():
        want_p, dwant_p = _jax_value_and_grads(
            lambda *a: JB.ffn_block_apply(*a, use_pallas=True), args, r)
    want_x, dwant_x = _jax_value_and_grads(
        lambda x, lg, lb, w1, b1, dw, db, w2, b2, f: JB.ffn_block_xla(
            x, lg, lb, w1, b1, dw[:, :, 0], db, w2, b2, f), args, r)
    for want, dwant in ((want_p, dwant_p), (want_x, dwant_x)):
        _close(got, want, OUT_REL, "out")
        for name, a, e in zip(FFN_NAMES, dgot, dwant):
            _close(a, e.reshape(a.shape), GRAD_REL, name)
    if fac[0] == 0.0:
        np.testing.assert_array_equal(got[0], args[0][0])


def _jax_fused(monkeypatch):
    """The JAX package's fused gate on, its Pallas kernels interpreted."""
    monkeypatch.setenv("SFT_PALLAS_V3", "1")
    return pltpu.force_tpu_interpret_mode()


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_mit_block_matches_jax_fused(stage, monkeypatch):
    """One MiT-B2 block of stage 1/2/3 (C = 64/128/320, 1/2/5 heads, sr
    8/4/2) on its map at a 64² input, weights through the converter."""
    dims, depths = MIT_SETTINGS["b2"][0], (1, 1, 1, 1)
    port = MiT(dims, depths, dtype=torch.float32, fused_blocks=True).eval()
    sd = random_state_dict(port, seed=stage)
    load_numpy(port, sd)
    blk = getattr(port, f"block{stage}")[0]
    assert blk.fused
    side = 64 // 2 ** (stage + 1)
    c = dims[stage - 1]
    x = np.random.default_rng(7).normal(size=(2, side, side, c)).astype(np.float32)
    with torch.no_grad():
        got = blk(torch.from_numpy(x).view(2, -1, c), side, side).view(x.shape).numpy()
    jblk = JaxMiTBlock(c, (1, 2, 5, 8)[stage - 1], (8, 4, 2, 1)[stage - 1], dtype=jnp.float32)
    params = convert_mit(sd, depths)[f"block{stage}_0"]
    with _jax_fused(monkeypatch):
        want = jax.jit(jblk.apply)({"params": params}, jnp.asarray(x))
    _close(got, want, OUT_REL)


def test_mit_b0_levels_match_jax_fused(monkeypatch):
    dims, depths = MIT_SETTINGS["b0"]
    port = MiT(dims, depths, dtype=torch.float32).eval()  # fused by default
    assert all(blk.fused for blk in port.blocks())
    sd = random_state_dict(port, seed=0)
    load_numpy(port, sd)
    x = np.random.default_rng(1).normal(size=(2, 64, 64, 3)).astype(np.float32)
    jmit = JaxMiT(embed_dims=dims, depths=depths, dtype=jnp.float32)
    with _jax_fused(monkeypatch):
        want = jax.jit(lambda v, a: jmit.apply(v, a, train=False))(
            {"params": convert_mit(sd, depths)}, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for g, w in zip(got, want):
        _close(g.numpy(), w, OUT_REL)


@pytest.fixture(scope="module")
def weights():
    port = build_model("mit_b0", "segformerhead", NC, dtype=torch.float32, device="cpu")
    sd = random_state_dict(port, seed=4)
    return sd, convert_full_model(sd, "mit_b0", "segformerhead")


def test_converted_weights_give_both_configurations(weights):
    """JAX variables through ``from_jax_variables`` load into either
    configuration (one parameter tree) and give the same logits."""
    _, variables = weights
    sd = from_jax_variables(variables)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 64, 64, 3)).astype(np.float32))
    out = []
    for fused in (True, False):
        model = build_model("mit_b0", "segformerhead", NC, dtype=torch.float32, device="cpu",
                            fused_blocks=fused)
        model.load_state_dict(sd)
        assert sum(blk.fused for blk in model.backbone.blocks()) == (8 if fused else 0)
        with torch.no_grad():
            out.append(model(x).numpy())
    _close(out[0], out[1], OUT_REL)


def test_train_step_loss_and_grads_match_jax_fused(weights, monkeypatch):
    """One training forward and backward of MiT-B0 + SegFormerHead at 64²,
    CE + dice on head-resolution logits, train-mode BatchNorm, drop-path and
    dropout off (JAX rates 0, port factors and mask of ones): the loss and
    every parameter's gradient."""
    sd, variables = weights
    rng = np.random.default_rng(5)
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

    with _jax_fused(monkeypatch):
        jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    want = from_jax_variables({"params": jgrads, "batch_stats": variables["batch_stats"]})

    model = build_model("mit_b0", "segformerhead", NC, dtype=torch.float32, device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    model.train()
    noise = {"drop_path": torch.ones((len(model.backbone.blocks()), 2, 2)),
             "dropout": torch.ones((2, model.decode_head.embed_dim))}
    logits = model(torch.from_numpy(img), resize_output=False, noise=noise)
    loss = compute_loss(logits, torch.from_numpy(lbl), 255, "ce", True)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=OUT_REL)
    floor = GRAD_ABS * max(float(np.abs(np.asarray(want[n])).max()) for n in names)
    for n, g in zip(names, grads):
        _close(g.numpy(), want[n].numpy(), GRAD_REL, n, floor)
