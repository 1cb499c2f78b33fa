"""Every optimizer of the port (the 23 names of ``OPTIMIZERS``) under each
clip mode (``agc``, ``norm``, ``value``) against the JAX package's
``create_optimizer`` on the CPU: ten updates from the same weights on the
same gradient sequence, weight decay on, a cosine schedule with warm-up.

The tree has one of each kind of tensor: a Linear weight (16, 24) and its
bias, a 3x3 conv (8, 4, 3, 3), a depthwise conv (8, 1, 3, 3), a norm scale
of 7 (padded in the flat buffer: the padding must stay zero), and a
(256, 128) weight, which adafactor factors (its JAX kernel is
(128, 256)). The Linear's and the conv's gradients are made orthogonal to
their weights along the JAX package's channel rows (the Linear's inputs,
the conv's kernel rows), which are not the torch output channels, so
AdamP's and SGDP's projection fires where the JAX package's does.

Tolerance: every parameter within 1e-5 of the tree's largest |p| (float32
rules on values of order 1, reordered sums in the norms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from segmentation_factory_tpu import schedule as JS
from segmentation_factory_tpu.engine.state import OPTIMIZERS as J_OPTIMIZERS
from segmentation_factory_tpu.engine.state import create_optimizer as j_create_optimizer
from segmentation_factory_tpu_torch.engine import OPTIMIZERS, create_optimizer
from segmentation_factory_tpu_torch.engine.state import factored_dims
from segmentation_factory_tpu_torch.schedule import create_schedule

from _torch_port import two_torch_threads  # noqa: F401

STEPS = 10
WD = 0.05
LR = 1e-2
CLIPS = {"agc": 0.02, "norm": 1.0, "value": 0.01}
# torch name, torch shape, JAX path, layout
TREE = [
    ("fc.weight", (16, 24), ("fc", "kernel"), "linear"),
    ("fc.bias", (16,), ("fc", "bias"), "same"),
    ("conv.weight", (8, 4, 3, 3), ("conv", "kernel"), "conv"),
    ("dw.weight", (8, 1, 3, 3), ("dw", "kernel"), "conv"),
    ("norm.weight", (7,), ("norm", "scale"), "same"),
    ("big.weight", (256, 128), ("big", "kernel"), "linear"),
]


def _to_jax(x, layout):
    return x.T if layout == "linear" else x.transpose(2, 3, 1, 0) if layout == "conv" else x


def _orthogonal_rows(g, p, axis):
    """``g`` less its component along ``p`` in each slice of ``axis``."""
    gm, pm = np.moveaxis(g, axis, 0), np.moveaxis(p, axis, 0)
    gr, pr = gm.reshape(len(gm), -1), pm.reshape(len(pm), -1)
    gr = gr - (gr * pr).sum(1, keepdims=True) / (pr * pr).sum(1, keepdims=True) * pr
    return np.moveaxis(gr.reshape(gm.shape), 0, axis).astype(np.float32)


def _data():
    rng = np.random.default_rng(0)
    params = {}
    for name, shape, _, _ in TREE:
        if len(shape) == 1:
            params[name] = (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        else:
            params[name] = (rng.normal(size=shape) / np.sqrt(np.prod(shape[1:]))).astype(
                np.float32)
    grads = []
    for _ in range(STEPS):
        g = {n: (rng.normal(size=s) * 10 ** rng.uniform(-3, -1)).astype(np.float32)
             for n, s, _, _ in TREE}
        g["fc.weight"] = _orthogonal_rows(g["fc.weight"], params["fc.weight"], 1)
        g["conv.weight"] = _orthogonal_rows(g["conv.weight"], params["conv.weight"], 2)
        grads.append(g)
    return params, grads


@pytest.fixture(scope="module")
def data():
    return _data()


def _jax_tree(arrays):
    tree = {}
    for name, _, (mod, leaf), layout in TREE:
        tree.setdefault(mod, {})[leaf] = jnp.asarray(_to_jax(arrays[name], layout))
    return tree


def _run_jax(name, params, grads):
    """The JAX package's ten updates under each clip mode, one jitted step
    for the three."""
    sched = JS.create_schedule("cosine", LR, STEPS, warmup_steps=2, warmup_lr_init=1e-4,
                               min_lr=1e-4)
    tree = _jax_tree(params)
    txs = [j_create_optimizer(name, sched, weight_decay=WD, momentum=0.9, clip_grad=CLIPS[c],
                              clip_mode=c, params=tree) for c in CLIPS]

    @jax.jit
    def step(trees, states, g):
        out = [tx.update(g, st, tr) for tx, tr, st in zip(txs, trees, states)]
        return ([optax.apply_updates(tr, u) for tr, (u, _) in zip(trees, out)],
                [st for _, st in out])

    trees, states = [tree] * len(txs), [tx.init(tree) for tx in txs]
    for g in grads:
        trees, states = step(trees, states, _jax_tree(g))
    return {c: {n: np.asarray(tr[mod][leaf]) for n, _, (mod, leaf), _ in TREE}
            for c, tr in zip(CLIPS, trees)}


def _run_port(name, clip_mode, params, grads):
    sched = create_schedule("cosine", LR, STEPS, warmup_steps=2, warmup_lr_init=1e-4,
                            min_lr=1e-4)
    named = [(n, torch.nn.Parameter(torch.from_numpy(params[n].copy()))) for n, *_ in TREE]
    opt = create_optimizer(name, sched, weight_decay=WD, momentum=0.9,
                           clip_grad=CLIPS[clip_mode], clip_mode=clip_mode, params=named)
    for g in grads:
        opt.step([torch.from_numpy(g[n]) for n, *_ in TREE])
    assert int(opt.count) == STEPS
    at = 0
    for p, pad in zip(opt.params, opt.pads):  # the padding after each parameter stays zero
        at += p.numel()
        assert not opt.flat[at:at + pad.numel()].any()
        at += pad.numel()
    return {n: _to_jax(p.detach().numpy(), layout) for (n, p), (*_, layout) in zip(named, TREE)}


def test_the_names_are_the_jax_packages():
    assert tuple(OPTIMIZERS) == tuple(J_OPTIMIZERS) and len(OPTIMIZERS) == 23
    with pytest.raises(KeyError, match="adamw"):
        create_optimizer("sgdx", lambda t: 0.1, params=[("w", torch.nn.Parameter(torch.ones(2)))])
    # the JAX layout's factored axes: the (256, 128) Linear is a (128, 256) kernel
    assert factored_dims((128, 256)) == (0, 1) and factored_dims((3, 3, 4, 8)) is None


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_matches_jax(name, data):
    params, grads = data
    scale = max(np.abs(v).max() for v in params.values())
    wants = _run_jax(name, params, grads)
    for clip_mode, want in wants.items():
        got = _run_port(name, clip_mode, params, grads)
        moved = 0.0
        for n, _, _, layout in TREE:
            np.testing.assert_allclose(got[n], want[n], rtol=0, atol=1e-5 * scale,
                                       err_msg=f"{name} {clip_mode} {n}")
            moved = max(moved, np.abs(want[n] - _to_jax(params[n], layout)).max())
        assert moved > 1e-4 * scale, f"{name} {clip_mode}: the parameters did not move"
