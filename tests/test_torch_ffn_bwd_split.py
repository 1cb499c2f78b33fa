"""The Mix-FFN backward as the port's kernels compute it (K2b and K4b split
into phases: prep, the fc1 and g W2^T GEMMs, the tile phase, the
weight-gradient GEMMs, the dln GEMM and K4b's LN backward), composed from
the phases' plain versions on the CPU, against autograd through the plain
forwards and against the JAX package's Pallas backward rules in interpret
mode.

Inputs come from numpy with a seed; shapes include heights and widths that
are not multiples of the kernels' 16 x 16 pixel tile. Tolerance: each
gradient within 2e-5 of its own largest entry (float32 sums taken in
another order: GEMMs over the pixels, the depthwise conv's transposed taps,
the LN backward's row means).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from segmentation_factory_tpu.ops import pallas_block as JB
from segmentation_factory_tpu.ops import pallas_ffn as JF
from segmentation_factory_tpu_torch.ops import block, mixffn

from _torch_port import two_torch_threads  # noqa: F401  (autouse)

GRAD_REL = 2e-5


def _inputs(rng, b, h, w, c, hc):
    """x, lg, lb, w1, b1, dw, db, w2, b2 (float32 numpy) and the cotangent."""
    n = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    args = [n(b, h, w, c), 1 + n(c, sc=0.2), n(c, sc=0.1), n(c, hc, sc=c ** -0.5),
            n(hc, sc=0.1), n(3, 3, 1, hc, sc=0.3), n(hc, sc=0.1), n(hc, c, sc=hc ** -0.5),
            n(c, sc=0.1)]
    return args, n(b, h, w, c)


def _fac(b):
    return np.asarray([0.0, 1.25][:b] if b > 1 else [1.25], np.float32)


def _close(got, want, name):
    got = np.asarray(got, np.float64).reshape(np.shape(want))
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= GRAD_REL * np.abs(want).max(), (name, err, np.abs(want).max())


def _split(args, g, fac, k4b):
    t = [torch.from_numpy(a) for a in args]
    gt = torch.from_numpy(g)
    if k4b:
        return [r.numpy() for r in block.ffn_block_bwd(*t[:8], torch.from_numpy(fac), gt)]
    return [r.numpy() for r in mixffn.mixffn_bwd(t[0], *t[3:8], gt)]


def _autograd(args, g, fac, k4b):
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    if k4b:
        out = block.ffn_block_plain(*ts, torch.from_numpy(fac))
    else:
        ts = [ts[0], *ts[3:]]
        out = mixffn.mixffn_plain(*ts)
    return [r.numpy() for r in torch.autograd.grad(out, ts, torch.from_numpy(g))]


# (b, h, w, c, hc): ragged tiles, two images (one dropped in K4b), HC not a
# multiple of the GEMM's 64-column tile
CASES = [(1, 9, 7, 32, 128), (2, 17, 5, 64, 256), (1, 6, 21, 96, 160)]


@pytest.mark.parametrize("k4b", [True, False], ids=["K4b", "K2b"])
@pytest.mark.parametrize("case", CASES)
def test_split_backward_matches_autograd(case, k4b):
    b, h, w, c, hc = case
    rng = np.random.default_rng(sum(case))
    args, g = _inputs(rng, b, h, w, c, hc)
    fac = _fac(b)
    got, want = _split(args, g, fac, k4b), _autograd(args, g, fac, k4b)
    names = (["x", "lg", "lb"] if k4b else ["y"]) + ["w1", "b1", "dw", "db", "w2", "b2"]
    assert len(got) == len(want) == len(names)
    for name, a, e in zip(names, got, want):
        _close(a, e, name)


def test_phases_compose_the_plain_products():
    """The tile phase's outputs and the GEMMs' forms on one small map: hg is
    GELU of the depthwise conv, dh1 its input gradient, and the TN GEMM's
    transposed store is the transpose of its plain store."""
    rng = np.random.default_rng(7)
    h1, dhg = (torch.from_numpy(rng.normal(size=(1, 5, 6, 32)).astype(np.float32))
               for _ in range(2))
    dw = torch.from_numpy(rng.normal(size=(3, 3, 1, 32)).astype(np.float32) * 0.3)
    db = torch.from_numpy(rng.normal(size=(32,)).astype(np.float32) * 0.1)
    hg, dh1, ddw, ddb, db1 = mixffn.ffn_bwd_tile(h1, dhg, dw, db)
    x = h1.clone().requires_grad_()
    w = dw.clone().requires_grad_()
    hd = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), db,
                                    padding=1, groups=32).permute(0, 2, 3, 1)
    gx, gw = torch.autograd.grad(torch.nn.functional.gelu(hd), (x, w), dhg)
    for name, a, e in (("hg", hg, torch.nn.functional.gelu(hd)), ("dh1", dh1, gx),
                       ("ddw", ddw, gw), ("db1", db1, gx.sum((0, 1, 2)))):
        _close(a.detach().numpy(), e.detach().numpy(), name)
    a, bb = torch.randn(40, 24), torch.randn(40, 8)
    plain = mixffn.gemm_tn(a, bb, torch.zeros(24, 8))
    torch.testing.assert_close(mixffn.gemm_tn(a, bb, torch.zeros(8, 24), True), plain.t())
    torch.testing.assert_close(plain, a.t() @ bb, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(mixffn.gemm_nt(a.t().contiguous(), bb.t().contiguous()), plain,
                               rtol=1e-5, atol=1e-5)
    assert torch.isfinite(ddb).all()


def _jax_grads(fn, args, g):
    ja = [jnp.asarray(a) for a in args]
    loss = lambda *a: jnp.sum(fn(*a) * g)
    grads = jax.jit(jax.grad(loss, argnums=tuple(range(len(ja)))))(*ja)
    return [np.asarray(x) for x in grads]


@pytest.mark.parametrize("k4b", [True, False], ids=["K4b", "K2b"])
def test_split_backward_matches_pallas(k4b):
    """One shape the TPU kernels take (H a multiple of their row tile, W of
    8, HC of 128): the JAX package's `_ffn_bwd_rule` (K4b) and `_bwd_rule`
    (K2b) run in interpret mode."""
    b, h, w, c, hc = 2, 16, 8, 32, 128
    rng = np.random.default_rng(21)
    args, g = _inputs(rng, b, h, w, c, hc)
    fac = _fac(b)
    got = _split(args, g, fac, k4b)
    with pltpu.force_tpu_interpret_mode():
        if k4b:
            want = _jax_grads(lambda *a: JB.ffn_block_apply(*a, jnp.asarray(fac),
                                                            use_pallas=True), args, g)
        else:
            want = _jax_grads(lambda *a: JF.mixffn_apply(*a, use_pallas=True),
                              [args[0], *args[3:]], g)
    for i, (a, e) in enumerate(zip(got, want)):
        _close(a, e, i)
