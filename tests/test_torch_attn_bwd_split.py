"""The attention backward as the port's kernels compute it: K1b's core
(``sra_attention_bwd_core``: delta, dq with its column sums, dk, dv from the
forward's log2-domain lse) and K3b split into phases around it (prep, the q
and doh GEMMs, the core, the dWq / dWo / dln GEMMs, the LN backward),
composed from the phases' plain versions on the CPU, against autograd
through the plain forwards and against the JAX package: its Pallas
attention backward ``_backward`` and half-block backward rule in interpret
mode, and the half-block's XLA twin ``attn_block_xla``.

Inputs come from numpy with a seed; shapes include token counts that are
not multiples of the kernels' 64-row tiles, N far above M (a stage-1 shape
at small size) and N = M, head dims 32 and 64, and 1, 2 and 5 heads.
Tolerance: each gradient within 2e-5 of its own largest entry (float32 sums
taken in another order: p from the saved lse instead of a softmax, GEMMs
over the tokens, the LN backward's row means).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from segmentation_factory_tpu.ops import pallas_attention as JA
from segmentation_factory_tpu.ops import pallas_block as JB
from segmentation_factory_tpu_torch.models.layers.common import ln_apply
from segmentation_factory_tpu_torch.ops import block, sra_attention

from _torch_port import two_torch_threads  # noqa: F401  (autouse)

GRAD_REL = 2e-5
ATTN_NAMES = ["x", "k", "v", "lg", "lb", "wq", "bq", "wo", "bo"]


def _close(got, want, name):
    got = np.asarray(got, np.float64).reshape(np.shape(want))
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= GRAD_REL * np.abs(want).max(), (name, err, np.abs(want).max())


def _normal(rng, *shape, sc=1.0):
    return (rng.normal(size=shape) * sc).astype(np.float32)


# ---------------------------------------------------------------- K1b's core

# (b, n, m, heads, d): N ragged and far above M; N = M; D 32 and 64; 1, 2, 5 heads
CORE_CASES = [(2, 100, 7, 1, 64), (1, 70, 70, 2, 32), (1, 200, 16, 5, 32), (1, 64, 64, 2, 64)]


def _core_inputs(case):
    b, n, m, h, d = case
    rng = np.random.default_rng(sum(case))
    return [_normal(rng, b, s, h, d) for s in (n, m, m, n)]


def _core(q, k, v, g, scale):
    """K1b's plain core fed by the plain forward's output and lse."""
    t = [torch.from_numpy(a) for a in (q, k, v, g)]
    o = sra_attention.sra_attention_plain(*t[:3], scale)
    lse = sra_attention.sra_attention_lse_plain(t[0], t[1], scale)
    dq, dk, dv, delta, dbq = sra_attention.sra_attention_bwd_core(*t[:3], o, t[3], lse, scale,
                                                                  dbq=True)
    return [r.numpy() for r in (dq, dk, dv, delta, dbq, o)]


@pytest.mark.parametrize("case", CORE_CASES)
def test_core_matches_autograd(case):
    q, k, v, g = _core_inputs(case)
    scale = q.shape[-1] ** -0.5
    dq, dk, dv, delta, dbq, o = _core(q, k, v, g, scale)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = sra_attention.sra_attention_plain(*ts, scale)
    want = torch.autograd.grad(out, ts, torch.from_numpy(g))
    for name, a, e in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        _close(a, e.numpy(), name)
    _close(dbq, want[0].numpy().sum((0, 1)).reshape(-1), "dbq")
    _close(delta, (g * o).sum(-1).transpose(0, 2, 1), "delta")


@pytest.mark.parametrize("case", CORE_CASES[:3])
def test_core_matches_pallas_backward(case):
    """The JAX package's `_backward` (exact softmax per q-tile, dk/dv over
    the sequential grid) in interpret mode, on (B * H, N, D) heads."""
    q, k, v, g = _core_inputs(case)
    scale = q.shape[-1] ** -0.5
    dq, dk, dv = _core(q, k, v, g, scale)[:3]
    bhd = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3).reshape(-1, a.shape[1], a.shape[3]))  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        want = JA._backward(bhd(q), bhd(k), bhd(v), bhd(g), scale, 32)
    for name, a, e in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        e = np.asarray(e).reshape(a.shape[0], a.shape[2], a.shape[1], a.shape[3])
        _close(a, e.transpose(0, 2, 1, 3), name)


def test_core_lse_is_the_log2_logsumexp():
    q, k, _, _ = _core_inputs(CORE_CASES[1])
    t = lambda a: torch.from_numpy(a).double()  # noqa: E731
    s = torch.einsum("bnhd,bmhd->bhnm", t(q), t(k)) * 0.3
    want = torch.log2(torch.exp2(s * sra_attention.LOG2E).sum(-1))
    lse = sra_attention.sra_attention_lse_plain(torch.from_numpy(q), torch.from_numpy(k), 0.3)
    _close(lse.numpy(), want.numpy(), "lse")


# ---------------------------------------------------------------- K3b's phases

# (b, hh, w, c, m, heads, fac): N = 63 ragged, D = 64, 1 head; N = M = 130, D
# = 32, two heads with a dropped image; five heads of D = 32; N = 576 far
# above M = 9 (a stage-1 shape at small size)
ATTN_CASES = [(1, 9, 7, 64, 12, 1, [1.25]), (2, 10, 13, 64, 130, 2, [0.0, 1.25]),
              (1, 12, 12, 160, 16, 5, [1.25]), (1, 24, 24, 64, 9, 1, [1.0])]


def _attn_inputs(case):
    b, hh, w, c, m, heads, fac = case
    rng = np.random.default_rng(b * 1000 + hh * 100 + c + m)
    args = [_normal(rng, b, hh, w, c), _normal(rng, b, m, c, sc=0.5),
            _normal(rng, b, m, c, sc=0.5), 1 + _normal(rng, c, sc=0.2), _normal(rng, c, sc=0.1),
            _normal(rng, c, c, sc=c ** -0.5), _normal(rng, c, sc=0.1),
            _normal(rng, c, c, sc=c ** -0.5), _normal(rng, c, sc=0.1)]
    return args, np.asarray(fac, np.float32), _normal(rng, b, hh, w, c)


def _split(args, fac, g, heads, scale):
    """K3b through ``attn_block_bwd`` on CPU tensors (the phases' plain
    versions), fed the attention output and lse of the plain forward."""
    x, k, v, lg, lb, wq, bq, wo, _ = [torch.from_numpy(a) for a in args]
    b, hh, w, c = x.shape
    m, d = k.shape[1], c // heads
    ln = ln_apply(x.reshape(b, -1, c), lg, lb)
    q = (ln @ wq.t() + bq).view(b, -1, heads, d)
    kh, vh = k.view(b, m, heads, d), v.view(b, m, heads, d)
    o = sra_attention.sra_attention_plain(q, kh, vh, scale).reshape(x.shape)
    lse = sra_attention.sra_attention_lse_plain(q, kh, scale)
    out = block.attn_block_bwd(x, k, v, lg, lb, wq, bq, wo, torch.from_numpy(fac),
                               torch.from_numpy(g), o, lse, heads, scale)
    return [r.numpy() for r in out]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_split_backward_matches_autograd_and_xla(case):
    args, fac, g = _attn_inputs(case)
    heads = case[5]
    scale = (case[3] // heads) ** -0.5
    got = _split(args, fac, g, heads, scale)
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    out = block.attn_block_plain(*ts, torch.from_numpy(fac), heads, scale)
    want = torch.autograd.grad(out, ts, torch.from_numpy(g))
    assert len(got) == len(want) == len(ATTN_NAMES)
    for name, a, e in zip(ATTN_NAMES, got, want):
        _close(a, e.numpy(), name)
    # the XLA twin takes the weights as (in, out)
    ja = [jnp.asarray(a) for a in args]
    ja[5], ja[7] = ja[5].T, ja[7].T
    loss = lambda *a: jnp.sum(JB.attn_block_xla(*a, jnp.asarray(fac), heads, scale) * g)  # noqa: E731
    jwant = jax.jit(jax.grad(loss, argnums=tuple(range(9))))(*ja)
    for i, (name, a, e) in enumerate(zip(ATTN_NAMES, got, jwant)):
        _close(a, np.asarray(e).T if i in (5, 7) else e, name)


def test_split_backward_matches_pallas_rule():
    """One shape the TPU kernel takes (W a multiple of 8): the JAX package's
    `_attn_bwd_rule` through ``attn_block_apply(use_pallas=True)`` in
    interpret mode, two heads of D = 32 and a dropped image."""
    case = (2, 8, 8, 64, 16, 2, [0.0, 2.0])
    args, fac, g = _attn_inputs(case)
    heads, scale = 2, 32 ** -0.5
    got = _split(args, fac, g, heads, scale)
    ja = [jnp.asarray(a) for a in args]
    ja[5], ja[7] = ja[5].T, ja[7].T
    loss = lambda *a: jnp.sum(  # noqa: E731
        JB.attn_block_apply(*a, jnp.asarray(fac), heads, scale, use_pallas=True) * g)
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(jax.grad(loss, argnums=tuple(range(9))))(*ja)
    for i, (name, a, e) in enumerate(zip(ATTN_NAMES, got, want)):
        _close(a, np.asarray(e).T if i in (5, 7) else e, name)
