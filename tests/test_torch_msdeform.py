"""K9's plain version (``ops/msdeform.py``) against the JAX package, on the CPU.

The same numpy inputs go through JAX's oracle ``ms_deform_attn`` and its
production path ``ms_deform_attn_fast`` (the scatter-free custom VJP on,
its default) and through the port's plain forward, autograd of it and its
written-out backward ``ms_deform_attn_bwd_plain``, in float32. Locations
run from -0.3 to 1.3 and include points on a map's edge (0, 1 and the
half-pixel borders) and far outside (-3, 4). Tolerance: 1e-5 of the
largest reference entry (float32 sums in another order). Also: head dims
32 and 96, ragged level sizes, the kernel wrapper's refusals on the CPU and
``sft::ms_deform_attn`` under ``torch.export``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_factory_tpu.ops.msdeform import ms_deform_attn as jax_oracle
from segmentation_factory_tpu.ops.msdeform import ms_deform_attn_fast as jax_fast
from segmentation_factory_tpu_torch.ops import msdeform

from _torch_port import two_torch_threads  # noqa: F401  (autouse)

# (levels, B, Q, M, D, P): MiT-B0's head dim 32 and the slice's 96, on
# ragged level sizes (odd, non-square, a 1 x 1 level)
CASES = {
    "d32_ragged": (((7, 5), (4, 3), (1, 1)), 2, 9, 2, 32, 3),
    "d96": (((8, 8), (4, 4), (2, 2)), 1, 6, 2, 96, 4),
}
REL = 1e-5


def _inputs(levels, b, q, m, d, p, seed):
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in levels)
    n = len(levels)
    value = rng.normal(size=(b, s, m, d)).astype(np.float32)
    loc = rng.uniform(-0.3, 1.3, size=(b, q, m, n, p, 2)).astype(np.float32)
    # edges: the map's border, the first and last pixel centres' half-pixel
    # borders, and points far outside
    loc[0, 0, 0, :, 0] = 0.0
    loc[0, 0, 0, :, 1] = 1.0
    loc[0, 1, 0, 0, 0] = (0.5 / levels[0][1], 1.0 - 0.5 / levels[0][0])
    loc[0, 1, -1] = -3.0
    loc[-1, -1, 0] = 4.0
    attn = rng.uniform(size=(b, q, m, n, p)).astype(np.float32)
    attn /= attn.sum(axis=(3, 4), keepdims=True)
    return value, loc, attn


def _close(got, want, rel=REL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max())


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_forward_matches_jax(case):
    levels, *dims = CASES[case]
    value, loc, attn = _inputs(levels, *dims, seed=1)
    got = msdeform.ms_deform_attn_plain(*_t(value), levels, *_t(loc, attn))
    assert got.dtype == torch.float32 and got.shape == (dims[0], dims[1], dims[2] * dims[3])
    for fn in (jax_oracle, jax_fast):
        _close(got.numpy(), jax.jit(lambda v, l, a, fn=fn: fn(v, levels, l, a))(value, loc, attn))
    # the wrapper without a gradient: sft::ms_deform_attn, its plain version
    with torch.no_grad():
        via_op = msdeform.ms_deform_attn(*_t(value), levels, *_t(loc, attn))
    assert torch.equal(via_op, got)


def _jax_grads(fn, value, loc, attn, levels, g):
    def loss(v, l, a):
        return jnp.sum(fn(v, levels, l, a) * g)

    return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(value, loc, attn)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax_custom_vjp(case):
    """d(value), d(loc), d(attn): autograd through the plain version and
    the written-out ``ms_deform_attn_bwd_plain`` against the JAX custom VJP
    (``ms_deform_attn_fast``) and JAX autodiff of the oracle."""
    levels, b, q, m, d, p = CASES[case]
    value, loc, attn = _inputs(levels, b, q, m, d, p, seed=2)
    g = np.random.default_rng(3).normal(size=(b, q, m * d)).astype(np.float32)
    want_vjp = _jax_grads(jax_fast, value, loc, attn, levels, g)
    want_ad = _jax_grads(jax_oracle, value, loc, attn, levels, g)
    args = [t.requires_grad_() for t in _t(value, loc, attn)]
    out = msdeform.ms_deform_attn(args[0], levels, args[1], args[2])
    got_ad = torch.autograd.grad(out, args, torch.from_numpy(g))
    got_bwd = msdeform.ms_deform_attn_bwd_plain(*_t(value), levels, *_t(loc, attn),
                                                torch.from_numpy(g))
    for name, a, b_, wv, wa in zip(("value", "loc", "attn"), got_ad, got_bwd, want_vjp, want_ad):
        _close(a.numpy(), wv)
        _close(b_.numpy(), wv)
        _close(b_.numpy(), wa)
        assert a.dtype == b_.dtype == torch.float32, name
    # every point of the far-outside query samples nothing: zero gradients
    assert not got_bwd[1][-1, -1, 0].any() and not got_bwd[2][-1, -1, 0].any()


def test_bf16_value_keeps_float32_output_and_value_dtype_gradient():
    levels, b, q, m, d, p = CASES["d32_ragged"]
    value, loc, attn = _inputs(levels, b, q, m, d, p, seed=4)
    vb = torch.from_numpy(value).to(torch.bfloat16)
    out = msdeform.ms_deform_attn_plain(vb, levels, *_t(loc, attn))
    want = jax_oracle(jnp.asarray(value, jnp.bfloat16), levels, loc, attn)
    assert out.dtype == torch.float32 and want.dtype == jnp.float32
    # both blend in bfloat16; their roundings differ in places
    _close(out.numpy(), want, rel=2e-2)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(5))
    dv, dl, da = msdeform.ms_deform_attn_bwd_plain(vb, levels, *_t(loc, attn), g)
    assert dv.dtype == torch.bfloat16 and dl.dtype == da.dtype == torch.float32


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """The kernel's checks run before any launch: a head dim that the lane
    map ``LANES`` has no entry for (no multiple of 8, above 256, or 136) is
    not ported; a CPU tensor given to the kernel route raises rather than
    run anything."""
    levels = ((2, 2),)
    for d in (12, 136, 264):
        v = torch.zeros((1, 4, 1, d))
        loc, attn = torch.zeros((1, 1, 1, 1, 1, 2)), torch.ones((1, 1, 1, 1, 1))
        with pytest.raises((NotImplementedError, ValueError)):
            msdeform._check(v, loc, attn, levels)
    with pytest.raises(ValueError, match="CUDA"):
        msdeform.ms_deform_attn_bwd(torch.zeros((1, 4, 1, 8)), levels,
                                    torch.zeros((1, 1, 1, 1, 1, 2)), torch.ones((1, 1, 1, 1, 1)),
                                    torch.zeros((1, 1, 8)))
    with pytest.raises(ValueError, match="spatial shapes"):
        msdeform.ms_deform_attn_plain(torch.zeros((1, 5, 1, 8)), levels,
                                      torch.zeros((1, 1, 1, 1, 1, 2)), torch.ones((1, 1, 1, 1, 1)))


class _Sampler(torch.nn.Module):
    levels = ((4, 4), (2, 2))

    def forward(self, value, loc, attn):
        return msdeform.ms_deform_attn(value, self.levels, loc, attn) * 2.0


def test_op_fake_implementation_under_export():
    """``torch.export`` at a dynamic batch holds ``sft::ms_deform_attn``
    (traced through its fake implementation), and the program runs the
    plain version on the CPU."""
    value, loc, attn = _inputs(_Sampler.levels, 2, 5, 2, 8, 2, seed=6)
    args = tuple(_t(value, loc, attn))
    dims = {"value": {0: torch.export.Dim("b", min=1)}, "loc": {0: torch.export.Dim("b", min=1)},
            "attn": {0: torch.export.Dim("b", min=1)}}
    with torch.no_grad():
        program = torch.export.export(_Sampler(), args, dynamic_shapes=dims)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert "sft.ms_deform_attn.default" in targets
    with torch.no_grad():
        got = program.module()(*args)
        want = _Sampler()(*args)
    assert torch.equal(got, want)
    fake = [n for n in program.graph.nodes if str(n.target) == "sft.ms_deform_attn.default"]
    assert fake[0].meta["val"].dtype == torch.float32


@pytest.mark.parametrize("d", sorted(msdeform.LANES))
def test_lane_map_writes_every_channel_once(d):
    """The kernels' lane map at each head dim they take (the slice's 96,
    MiT-B0's 32, 256 among them), indexed as csrc/ms_deform_attn.cu does
    (item ``t / LP`` of a block, channels from ``(t % LP) * CPL``): a
    block's threads own whole items, every thread some channels (no lane
    idles), every channel of every item exactly once, each thread's
    channels whole 16-byte words of bf16 (8) and so of float32 (4), and an
    item's lanes within one warp (the shuffles' reach)."""
    lp, cpl = msdeform.LANES[d]
    assert lp * cpl == d and cpl % 8 == 0 and 32 % lp == 0
    for threads in (msdeform.THREADS, msdeform.BWD_THREADS):
        written = np.zeros((threads // lp, d), dtype=np.int64)
        for t in range(threads):
            assert t // 32 == (t - t % lp) // 32 == (t - t % lp + lp - 1) // 32
            written[t // lp, (t % lp) * cpl:(t % lp + 1) * cpl] += 1
        assert (written == 1).all()


def test_wrapper_passes_the_lane_map(monkeypatch):
    """Both kernels are launched with ``LANES[D]``, which the C dispatch
    refuses unless LP * CPL = D and it has that instantiation."""
    calls = []
    monkeypatch.setattr(msdeform._build, "launch", lambda *args: calls.append(args))
    monkeypatch.setattr(msdeform._build, "check_cuda", lambda *args, **kw: None)
    monkeypatch.setattr(msdeform._build, "stream_ptr", lambda t: 0)
    levels = ((4, 4), (2, 2))
    for d in (32, 96, 256):
        value, loc, attn = _t(*_inputs(levels, 1, 3, 2, d, 4, seed=d))
        msdeform._forward(value, loc, attn, levels)
        msdeform.ms_deform_attn_bwd(value, levels, loc, attn, torch.zeros((1, 3, 2 * d)))
        for args in calls[-2:]:
            fn, ints = args[1], args[-6:-2]
            assert ints[0] == d and tuple(ints[2:]) == msdeform.LANES[d], (fn, ints)
