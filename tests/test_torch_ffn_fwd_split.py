"""The Mix-FFN forward as the port's kernels compute it (K2f split into
phases: fc1 on the GEMM's NN form, the depthwise taps + GELU stencil, fc2 on
the NN form), composed from the phases' plain versions on the CPU
(``mixffn.ffn_fwd``), against the JAX package.

- Shapes the TPU kernel takes: against the JAX package's Pallas ``_forward``
  in interpret mode (``mixffn_apply(..., use_pallas=True)``, as
  tests/test_torch_ops.py runs it).
- Ragged maps (5 x 9), a 1 x 1 and a 3 x 3 map, which the TPU kernel's gate
  refuses: against the arithmetic of its body ``_fwd_kernel`` (the JAX
  package's ``_matmul``, ``_dw3x3`` and ``_gelu_f32``) over the whole
  image, its halo rows zero as at an image's edge.

Both in float32 and with bfloat16 inputs, where h = fc1 + b1, the GELU
output and fc2 + b2 are rounded to bfloat16 on both sides and every sum is
float32. Inputs come from numpy with a seed. Tolerances: float32 within
1e-5 of the largest reference value (the same float32 expression summed in
another order; the TPU kernel's erf is a polynomial within 1.5e-7);
bfloat16 within 2^-6 of it (a sum that lands within rounding of a bf16 tie
may round the other way, a bf16 ulp being 2^-8 relative, and such a flip in
h or g moves the output by a few of them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from segmentation_factory_tpu.ops import pallas_ffn as JF
from segmentation_factory_tpu_torch.ops import mixffn

from _torch_port import two_torch_threads  # noqa: F401  (autouse)

F32_REL = 1e-5
BF16_REL = 2.0 ** -6
DTYPES = {"float32": (jnp.float32, torch.float32, F32_REL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_REL)}


def _args(seed, b, h, w, c, hc):
    """y, w1, b1, dw, db, w2, b2 (float32 numpy), the JAX layouts."""
    rng = np.random.default_rng(seed)
    n = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)  # noqa: E731
    return [n(b, h, w, c), n(c, hc, sc=c ** -0.5), n(hc, sc=0.1), n(3, 3, 1, hc, sc=0.3),
            n(hc, sc=0.1), n(hc, c, sc=hc ** -0.5), n(c, sc=0.1)]


def _port(args, tdt):
    """The port's phases through their plain versions, in ``tdt``."""
    before = (mixffn.ffn_fc.launches, mixffn.ffn_stencil.launches)
    out = mixffn.ffn_fwd(*[torch.from_numpy(a).to(tdt) for a in args])
    # CPU tensors launch no kernel
    assert (mixffn.ffn_fc.launches, mixffn.ffn_stencil.launches) == before
    assert out.dtype == tdt
    return out.float().numpy()


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _jnp(args, jdt):
    return [jnp.asarray(a).astype(jdt) for a in args]


# (b, h, w, c, hc): H a multiple of the kernel's row tile (>= 8), W of 8,
# HC of 128
PALLAS_SHAPES = [(2, 16, 8, 32, 128), (1, 8, 16, 64, 256)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", PALLAS_SHAPES)
def test_phases_match_pallas_forward(shape, dtype):
    jdt, tdt, rel = DTYPES[dtype]
    args = _args(sum(shape), *shape)
    with pltpu.force_tpu_interpret_mode():
        want = JF.mixffn_apply(*_jnp(args, jdt), use_pallas=True)
    want = np.asarray(want.astype(jnp.float32))
    _close(_port(args, tdt), want, rel)


def _fwd_kernel_arithmetic(y, w1, b1, dw, db, w2, b2):
    """``_fwd_kernel``'s arithmetic on one tile that is the whole image:
    h = round(y W1 + b1), its halo rows zero, the taps + db and the GELU in
    float32, rounded, then round(g W2 + b2)."""
    bsz, h, w, c = y.shape
    hc = w1.shape[1]
    dt = y.dtype

    def one(img):
        hid = (JF._matmul(img.reshape(h * w, c), w1) + b1.astype(jnp.float32)).astype(dt)
        ext = jnp.pad(hid.reshape(h, w, hc), ((1, 1), (0, 0), (0, 0)))
        hg = JF._gelu_f32(JF._dw3x3(ext, dw[:, :, 0]) + db.astype(jnp.float32)).astype(dt)
        out = JF._matmul(hg.reshape(h * w, hc), w2) + b2.astype(jnp.float32)
        return out.astype(dt).reshape(h, w, c)

    return jax.vmap(one)(y)


# ragged H and W, a 1 x 1 and a 3 x 3 map (the TPU kernel's gate refuses them)
RAGGED_SHAPES = [(1, 5, 9, 32, 128), (2, 1, 1, 16, 64), (1, 3, 3, 48, 96)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", RAGGED_SHAPES)
def test_phases_match_fwd_kernel_arithmetic(shape, dtype):
    jdt, tdt, rel = DTYPES[dtype]
    args = _args(7 + sum(shape), *shape)
    want = np.asarray(_fwd_kernel_arithmetic(*_jnp(args, jdt)).astype(jnp.float32))
    got = _port(args, tdt)
    _close(got, want, rel)
    if dtype == "float32":  # and the plain version of the whole FFN
        plain = mixffn.mixffn_plain(*map(torch.from_numpy, args)).numpy()
        _close(got, plain, F32_REL)


def test_phase_plain_versions():
    """The NN GEMM's plain version is a @ b (+ bias) with float32 sums in the
    output dtype; ``ffn_fc_plain`` rounds once to x's dtype; the stencil's
    plain version zero-pads (a 1 x 1 map sees only its centre tap)."""
    rng = np.random.default_rng(3)
    a, b = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((9, 24), (24, 40)))
    bias = torch.from_numpy(rng.normal(size=(40,)).astype(np.float32))
    torch.testing.assert_close(mixffn.gemm_nn_plain(a, b), a @ b, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(mixffn.gemm_nn_plain(a, b, bias), a @ b + bias, rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(mixffn.gemm_nn(a, b, bias), mixffn.gemm_nn_plain(a, b, bias))
    torch.testing.assert_close(mixffn.gemm_nn(a, b), mixffn.gemm_nt(a, b.t().contiguous()),
                               rtol=1e-6, atol=1e-6)
    ab, wb = a.bfloat16(), b.bfloat16()
    got = mixffn.ffn_fc_plain(ab, wb, bias.bfloat16())
    assert got.dtype == torch.bfloat16
    want = (ab.float() @ wb.float() + bias.bfloat16().float()).bfloat16()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    h = torch.from_numpy(rng.normal(size=(2, 1, 1, 8)).astype(np.float32))
    dw = torch.from_numpy(rng.normal(size=(3, 3, 1, 8)).astype(np.float32))
    db = torch.from_numpy(rng.normal(size=(8,)).astype(np.float32))
    want = torch.nn.functional.gelu(h * dw[1, 1, 0] + db)
    torch.testing.assert_close(mixffn.ffn_stencil(h, dw, db), want, rtol=1e-6, atol=1e-6)
