"""The port's kernel modules (K1, K2, K5, K8) and layer helpers against the
JAX package, on the CPU.

On a CPU tensor each port wrapper runs its plain PyTorch version; the JAX
side runs both its XLA twin (``use_pallas=False``) and its Pallas kernel in
interpret mode. Inputs come from numpy and are float32 on both sides.
Tolerances: 1e-5 where both sides compute the same float32 expression in a
different summation order (a few ulps of values of order 1); label maps
must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from jax.experimental.pallas import tpu as pltpu

from segmentation_factory_tpu.models.layers import common as JC
from segmentation_factory_tpu.models.layers.norm import BatchNorm as JBatchNorm
from segmentation_factory_tpu.ops import pallas_attention as JA
from segmentation_factory_tpu.ops import pallas_ffn as JF
from segmentation_factory_tpu.ops import pallas_loss as JL
from segmentation_factory_tpu.ops import pallas_resize_sum as JR
from segmentation_factory_tpu_torch.models.layers import (
    LayerNorm,
    batch_norm_eval,
    ln_apply,
    resize,
)
from segmentation_factory_tpu_torch.ops import _build, block
from segmentation_factory_tpu_torch.ops.mixffn import mixffn_apply, tile_rows
from segmentation_factory_tpu_torch.ops.resize_argmax import resize_argmax_to
from segmentation_factory_tpu_torch.ops.resize_sum import resize_sum
from segmentation_factory_tpu_torch.ops.sra_attention import sra_attention

TOL = dict(rtol=1e-5, atol=1e-5)


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _jax(fn, use_pallas, *args, **kw):
    if use_pallas:
        with pltpu.force_tpu_interpret_mode():
            return np.asarray(fn(*args, use_pallas=True, **kw))
    return np.asarray(fn(*args, use_pallas=False, **kw))


# ---------------------------------------------------------------- K1


@pytest.mark.parametrize("n,m,use_pallas", [
    (256, 64, False),
    (256, 64, True),
    (300, 16, True),  # ragged: N is not a multiple of the 128-row q tile
])
def test_sra_attention_matches_jax(n, m, use_pallas):
    rng = np.random.default_rng(0)
    b, h, d = 2, 2, 32
    q, k, v = (_normal(rng, (b, s, h, d)) for s in (n, m, m))
    scale = d ** -0.5
    want = _jax(JA.sra_attention, use_pallas, jnp.asarray(q), jnp.asarray(k),
                jnp.asarray(v), scale, tile_q=128)
    before = sra_attention.launches
    got = sra_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale)
    assert sra_attention.launches == before  # CPU tensors launch no kernel
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ---------------------------------------------------------------- K2


def _ffn_args(rng, b, h, w, c, hc):
    return [_normal(rng, s, sc) for s, sc in [
        ((b, h, w, c), 1.0), ((c, hc), 0.1), ((hc,), 0.1), ((3, 3, 1, hc), 0.3),
        ((hc,), 0.1), ((hc, c), 0.1), ((c,), 0.1)]]


@pytest.mark.parametrize("shape,use_pallas", [
    ((2, 8, 8, 32, 128), False),
    ((2, 8, 8, 32, 128), True),
    ((1, 5, 7, 16, 64), False),  # odd map: the TPU kernel's gate refuses it
])
def test_mixffn_matches_jax(shape, use_pallas):
    args = _ffn_args(np.random.default_rng(1), *shape)
    want = _jax(JF.mixffn_apply, use_pallas, *map(jnp.asarray, args))
    got = mixffn_apply(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_mixffn_tile_fits_kernel_limits():
    # csrc/mixffn.cu: 256 threads x 16 pixels over C/4 channel groups, and a
    # halo of at most 192 pixels, for every MiT width
    for c in (32, 64, 128, 160, 256, 320, 512):
        th = tile_rows(c, 1024)
        assert th * 8 <= (256 // (c // 4)) * 16
        assert (th + 2) * 10 <= 192
    assert tile_rows(64, 5) == 6  # even: the tensor-core path takes row pairs


# K4f's bf16 tile (ops/block.py ffn_geometry) at every MiT B0-B5 width of
# stages 1-3 (and B0's stage 4, C = 256), on the stage 1-4 maps of configs
# #1, #4 and #5 (512², 224², 1024²) at their batches and the card check's 2,
# square and not: one of the tiles csrc/mixffn.cu k4::launch takes (64
# pixels, rows a multiple of 4, a halo of at most two m64 tiles)
_SIDES = {512: (16, 2), 224: (24, 2), 1024: (8, 2)}
_MIT_WIDTHS = (32, 64, 128, 160, 256, 320)


@pytest.mark.parametrize("c", _MIT_WIDTHS)
def test_ffn_block_geometry_fits_kernel(c):
    for img, batches in _SIDES.items():
        for stage in range(4):
            side = img // 4 >> stage
            for b in batches:
                for h, w in ((side, side), (side, side + 3)):
                    th, tw = block.ffn_geometry(c, h, w, b)
                    assert th * tw == 64 and th % 4 == 0, (th, tw)
                    assert (th + 2) * (tw + 2) <= 128, (th, tw)


# ---------------------------------------------------------------- K5


@pytest.mark.parametrize("sizes,e,use_pallas", [
    ((2, 4, 8, 16), 128, False),
    ((2, 4, 8, 16), 128, True),
    ((2, 4, 7, 13), 16, False),  # a 50-px input's non-dyadic pyramid
])
def test_resize_sum_matches_jax(sizes, e, use_pallas):
    rng = np.random.default_rng(2)
    levels = [_normal(rng, (2, s, s, e)) for s in sizes]  # top level first, as the head
    want = _jax(JR.resize_sum, use_pallas, [jnp.asarray(z) for z in levels])
    got = resize_sum([torch.from_numpy(z) for z in levels])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ---------------------------------------------------------------- K8


@pytest.mark.parametrize("lo_shape,out_hw,use_pallas", [
    ((1, 8, 128, 19), (32, 512), True),
    ((1, 8, 128, 19), (32, 512), False),
    ((2, 5, 7, 19), (13, 17), False),  # non-integer ratio
])
def test_resize_argmax_matches_jax(lo_shape, out_hw, use_pallas):
    lo = _normal(np.random.default_rng(3), lo_shape, 2.0)
    # inputs without near-ties: exact equality is then required
    up = np.sort(np.asarray(JC.resize(jnp.asarray(lo), out_hw)), axis=-1)
    assert (up[..., -1] - up[..., -2]).min() > 1e-5
    want = _jax(JL.resize_argmax_to, use_pallas, jnp.asarray(lo), out_hw)
    got = resize_argmax_to(torch.from_numpy(lo), out_hw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------- layers


def test_ln_apply_and_layernorm_match_flax():
    rng = np.random.default_rng(4)
    x = _normal(rng, (2, 5, 7, 48), 3.0) + 1.5
    scale, bias = 1 + _normal(rng, (48,), 0.1), _normal(rng, (48,), 0.1)
    want = np.asarray(JC.ln_apply(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
    got = ln_apply(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the final norm{i} of each stage is flax nn.LayerNorm (eps 1e-6)
    flax_ln = fnn.LayerNorm().apply({"params": {"scale": scale, "bias": bias}}, x)
    ln = LayerNorm(48)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
    np.testing.assert_allclose(ln(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(flax_ln), **TOL)


@pytest.mark.parametrize("src,dst", [
    ((4, 4), (16, 16)),  # x4 upsample
    ((5, 7), (13, 17)),  # non-integer upsample
    ((16, 9), (7, 9)),  # downsample rows, columns unchanged
    ((16, 16), (5, 6)),  # downsample
])
def test_resize_matches_jax(src, dst):
    x = _normal(np.random.default_rng(5), (2, *src, 3))
    want = np.asarray(JC.resize(jnp.asarray(x), dst))
    got = resize(torch.from_numpy(x), dst)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_resize_bf16_interpolates_in_bf16():
    # bf16 in, bf16 out; the weights are exact in bf16 at dyadic ratios, so
    # both sides agree to one bf16 rounding of values of order 1 (2^-7)
    x = _normal(np.random.default_rng(6), (1, 4, 4, 8))
    want = np.asarray(JC.resize(jnp.asarray(x, jnp.bfloat16), (16, 16)).astype(jnp.float32))
    got = resize(torch.from_numpy(x).to(torch.bfloat16), (16, 16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2 ** -6)


def test_batch_norm_eval_matches_flax():
    rng = np.random.default_rng(7)
    x = _normal(rng, (2, 4, 4, 16), 2.0)
    p = {"scale": 1 + _normal(rng, (16,), 0.1), "bias": _normal(rng, (16,), 0.1)}
    s = {"mean": _normal(rng, (16,), 0.5), "var": 0.5 + rng.random(16).astype(np.float32)}
    want = JBatchNorm().apply(
        {"params": {"BatchNorm_0": p}, "batch_stats": {"BatchNorm_0": s}},
        jnp.asarray(x), train=False)
    bn = torch.nn.BatchNorm2d(16, eps=1e-5).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(p["scale"]))
        bn.bias.copy_(torch.from_numpy(p["bias"]))
        bn.running_mean.copy_(torch.from_numpy(s["mean"]))
        bn.running_var.copy_(torch.from_numpy(s["var"]))
    with torch.no_grad():
        got = batch_norm_eval(torch.from_numpy(x), bn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------- no fallback


def test_non_cpu_tensors_never_take_the_plain_version():
    # a tensor that is not on the CPU goes to the kernel or raises; "meta"
    # stands in for a device the kernels do not take
    q = torch.empty((1, 64, 1, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        sra_attention(q, q, q, 1.0)
    y = torch.empty((1, 8, 8, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        mixffn_apply(y, *(torch.empty(s, device="meta") for s in
                          [(32, 128), (128,), (3, 3, 1, 128), (128,), (128, 32), (32,)]))
    with pytest.raises(ValueError, match="CUDA"):
        resize_sum([y, torch.empty((1, 4, 4, 32), device="meta")])
    with pytest.raises(ValueError, match="CUDA"):
        resize_argmax_to(y, (16, 16))


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(["resize_sum"])
