"""The port's CUDA kernels against their plain versions on the card, at
small and ragged shapes (the main path's shapes are ``chip_smoke.py``'s).
Backward kernels are held against autograd through the plain versions.

Marked ``cuda``: each test skips without a CUDA device. On a machine with
one and nvcc but no JAX (which tests/conftest.py imports):
``python -m pytest tests/test_torch_cuda.py -q --noconftest``.
Tolerance: float32, 1e-4 of the largest reference value (the kernels
reorder the plain versions' float32 sums); bfloat16, the kernel's error
from the float32 plain version on the same bf16 inputs within twice the
plain bf16 version's own error or 2^-7 of the largest value (the kernels
round less often than the plain bf16 chain); label maps equal outside
near-ties.
"""

import pytest
import torch

from segmentation_factory_tpu_torch.models.layers import resize
from segmentation_factory_tpu_torch.ops import (
    block,
    head_tail,
    lowres_loss,
    mixffn,
    msdeform,
    resize_argmax,
    resize_sum,
    sra_attention,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, rel=1e-4):
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * want.float().abs().max().item(), err


def _cast(args, dtype, keep=()):
    """args in ``dtype``, but for the indices in ``keep`` (float32 inputs)."""
    return [a if i in keep else a.to(dtype) for i, a in enumerate(args)]


def _check(kernel, plain, args, dtype, keep=()):
    if dtype == torch.float32:
        _close(kernel(*args), plain(*args))
        return
    args = _cast(args, dtype, keep)
    truth = plain(*[a.float() for a in args])
    err_k = (kernel(*args).float() - truth).abs().max().item()
    err_p = (plain(*args).float() - truth).abs().max().item()
    assert err_k <= max(2 * err_p, 2 ** -7 * truth.abs().max().item()), (err_k, err_p)


def _randn(g, *shape, scale=1.0):
    return torch.randn(shape, generator=g, device="cuda") * scale


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,m,h,d", [(300, 70, 2, 64), (64, 4, 1, 32), (1024, 1024, 8, 64),
                                     (49, 49, 1, 32), (49, 49, 2, 64), (576, 144, 5, 32),
                                     (576, 144, 2, 64), (200, 1000, 1, 32)])
def test_sra_attention_kernel(dev, n, m, h, d, dtype):
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = _randn(g, 2, n, h, d), _randn(g, 2, m, h, d), _randn(g, 2, m, h, d)
    before = sra_attention.sra_attention.launches
    sra_attention.sra_attention(q.to(dtype), k.to(dtype), v.to(dtype), d ** -0.5)
    assert sra_attention.sra_attention.launches == before + 1
    _check(lambda *a: sra_attention.sra_attention(*a, d ** -0.5),
           lambda *a: sra_attention.sra_attention_plain(*a, d ** -0.5), [q, k, v], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,w,c,hc", [(1, 13, 11, 128, 64), (2, 5, 9, 512, 64),
                                        (1, 3, 3, 32, 128), (2, 16, 16, 64, 256),
                                        (1, 9, 7, 160, 64), (1, 6, 10, 320, 96)])
def test_mixffn_kernel(dev, b, h, w, c, hc, dtype):
    g = torch.Generator(device=dev).manual_seed(1)
    args = [_randn(g, *s, scale=sc) for s, sc in [
        ((b, h, w, c), 1.0), ((c, hc), c ** -0.5), ((hc,), 0.1), ((3, 3, 1, hc), 0.3),
        ((hc,), 0.1), ((hc, c), hc ** -0.5), ((c,), 0.1)]]
    _check(mixffn.mixffn_apply, mixffn.mixffn_plain, args, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,w,c,hc", [(1, 13, 11, 128, 64), (2, 5, 9, 512, 64),
                                        (1, 3, 3, 32, 128), (1, 1, 1, 64, 256),
                                        (24, 7, 7, 512, 2048), (1, 6, 10, 320, 96)])
def test_mixffn_fwd_phases(dev, b, h, w, c, hc, dtype):
    """K2f's phases on the card, each against its plain version on the same
    inputs (fc1 and fc2 on the GEMM's NN form, the stencil), and launched
    as counted: two ``ffn_fc`` and one ``ffn_stencil`` a ``mixffn_apply``
    call, which counts once. bfloat16: each phase rounds its output once, so
    kernel and plain version differ by one bf16 ulp of the largest value at
    most (2^-7)."""
    g = torch.Generator(device=dev).manual_seed(17)
    y, w1, b1, dw, db, w2, b2 = (_randn(g, *s, scale=sc).to(dtype) for s, sc in [
        ((b, h, w, c), 1.0), ((c, hc), c ** -0.5), ((hc,), 0.1), ((3, 3, 1, hc), 0.3),
        ((hc,), 0.1), ((hc, c), hc ** -0.5), ((c,), 0.1)])
    rel = 1e-4 if dtype == torch.float32 else 2 ** -7
    p = b * h * w
    hid = mixffn.ffn_fc(y.view(p, c), w1, b1)
    _close(hid, mixffn.ffn_fc_plain(y.view(p, c), w1, b1), rel)
    hid = hid.view(b, h, w, hc)
    gg = mixffn.ffn_stencil(hid, dw, db)
    _close(gg, mixffn.ffn_stencil_plain(hid, dw, db), rel)
    out = mixffn.ffn_fc(gg.view(p, hc), w2, b2)
    _close(out, mixffn.ffn_fc_plain(gg.view(p, hc), w2, b2), rel)
    assert hid.dtype == gg.dtype == out.dtype == dtype
    phases = (mixffn.mixffn_apply, mixffn.ffn_fc, mixffn.ffn_stencil, mixffn.gemm_nn)
    before = [f.launches for f in phases]
    torch.testing.assert_close(mixffn.mixffn_apply(y, w1, b1, dw, db, w2, b2),
                               out.view(y.shape), rtol=0, atol=0)
    assert [f.launches - n for f, n in zip(phases, before)] == [1, 2, 1, 0]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sizes,e", [((2, 4, 8, 16), 64), ((2, 4, 7, 13), 16)])
def test_resize_sum_kernel(dev, sizes, e, dtype):
    g = torch.Generator(device=dev).manual_seed(2)
    levels = [_randn(g, 2, s, s, e) for s in sizes]
    _check(lambda *z: resize_sum.resize_sum(list(z)),
           lambda *z: resize_sum.resize_sum_plain(list(z)), levels, dtype)


# K5f (batch 2): dyadic pyramids at E = 64 / 256 and config #4's head (E =
# 768), one that does not divide, two full-size levels beside E % 8 == 4
# (8-byte rows), a single level, eight levels, and a level wider than the
# output (downsampled columns): (output rows and columns, smaller levels,
# full-size levels, E)
RESIZE_SUM_CASES = [((32, 32), [(16, 16), (8, 8), (4, 4)], 1, 64),
                    ((64, 64), [(32, 32), (16, 16), (8, 8)], 1, 256),
                    ((56, 56), [(28, 28), (14, 14), (7, 7)], 1, 768),
                    ((50, 53), [(25, 26), (13, 14), (7, 8)], 1, 64),
                    ((20, 23), [(13, 14), (7, 8), (1, 1)], 2, 20),
                    ((16, 16), [], 1, 64),
                    ((24, 20), [(12, 10), (6, 5), (3, 3), (2, 2), (1, 1), (24, 7), (5, 20)], 1, 20),
                    ((20, 23), [(13, 30)], 1, 256)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hw,levels,nfull,e", RESIZE_SUM_CASES)
def test_resize_sum_forward_kernel(dev, hw, levels, nfull, e, dtype):
    """K5f against the plain version: float32 bit for bit (each product and
    sum rounded as the plain version's passes round it), bfloat16 within
    the bar; one launch a call."""
    g = torch.Generator(device=dev).manual_seed(3)
    zs = [_randn(g, 2, *hw, e) for _ in range(nfull)] + [_randn(g, 2, h, w, e) for h, w in levels]
    zs = [z.to(dtype) for z in zs]
    before = resize_sum.resize_sum.launches
    got = resize_sum.resize_sum(zs)
    assert resize_sum.resize_sum.launches == before + 1 and got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, resize_sum.resize_sum_plain(zs), rtol=0, atol=0)
    else:
        _check(lambda *z: resize_sum.resize_sum(list(z)),
               lambda *z: resize_sum.resize_sum_plain(list(z)), zs, dtype)


@pytest.mark.parametrize("lo_shape,out_hw", [((2, 8, 8, 19), (32, 32)),
                                             ((2, 5, 7, 19), (13, 17))])
def test_resize_argmax_kernel(dev, lo_shape, out_hw):
    g = torch.Generator(device=dev).manual_seed(3)
    lo = _randn(g, *lo_shape, scale=2.0)
    got = resize_argmax.resize_argmax_to(lo, out_hw)
    want = resize_argmax.resize_argmax_plain(lo, out_hw)
    top = torch.topk(resize(lo, out_hw), 2, dim=-1).values
    tie = (top[..., 0] - top[..., 1]) < 1e-5
    assert got.dtype == torch.int32
    assert bool((got == want)[~tie].all())


# ---------------------------------------------------------------- backward kernels


def _grads(fn, args, g):
    """Gradients of sum(fn(*args) * g) with respect to every arg."""
    args = [a.detach().requires_grad_() for a in args]
    out = fn(*args)
    return torch.autograd.grad(out, args, g)


def _check_grads(kernel, plain, args, g, dtype, keep=()):
    """float32: every kernel gradient within 1e-4 of the largest plain one;
    bfloat16: within twice the plain bf16 gradient's error from float32
    truth on the same bf16-valued inputs, or 2^-7 of the largest value."""
    if dtype == torch.float32:
        for got, want in zip(_grads(kernel, args, g), _grads(plain, args, g)):
            _close(got, want)
        return
    args = _cast(args, dtype, keep)
    g = g.to(dtype)
    truth = _grads(plain, [a.float() for a in args], g.float())
    got = _grads(kernel, args, g)
    base = _grads(plain, args, g)
    torch.cuda.synchronize()
    for k, p, t in zip(got, base, truth):
        err_k = (k.float() - t).abs().max().item()
        err_p = (p.float() - t).abs().max().item()
        assert err_k <= max(2 * err_p, 2 ** -7 * t.abs().max().item()), (err_k, err_p)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,m,h,d", [(300, 70, 2, 64), (64, 4, 1, 32), (4096, 1024, 1, 64),
                                     (1024, 1024, 8, 64), (4100, 64, 1, 64), (3000, 16, 2, 32),
                                     (1024, 1024, 8, 32)])
def test_sra_attention_bwd_kernel(dev, n, m, h, d, dtype):
    """N far above M (4100 / 64, 3000 / 16: the query rows split over many
    dk/dv chunks, their partial sums meeting by atomics) and N = M."""
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v, g = (_randn(gen, 2, s, h, d) for s in (n, m, m, n))
    before = sra_attention.sra_attention_bwd.launches
    _check_grads(lambda *a: sra_attention.sra_attention(*a, d ** -0.5),
                 lambda *a: sra_attention.sra_attention_plain(*a, d ** -0.5), [q, k, v], g, dtype)
    assert sra_attention.sra_attention_bwd.launches == before + 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,w,c,hc", [(1, 13, 11, 128, 64), (2, 5, 9, 512, 64),
                                        (1, 3, 3, 32, 128), (2, 16, 16, 64, 256),
                                        (1, 9, 7, 160, 64), (1, 6, 10, 320, 96)])
def test_mixffn_bwd_kernel(dev, b, h, w, c, hc, dtype):
    gen = torch.Generator(device=dev).manual_seed(6)
    args = [_randn(gen, *s, scale=sc) for s, sc in [
        ((b, h, w, c), 1.0), ((c, hc), c ** -0.5), ((hc,), 0.1), ((3, 3, 1, hc), 0.3),
        ((hc,), 0.1), ((hc, c), hc ** -0.5), ((c,), 0.1)]]
    g = _randn(gen, b, h, w, c)
    before = mixffn.mixffn_bwd.launches
    _check_grads(mixffn.mixffn_apply, mixffn.mixffn_plain, args, g, dtype)
    assert mixffn.mixffn_bwd.launches == before + 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sizes,e", [((2, 4, 8, 16), 64), ((2, 4, 7, 13), 16),
                                     ((16, 16, 8, 4), 8)])
def test_resize_sum_bwd_kernel(dev, sizes, e, dtype):
    gen = torch.Generator(device=dev).manual_seed(7)
    levels = [_randn(gen, 2, s, s, e) for s in sizes]
    top = max(sizes)
    g = _randn(gen, 2, top, top, e)
    before = resize_sum.resize_sum_bwd.launches
    _check_grads(lambda *z: resize_sum.resize_sum(list(z)),
                 lambda *z: resize_sum.resize_sum_plain(list(z)), levels, g, dtype)
    assert resize_sum.resize_sum_bwd.launches == before + 1


# K5b at other configurations' pyramids (batch 2): config #1's head (MiT-B0
# at 512^2, E = 256), config #4's (224^2, E = 768), and one that does not
# divide (50 x 53 over 25 x 26, 13 x 14, 7 x 8)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hw,levels,e", [((128, 128), [(64, 64), (32, 32), (16, 16)], 256),
                                         ((56, 56), [(28, 28), (14, 14), (7, 7)], 768),
                                         ((50, 53), [(25, 26), (13, 14), (7, 8)], 64)])
def test_resize_sum_bwd_configs(dev, hw, levels, e, dtype):
    gen = torch.Generator(device=dev).manual_seed(11)
    zs = [_randn(gen, 2, *hw, e)] + [_randn(gen, 2, h, w, e) for h, w in levels]
    g = _randn(gen, 2, *hw, e)
    before = resize_sum.resize_sum_bwd.launches
    _check_grads(lambda *z: resize_sum.resize_sum(list(z)),
                 lambda *z: resize_sum.resize_sum_plain(list(z)), zs, g, dtype)
    assert resize_sum.resize_sum_bwd.launches == before + 1


def _loss_inputs(gen, b, hl, wl, c, hh, wh):
    lo = _randn(gen, b, hl, wl, c, scale=2.0)
    lab = torch.randint(0, c, (b, hh, wh), generator=gen, device="cuda", dtype=torch.int32)
    lab[:, : hh // 8] = 255
    lab[0, -1, :3] = c + 2  # out of range, not ignored: a zero one-hot row
    return lo, lab


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 8, 8, 19, 32, 32), (2, 5, 7, 19, 13, 17),
                                   (1, 4, 4, 40, 16, 16)])
def test_lowres_loss_kernels(dev, shape, dtype):
    gen = torch.Generator(device=dev).manual_seed(8)
    lo, lab = _loss_inputs(gen, *shape)
    lo = lo.to(dtype)
    loss_k, parts_k = lowres_loss.lowres_loss_fwd(lo, lab)
    loss_p, parts_p = lowres_loss.lowres_loss_plain(lo, lab)
    _close(loss_k, loss_p)
    _close(parts_k, parts_p)
    b, c = shape[0], shape[3]
    wmap = torch.rand(lab.shape, generator=gen, device="cuda") / lab.numel()
    dcoef = _randn(gen, b, 2, c, scale=0.01)
    _close(lowres_loss.lowres_loss_bwd(lo, lab, wmap, dcoef),
           lowres_loss.lowres_loss_bwd_plain(lo, lab, wmap, dcoef))


# K7b alone at other configurations' shapes (batch cut to 2, or 1): config
# #1 (lo 128^2 -> 512^2, 21 classes), config #4 (56^2 -> 224^2, 9 classes),
# a ratio that does not divide (63 x 47 -> 250 x 190), ADE20K's 150 classes,
# and tiles cut by the image's edge (40 x 37 -> 160 x 148); each with an
# all-void block at the image's corner
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 128, 128, 21, 512, 512), (2, 56, 56, 9, 224, 224),
                                   (2, 63, 47, 19, 250, 190), (1, 32, 32, 150, 128, 128),
                                   (2, 40, 37, 19, 160, 148)])
def test_lowres_loss_bwd_configs(dev, shape, dtype):
    gen = torch.Generator(device=dev).manual_seed(12)
    lo, lab = _loss_inputs(gen, *shape)
    lab[-1, -40:, -50:] = 255
    b, c = shape[0], shape[3]
    wmap = torch.rand(lab.shape, generator=gen, device="cuda") / lab.numel() * (lab != 255)
    dcoef = _randn(gen, b, 2, c, scale=0.01)
    before = lowres_loss.lowres_loss_bwd.launches
    _check(lambda x: lowres_loss.lowres_loss_bwd(x, lab, wmap, dcoef),
           lambda x: lowres_loss.lowres_loss_bwd_plain(x, lab, wmap, dcoef), [lo], dtype)
    assert lowres_loss.lowres_loss_bwd.launches == before + 1


# K7f and K8 at the same shapes as K7b: the void top rows, an all-void
# corner and a label outside [0, C); K8's labels equal the plain version's
# everywhere (the front end samples the plain version's logits bit for bit)
LOWRES_SHAPES = [(2, 128, 128, 21, 512, 512), (2, 56, 56, 9, 224, 224), (2, 63, 47, 19, 250, 190),
                 (1, 32, 32, 150, 128, 128), (2, 40, 37, 19, 160, 148)]


def _lowres_inputs(dev, shape, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    lo, lab = _loss_inputs(gen, *shape)
    lab[-1, -40:, -50:] = 255
    return lo, lab


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", LOWRES_SHAPES)
def test_lowres_loss_fwd_configs(dev, shape, dtype):
    lo, lab = _lowres_inputs(dev, shape, 13)
    before = (lowres_loss.lowres_loss_fwd.launches, lowres_loss.fwd_blocks.launches,
              lowres_loss.fwd_finish.launches)
    for j in range(2):  # the loss map, the dice partials
        _check(lambda x, j=j: lowres_loss.lowres_loss_fwd(x, lab)[j],
               lambda x, j=j: lowres_loss.lowres_loss_plain(x, lab)[j], [lo], dtype)
    # each call: one of the wrapper, one of each of its two launches (the
    # bf16 check calls the kernel once, the float32 one once)
    assert (lowres_loss.lowres_loss_fwd.launches, lowres_loss.fwd_blocks.launches,
            lowres_loss.fwd_finish.launches) == tuple(n + 2 for n in before)


@pytest.mark.parametrize("shape", LOWRES_SHAPES + [(2, 256, 256, 19, 1024, 1024)])
def test_lowres_loss_fwd_is_deterministic(dev, shape):
    lo, lab = _lowres_inputs(dev, shape, 14)
    loss_a, parts_a = lowres_loss.lowres_loss_fwd(lo, lab)
    loss_b, parts_b = lowres_loss.lowres_loss_fwd(lo, lab)
    torch.cuda.synchronize()
    assert torch.equal(parts_a, parts_b) and torch.equal(loss_a, loss_b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", LOWRES_SHAPES + [(2, 256, 256, 19, 1024, 1024),
                                                   (2, 5, 7, 19, 13, 17), (1, 30, 10, 19, 7, 20)])
def test_resize_argmax_equals_plain(dev, shape, dtype):
    lo, _ = _lowres_inputs(dev, shape, 15)
    lo = lo.to(dtype)
    before = resize_argmax.resize_argmax_to.launches
    got = resize_argmax.resize_argmax_to(lo, shape[4:])
    want = resize_argmax.resize_argmax_plain(lo, shape[4:])
    torch.cuda.synchronize()
    assert resize_argmax.resize_argmax_to.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.parametrize("loss_type", ["ce", "ohem"])
@pytest.mark.parametrize("use_dice", [True, False])
def test_lowres_criterion_through_kernels(dev, loss_type, use_dice):
    gen = torch.Generator(device=dev).manual_seed(9)
    lo, lab = _loss_inputs(gen, 2, 16, 16, 19, 64, 64)
    before = (lowres_loss.lowres_loss_fwd.launches, lowres_loss.lowres_loss_bwd.launches)
    x = lo.detach().requires_grad_()
    got = lowres_loss.lowres_criterion(x, lab, loss_type=loss_type, use_dice=use_dice)
    (dgot,) = torch.autograd.grad(got, x)
    assert (lowres_loss.lowres_loss_fwd.launches, lowres_loss.lowres_loss_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    y = lo.detach().requires_grad_()
    want = lowres_loss.fused_criterion_plain(y, lab, loss_type, use_dice)
    (dwant,) = torch.autograd.grad(want, y)
    _close(got, want)
    _close(dgot, dwant)


# ---------------------------------------------------------------- fused half-blocks

_LN = (3, 4)  # the indices of lg, lb: float32 in both dtypes


def _attn_args(gen, b, hh, w, c, m):
    return [_randn(gen, b, hh, w, c), _randn(gen, b, m, c, scale=0.5),
            _randn(gen, b, m, c, scale=0.5), 1 + _randn(gen, c, scale=0.2),
            _randn(gen, c, scale=0.1), _randn(gen, c, c, scale=c ** -0.5),
            _randn(gen, c, scale=0.1), _randn(gen, c, c, scale=c ** -0.5),
            _randn(gen, c, scale=0.1)]


def _ffn_args(gen, b, h, w, c):
    hc = 4 * c
    return [_randn(gen, b, h, w, c), 1 + _randn(gen, c, scale=0.2), _randn(gen, c, scale=0.1),
            _randn(gen, c, hc, scale=c ** -0.5), _randn(gen, hc, scale=0.1),
            _randn(gen, 3, 3, 1, hc, scale=0.3), _randn(gen, hc, scale=0.1),
            _randn(gen, hc, c, scale=hc ** -0.5), _randn(gen, c, scale=0.1)]


def _fac(b):  # a dropped image (0) beside a kept one (1 / keep)
    return torch.tensor([0.0, 1.25][:b] if b > 1 else [1.25], device="cuda")


# MiT-B2's head dim 64 and, last, MiT-B0's 32 (C = 32 / 1 head, 64 / 2, 256 / 8
# with M = N)
ATTN_SHAPES = [(2, 16, 16, 64, 16, 1), (1, 9, 7, 128, 12, 2), (2, 8, 8, 320, 64, 5),
               (1, 12, 12, 160, 36, 5), (1, 20, 20, 64, 100, 1), (2, 16, 16, 32, 16, 1),
               (1, 9, 7, 64, 12, 2), (1, 8, 8, 256, 64, 8)]
# ... and MiT-B0's C = 256 and 160 on maps that leave K4f's 8 x 8 tiles partial
FFN_SHAPES = [(2, 16, 16, 64), (1, 9, 7, 160), (1, 6, 10, 320), (2, 5, 9, 128), (1, 3, 3, 32),
              (2, 7, 9, 256), (1, 14, 14, 160)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,hh,w,c,m,heads", ATTN_SHAPES)
def test_attn_block_kernels(dev, b, hh, w, c, m, heads, dtype):
    gen = torch.Generator(device=dev).manual_seed(10)
    args, fac = _attn_args(gen, b, hh, w, c, m), _fac(b)
    scale = (c // heads) ** -0.5
    kern = lambda *a: block.attn_block_apply(*a, fac, heads, scale)
    plain = lambda *a: block.attn_block_plain(*a, fac, heads, scale)
    before = block.attn_block_apply.launches
    _check(kern, plain, args, dtype, _LN)
    g = _randn(gen, b, hh, w, c)
    bwd = block.attn_block_bwd.launches
    _check_grads(kern, plain, args, g, dtype, _LN)
    assert block.attn_block_bwd.launches == bwd + 1
    assert block.attn_block_apply.launches > before


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,w,c", FFN_SHAPES)
def test_ffn_block_kernels(dev, b, h, w, c, dtype):
    gen = torch.Generator(device=dev).manual_seed(11)
    args, fac = _ffn_args(gen, b, h, w, c), _fac(b)
    kern = lambda *a: block.ffn_block_apply(*a, fac)
    plain = lambda *a: block.ffn_block_plain(*a, fac)
    keep = (1, 2)
    _check(kern, plain, args, dtype, keep)
    g = _randn(gen, b, h, w, c)
    bwd = block.ffn_block_bwd.launches
    _check_grads(kern, plain, args, g, dtype, keep)
    assert block.ffn_block_bwd.launches == bwd + 1


# ---------------------------------------------------------------- K2b / K4b phases


def _check_bwd(bwd, plain, args, g, dtype, keep=()):
    """``bwd(*args, g)``'s gradients (one per arg) held as _check_grads
    holds an autograd Function's."""
    if dtype == torch.float32:
        for got, want in zip(bwd(*args, g), _grads(plain, args, g)):
            _close(got, want.reshape(got.shape))
        return
    args = _cast(args, dtype, keep)
    g = g.to(dtype)
    truth = _grads(plain, [a.float() for a in args], g.float())
    got = bwd(*args, g)
    base = _grads(plain, args, g)
    torch.cuda.synchronize()
    for k, p, t in zip(got, base, truth):
        err_k = (k.float() - t.reshape(k.shape)).abs().max().item()
        err_p = (p.float() - t).abs().max().item()
        assert err_k <= max(2 * err_p, 2 ** -7 * t.abs().max().item()), (err_k, err_p)


# every MiT width (and 160, 256: not multiples of the GEMM's 64 or 128-row
# tiles), ragged H and W against the 16 x 16 tile
FFN_BWD_CASES = [(2, 17, 9, 32), (2, 17, 9, 64), (1, 9, 23, 128), (1, 9, 7, 160),
                 (1, 6, 10, 256), (1, 6, 10, 320), (2, 5, 9, 512)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,w,c", FFN_BWD_CASES)
def test_ffn_bwd_phases(dev, b, h, w, c, dtype):
    gen = torch.Generator(device=dev).manual_seed(13)
    args, fac = _ffn_args(gen, b, h, w, c), _fac(b)
    g = _randn(gen, b, h, w, c)
    k4b, k2b = block.ffn_block_bwd.launches, mixffn.mixffn_bwd.launches
    phases = (mixffn.ffn_bwd_prep, mixffn.gemm_nt, mixffn.gemm_nn, mixffn.ffn_bwd_tile,
              mixffn.gemm_tn, mixffn.ln_bwd)
    before = [f.launches for f in phases]
    _check_bwd(lambda *a: block.ffn_block_bwd(*a[:8], fac, a[-1]),
               lambda *a: block.ffn_block_plain(*a, fac), args, g, dtype, (1, 2))
    y_args = [args[0], *args[3:]]
    _check_bwd(lambda *a: mixffn.mixffn_bwd(*a[:6], a[-1]), mixffn.mixffn_plain, y_args, g,
               dtype)
    assert block.ffn_block_bwd.launches == k4b + 1
    assert mixffn.mixffn_bwd.launches == k2b + 1
    # each call: prep, 2 NT GEMMs and 1 NN (fc1), tile, 2 TN GEMMs, and
    # K4b's LN backward
    assert [f.launches - b for f, b in zip(phases, before)] == [2, 4, 2, 2, 4, 1]


# ---------------------------------------------------------------- K1b's core and K3b's phases


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,m,h,d", [(300, 70, 2, 64), (4100, 64, 1, 32), (128, 128, 5, 32)])
def test_sra_attention_bwd_core(dev, n, m, h, d, dtype):
    """K1b's core on the card against its plain version on the same inputs
    (the forward's output and lse from K1f): dq, dk, dv, delta and dbq."""
    gen = torch.Generator(device=dev).manual_seed(15)
    q, k, v, g = (_randn(gen, 2, s, h, d).to(dtype) for s in (n, m, m, n))
    lse = torch.empty((2, h, n), device=dev)
    o = sra_attention._forward(q, k, v, d ** -0.5, lse)
    before = sra_attention.sra_attention_bwd_core.launches
    got = sra_attention.sra_attention_bwd_core(q, k, v, o, g, lse, d ** -0.5, dbq=True)
    assert sra_attention.sra_attention_bwd_core.launches == before + 1
    want = sra_attention.sra_attention_bwd_plain(q, k, v, o, g, lse, d ** -0.5, dbq=True)
    # bfloat16: p and ds round to bf16 as the products' operands (the plain
    # version keeps them float32), dq rounds once
    rel = 1e-4 if dtype == torch.float32 else 2 ** -6
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _close(a, b, rel)


# (b, hh, w, c, m, heads): head dims 64 and 32, ragged N, N = M
ATTN_BWD_CASES = [(2, 17, 9, 64, 20, 1), (1, 9, 7, 128, 12, 2), (1, 12, 12, 160, 36, 5),
                  (2, 8, 8, 256, 64, 8), (1, 6, 10, 320, 60, 5)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,hh,w,c,m,heads", ATTN_BWD_CASES)
def test_attn_bwd_phases(dev, b, hh, w, c, m, heads, dtype):
    """K3b as phases (prep, the q NT GEMM, the doh / dln NN GEMMs, K1b's
    core, the dWq / dWo TN GEMMs, the LN backward) from K3f's saved o and
    lse, against
    autograd through the plain half-block; each phase launched once per
    call as counted."""
    gen = torch.Generator(device=dev).manual_seed(16)
    args, fac = _attn_args(gen, b, hh, w, c, m), _fac(b)
    g = _randn(gen, b, hh, w, c)
    scale = (c // heads) ** -0.5

    def k3b(x, k, v, lg, lb, wq, bq, wo, bo, gg):
        o = torch.empty_like(x)
        lse = torch.empty((b, heads, hh * w), device=dev)
        block._attn_forward(x, k, v, lg, lb, wq, bq, wo, bo, fac, heads, scale, o, lse)
        return block.attn_block_bwd(x, k, v, lg, lb, wq, bq, wo, fac, gg, o, lse, heads, scale)

    phases = (mixffn.ffn_bwd_prep, mixffn.gemm_nt, mixffn.gemm_nn,
              sra_attention.sra_attention_bwd_core, mixffn.gemm_tn, mixffn.ln_bwd)
    before = [f.launches for f in phases]
    calls = block.attn_block_bwd.launches
    _check_bwd(k3b, lambda *a: block.attn_block_plain(*a, fac, heads, scale), args, g, dtype,
               _LN)
    assert block.attn_block_bwd.launches == calls + 1
    assert [f.launches - n for f, n in zip(phases, before)] == [1, 1, 2, 1, 2, 1]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n,k", [(1280, 320, 8192), (256, 64, 1000), (96, 160, 77)])
def test_gemm_kernels(dev, m, n, k, dtype):
    """The three forms of the GEMM against their plain versions: TN (the
    weight gradients, the contraction split over the grid) plain and
    transposed, NT (dln) and NN (K2f's fc1 and fc2, fc1 recomputed) with and
    without a bias, in float32 and in the operands' type."""
    gen = torch.Generator(device=dev).manual_seed(14)
    a, b = _randn(gen, k, m).to(dtype), _randn(gen, k, n).to(dtype)
    for trans in (False, True):
        shape = (n, m) if trans else (m, n)
        got = mixffn.gemm_tn(a, b, torch.zeros(shape, device=dev), trans)
        _close(got, mixffn.gemm_tn_plain(a, b, torch.zeros(shape, device=dev), trans))
    kk = k - k % 32 or 32
    a2, b2 = _randn(gen, m, kk).to(dtype), _randn(gen, n, kk).to(dtype)
    bias = _randn(gen, n).to(dtype)
    b3 = b2.t().contiguous()  # (K, N): the NN form's B
    for out_dtype in {torch.float32, dtype}:
        for bb in (None, bias):
            for fn, plain, b_ in ((mixffn.gemm_nt, mixffn.gemm_nt_plain, b2),
                                  (mixffn.gemm_nn, mixffn.gemm_nn_plain, b3)):
                got = fn(a2, b_, bb, out_dtype)
                want = plain(a2, b_, bb, out_dtype)
                assert got.dtype == out_dtype
                # a bf16 output may round the other way at a float32 tie: one ulp
                _close(got, want, 1e-4 if out_dtype == torch.float32 else 2 ** -7)


# ---------------------------------------------------------------- fused head tail

# (b, h, w, e, nc): the main path's shape; config #1's head; pixels and
# channels that are not multiples of K6b's 64-pixel tile and 128-channel
# chunk (E = 68: 8-byte rows of bfloat16, tiles across images); classes
# past one slice of 24 (40, 150)
TAIL_SHAPES = [(2, 256, 256, 768, 19), (16, 128, 128, 256, 21), (1, 7, 9, 68, 5),
               (3, 9, 11, 136, 19), (2, 5, 13, 128, 40), (1, 16, 10, 96, 150)]


def tail_inputs(gen, b, h, w, e):
    """s, gamma, beta of a K6 check whose ReLU mask is well defined: s takes
    the integers -4..4 (exact in bfloat16), and beta puts each channel's
    kink midway between two of its normalized levels, so every BatchNorm
    output lies at least 0.5 * gamma * rsig from it. The kernel and the plain
    version sum the batch statistics in different orders; on random inputs
    a value within rounding of the kink takes the ReLU's two sides in the
    two versions, and its gradient differs by its whole size."""
    s = torch.randint(-4, 5, (b, h, w, e), generator=gen, device="cuda").float()
    gamma = 1 + _randn(gen, e, scale=0.2)
    sd = s.double()
    mean = sd.mean((0, 1, 2))
    rsig = torch.rsqrt((sd * sd).mean((0, 1, 2)) - mean * mean + 1e-5)
    k0 = torch.randint(-3, 3, (e,), generator=gen, device="cuda")
    beta = (-gamma.double() * (k0 + 0.5 - mean) * rsig).float()
    return s, gamma, beta


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,w,e,nc", TAIL_SHAPES)
def test_head_tail_kernels(dev, b, h, w, e, nc, dtype):
    """K6f's logits and statistics and K6b's five gradients (s, gamma, beta,
    the classifier's weight and bias) against the plain version and its
    autograd, with a dropout mask; s in ``dtype``, every other input
    float32, the logits' cotangent float32."""
    gen = torch.Generator(device=dev).manual_seed(13)
    s, gamma, beta = tail_inputs(gen, b, h, w, e)
    args = [s.to(dtype), gamma, beta, _randn(gen, nc, e, 1, 1, scale=e ** -0.5),
            _randn(gen, nc, scale=0.1)]
    dmask = (torch.rand((b, e), generator=gen, device="cuda") < 0.9).float() / 0.9
    g = _randn(gen, b, h, w, nc)
    eps = 1e-5

    def run(fn, xs):
        xs = [x.detach().requires_grad_() for x in xs]
        logits, mean, var = fn(xs[0], xs[1], xs[2], dmask, xs[3], xs[4], eps)
        return [logits, mean, var, *torch.autograd.grad(logits, xs, g)]

    before = (head_tail.head_tail_train.launches, head_tail.head_tail_bwd.launches)
    got = run(head_tail.head_tail_train, args)
    assert (head_tail.head_tail_train.launches, head_tail.head_tail_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert got[0].dtype == torch.float32 and got[3].dtype == dtype
    assert got[6].shape == (nc, e, 1, 1)
    if dtype == torch.float32:
        for a, p in zip(got, run(head_tail.head_tail_plain, args)):
            _close(a, p)
        return
    truth = run(head_tail.head_tail_plain, [args[0].float(), *args[1:]])
    base = run(head_tail.head_tail_plain, args)
    torch.cuda.synchronize()
    for k, p, t in zip(got, base, truth):
        err_k = (k.float() - t).abs().max().item()
        err_p = (p.float() - t).abs().max().item()
        assert err_k <= max(2 * err_p, 2 ** -7 * t.abs().max().item()), (err_k, err_p)


# K6f's classes and channels: one class, config #4's 9, 19, 21, 24 (a
# full slice of K = 6), 25, ADE20K's 150 and 256 (slices of 32); E = 16,
# 20 (8-byte bf16 rows), 256 and 768; (b, h, w): tiles across images (99
# pixels an image) and tiles inside one (1024)
TAIL_FWD_CASES = [(1, 16), (9, 768), (19, 768), (21, 256), (24, 20), (25, 256), (150, 768),
                  (256, 16), (19, 20), (256, 768)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bhw", [(2, 9, 11), (2, 32, 32)])
@pytest.mark.parametrize("nc,e", TAIL_FWD_CASES)
def test_head_tail_forward_kernel(dev, nc, e, bhw, dtype):
    """K6f's logits, mean and var against the plain version, with a dropout
    mask; one launch a call."""
    gen = torch.Generator(device=dev).manual_seed(17)
    s, gamma, beta = tail_inputs(gen, *bhw, e)
    w = _randn(gen, nc, e, 1, 1, scale=e ** -0.5)
    bias = _randn(gen, nc, scale=0.1)
    dmask = (torch.rand((bhw[0], e), generator=gen, device="cuda") < 0.9).float() / 0.9
    before = head_tail.head_tail_train.launches
    with torch.no_grad():
        run = lambda fn, x: fn(x, gamma, beta, dmask, w, bias, 1e-5)  # noqa: E731
        got = run(head_tail.head_tail_train, s.to(dtype))
        assert head_tail.head_tail_train.launches == before + 1
        assert got[0].shape == (*bhw, nc) and all(t.dtype == torch.float32 for t in got)
        if dtype == torch.float32:
            for a, p in zip(got, run(head_tail.head_tail_plain, s)):
                _close(a, p)
            return
        x16 = s.to(dtype)
        truth = run(head_tail.head_tail_plain, x16.float())
        base = run(head_tail.head_tail_plain, x16)
    torch.cuda.synchronize()
    for k, p, t in zip(got, base, truth):
        err_k = (k.float() - t).abs().max().item()
        err_p = (p.float() - t).abs().max().item()
        assert err_k <= max(2 * err_p, 2 ** -7 * t.abs().max().item()), (err_k, err_p)


def test_head_tail_keeps_nan(dev):
    # a non-finite fuse tensor gives non-finite logits (the train step's
    # skip reads the loss), as torch.relu and jnp.maximum keep NaN
    s = torch.ones((1, 4, 4, 64), device="cuda")
    s[0, 1, 1, 3] = float("nan")
    w = torch.randn((5, 64, 1, 1), device="cuda")
    ones = torch.ones(64, device="cuda")
    logits, _, _ = head_tail.head_tail_train(s, ones, ones, torch.ones((1, 64), device="cuda"), w,
                                             torch.zeros(5, device="cuda"), 1e-5)
    assert not torch.isfinite(logits).any()


def test_no_detached_kernel_outputs(dev):
    # a kernel output that needs a gradient carries one, or the call raises
    q = torch.randn(1, 64, 1, 32, device="cuda", requires_grad=True)
    assert sra_attention.sra_attention(q, q, q, 1.0).grad_fn is not None
    gen = torch.Generator(device=dev).manual_seed(12)
    a = [t.requires_grad_() for t in _attn_args(gen, 1, 8, 8, 64, 4)]
    assert block.attn_block_apply(*a, _fac(1), 1, 0.125).grad_fn is not None
    f = [t.requires_grad_() for t in _ffn_args(gen, 1, 4, 4, 32)]
    assert block.ffn_block_apply(*f, _fac(1)).grad_fn is not None
    lo = torch.randn(1, 4, 4, 5, device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        resize_argmax.resize_argmax_to(lo, (16, 16))


# (batch, levels, queries, heads, head dim, points): ragged levels, head dims
# 8 to 256 (each lane count of msdeform.LANES: 1, 2, 4 and 8), points in
# whole and partial groups of four, one level, a 1 x 1 map
MSDA_CASES = [(2, ((7, 5), (4, 3), (1, 1)), 37, 2, 32, 3),
              (1, ((8, 8), (4, 4), (2, 2)), 50, 8, 96, 4),
              (1, ((6, 9),), 11, 1, 8, 2),
              (2, ((5, 5), (3, 3)), 19, 2, 256, 4),
              (1, ((9, 4), (2, 7)), 23, 3, 192, 1),
              (2, ((5, 6), (3, 3)), 17, 2, 16, 5),
              (1, ((6, 4),), 9, 3, 128, 8),
              (1, ((4, 4), (2, 2)), 13, 2, 64, 4)]


def _msda_args(gen, b, levels, q, m, d, p):
    s, n = sum(h * w for h, w in levels), len(levels)
    loc = torch.rand((b, q, m, n, p, 2), generator=gen, device="cuda") * 1.6 - 0.3
    loc[0, 0, 0, :, 0] = 0.0
    loc[0, 0, -1, :, -1] = 1.0
    loc[-1, -1] = -3.0
    attn = torch.softmax(_randn(gen, b, q, m, n * p), -1).reshape(b, q, m, n, p)
    return [_randn(gen, b, s, m, d), loc, attn]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,levels,q,m,d,p", MSDA_CASES)
def test_ms_deform_attn_kernels(dev, b, levels, q, m, d, p, dtype):
    """K9f against the plain version and K9b (through K9's autograd
    Function) against autograd through it; value in ``dtype``, locations and
    weights float32."""
    gen = torch.Generator(device=dev).manual_seed(30)
    args = _msda_args(gen, b, levels, q, m, d, p)
    kern = lambda v, l, a: msdeform.ms_deform_attn(v, levels, l, a)  # noqa: E731
    plain = lambda v, l, a: msdeform.ms_deform_attn_plain(v, levels, l, a)  # noqa: E731
    before = msdeform.ms_deform_attn.launches
    with torch.no_grad():
        _check(kern, plain, args, dtype, keep=(1, 2))
    assert msdeform.ms_deform_attn.launches > before
    g = _randn(gen, b, q, m * d)
    x = [a.to(dtype) if i == 0 else a for i, a in enumerate(args)]
    xs = [t.detach().requires_grad_() for t in x]
    got = torch.autograd.grad(kern(*xs), xs, g)
    ref_in = [t.detach().float().requires_grad_() for t in x]
    want = torch.autograd.grad(plain(*ref_in), ref_in, g)
    for a, w in zip(got, want):
        rel = 1e-4 if dtype == torch.float32 else 2 ** -7
        _close(a, w, rel)


def test_ms_deform_attn_refuses_unported_head_dims(dev):
    v = torch.zeros((1, 4, 1, 12), device="cuda")
    loc = torch.zeros((1, 1, 1, 1, 1, 2), device="cuda")
    with pytest.raises(NotImplementedError, match="not ported"):
        msdeform.ms_deform_attn(v, ((2, 2),), loc, torch.ones((1, 1, 1, 1, 1), device="cuda"))
