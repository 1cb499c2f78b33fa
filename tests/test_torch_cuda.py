"""The port's CUDA kernels against their plain versions on the card, at
small and ragged shapes (the serving shapes are ``chip_smoke.py``'s).

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
from segmentation_factory_tpu_torch.ops import mixffn, resize_argmax, resize_sum, sra_attention

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


def _check(kernel, plain, args, dtype):
    if dtype == torch.float32:
        _close(kernel(*args), plain(*args))
        return
    args = [a.to(dtype) for a in args]
    truth = plain(*[a.float() for a in args])
    err_k = (kernel(*args).float() - truth).abs().max().item()
    err_p = (plain(*args).float() - truth).abs().max().item()
    assert err_k <= max(2 * err_p, 2 ** -7 * truth.abs().max().item()), (err_k, err_p)


def _randn(g, *shape, scale=1.0):
    return torch.randn(shape, generator=g, device="cuda") * scale


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,m,h,d", [(300, 70, 2, 64), (64, 4, 1, 32), (1024, 1024, 8, 64)])
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
@pytest.mark.parametrize("sizes,e", [((2, 4, 8, 16), 64), ((2, 4, 7, 13), 16)])
def test_resize_sum_kernel(dev, sizes, e, dtype):
    g = torch.Generator(device=dev).manual_seed(2)
    levels = [_randn(g, 2, s, s, e) for s in sizes]
    _check(lambda *z: resize_sum.resize_sum(list(z)),
           lambda *z: resize_sum.resize_sum_plain(list(z)), levels, dtype)


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
