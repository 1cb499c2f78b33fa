"""K2: Mix-FFN, fc1 -> 3x3 depthwise (zero SAME padding) -> exact-erf GELU -> fc2.

Port of ``segmentation_factory_tpu/ops/pallas_ffn.py``: the entry
``mixffn_apply`` (:418-458), its TPU kernels ``_forward`` (:304, body
``_fwd_kernel`` :85) and ``_bwd_rule`` (:351, body ``_bwd_kernel`` :119), and
the ``custom_vjp`` ``_ffn_fused`` (:329-406). The CUDA kernels are
``csrc/mixffn.cu`` (K2f) and ``csrc/mixffn_bwd.cu`` (K2b); both keep the
4C-wide hidden activation out of device memory. ``mixffn_plain`` is the
plain version (``_xla_composition``, :338-348) and its autograd is the plain
backward. The JAX package's exit to an XLA recompute-VJP for C = 512-like
shapes (:355-360) has no counterpart: K2b takes every MiT stage.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from segmentation_factory_tpu_torch.ops import _build

_ARGTYPES = [_build.VOIDP] * 8 + [_build.INT] * 7 + [_build.INT, _build.VOIDP]
_BWD_ARGTYPES = [_build.VOIDP] * 14 + [_build.INT] * 7 + [_build.INT, _build.VOIDP]
# csrc/mixffn.cu: 256 threads; in float32 each owns one 4-channel group of C
# for up to 16 pixels of a (rows x 8) tile, in bfloat16 the 8 warps own at
# most 64 16x16 accumulator tiles — the same P * C <= 16384 either way.
# csrc/mixffn_bwd.cu keeps the same dy accumulators and tile.
_THREADS = 256
_PIXELS_PER_THREAD = 16
_TILE_W = 8
MAX_CHANNELS = 4 * _THREADS
MAX_CHANNELS_BWD = 512


def mixffn_plain(y, w1, b1, dw, db, w2, b2):
    """The FFN in y's dtype; y (B, H, W, C), w1 (C, HC), dw (3, 3, 1, HC),
    w2 (HC, C) — the JAX argument layout."""
    dt = y.dtype
    hc = w1.shape[-1]
    hid = y @ w1.to(dt) + b1.to(dt)
    hid = F.conv2d(hid.permute(0, 3, 1, 2), dw.to(dt).permute(3, 2, 0, 1),
                   db.to(dt), padding=1, groups=hc).permute(0, 2, 3, 1)
    hid = F.gelu(hid)  # exact erf
    return hid @ w2.to(dt) + b2.to(dt)


def tile_rows(c: int, h: int) -> int:
    """Rows of the (rows x 8)-pixel output tile one block owns: as many as
    the threads' accumulators cover, at most 16, and no more than ``h``
    rounded up to even (the tensor-core path takes 16-pixel row pairs)."""
    pixel_groups = _THREADS // (c // 4)
    return min(16, pixel_groups * _PIXELS_PER_THREAD // _TILE_W, h + h % 2)


def _check(y, w1, b1, dw, db, w2, b2=None) -> None:
    c, hc = y.shape[-1], w1.shape[-1]
    _build.check_cuda(y, "y")
    dt = y.dtype
    _build.check_cuda(w1, "w1", (c, hc), dt)
    _build.check_cuda(b1, "b1", (hc,), dt)
    _build.check_cuda(dw, "dw", (3, 3, 1, hc), dt)
    _build.check_cuda(db, "db", (hc,), dt)
    _build.check_cuda(w2, "w2", (hc, c), dt)
    if b2 is not None:
        _build.check_cuda(b2, "b2", (c,), dt)
    if c % 16 or hc % 32 or not 16 <= c <= MAX_CHANNELS:
        raise ValueError(f"C={c} must be a multiple of 16 in [16, {MAX_CHANNELS}]; "
                         f"HC={hc} a multiple of 32")


def _forward(y, w1, b1, dw, db, w2, b2):
    bsz, h, w, c = y.shape
    out = torch.empty_like(y)
    _build.launch(
        "mixffn", "sft_mixffn", _ARGTYPES,
        y.data_ptr(), w1.data_ptr(), b1.data_ptr(), dw.data_ptr(),
        db.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        bsz, h, w, c, w1.shape[-1], tile_rows(c, h), _TILE_W,
        _build.DTYPE_CODE[y.dtype], _build.stream_ptr(y),
    )
    mixffn_apply.launches += 1
    return out


def mixffn_bwd(y, w1, b1, dw, db, w2, g):
    """K2b: (dy, dw1, db1, ddw, ddb, dw2, db2) of ``mixffn_apply`` for the
    cotangent ``g`` of its output (b2 does not enter: its gradient is the
    column sum of g, which the kernel also writes). CUDA tensors only, C a
    multiple of 32 up to ``MAX_CHANNELS_BWD``; dy in y's dtype, the
    parameter gradients accumulated in float32 (atomicAdd) and returned so."""
    _check(y, w1, b1, dw, db, w2)
    _build.check_cuda(g, "g", y.shape, y.dtype)
    bsz, h, w, c = y.shape
    hc = w1.shape[-1]
    if c % 32 or c > MAX_CHANNELS_BWD:
        raise ValueError(f"C={c} must be a multiple of 32 up to {MAX_CHANNELS_BWD}")
    dy = torch.empty_like(y)
    grads = [torch.zeros(s, dtype=torch.float32, device=y.device)
             for s in [(c, hc), (hc,), (3, 3, 1, hc), (hc,), (hc, c), (c,)]]
    _build.launch(
        "mixffn_bwd", "sft_mixffn_bwd", _BWD_ARGTYPES,
        y.data_ptr(), w1.data_ptr(), b1.data_ptr(), dw.data_ptr(), db.data_ptr(),
        w2.data_ptr(), g.data_ptr(), dy.data_ptr(), *[t.data_ptr() for t in grads],
        bsz, h, w, c, hc, tile_rows(c, h), _TILE_W,
        _build.DTYPE_CODE[y.dtype], _build.stream_ptr(y),
    )
    mixffn_bwd.launches += 1
    return (dy, *grads)


class _MixFFN(torch.autograd.Function):
    """K2f forward, K2b backward; the parameter gradients come back in the
    parameters' dtypes."""

    @staticmethod
    def forward(ctx, y, w1, b1, dw, db, w2, b2):
        ctx.save_for_backward(y, w1, b1, dw, db, w2)
        ctx.b2_dtype = b2.dtype
        return _forward(y, w1, b1, dw, db, w2, b2)

    @staticmethod
    def backward(ctx, g):
        y, w1, b1, dw, db, w2 = ctx.saved_tensors
        dy, *grads = mixffn_bwd(y, w1, b1, dw, db, w2, g.contiguous())
        dts = [w1.dtype, b1.dtype, dw.dtype, db.dtype, w2.dtype, ctx.b2_dtype]
        return (dy, *[t.to(d) for t, d in zip(grads, dts)])


def mixffn_apply(y, w1, b1, dw, db, w2, b2):
    """Mix-FFN of the LayerNorm output y (B, H, W, C) with the JAX layout
    w1 (C, HC), b1 (HC,), dw (3, 3, 1, HC), db (HC,), w2 (HC, C), b2 (C,).
    CUDA tensors go through the kernel (all in y's dtype, float32 or
    bfloat16, C a multiple of 16, HC of 32), with K2b as the backward when a
    gradient is needed; CPU tensors through the plain version."""
    if y.device.type == "cpu":
        return mixffn_plain(y, w1, b1, dw, db, w2, b2)
    args = (y, w1, b1, dw, db, w2, b2)
    _check(*args)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _MixFFN.apply(*args)
    return _forward(*args)


mixffn_apply.launches = 0
mixffn_bwd.launches = 0
