"""K5: sum of feature levels bilinearly upsampled to the largest one.

Port of ``segmentation_factory_tpu/ops/pallas_resize_sum.py``: the entry
``resize_sum`` (:347-400), its TPU kernels ``_forward`` (:109, body
``_kernel`` :85) and ``_backward`` (:239, body ``_bwd_kernel`` :191), and the
``custom_vjp`` ``_fused`` (:182-328). The CUDA kernels are
``csrc/resize_sum.cu`` (K5f) and ``csrc/resize_sum_bwd.cu`` (K5b). Both
sample every level at (dst + 0.5) * (h_l / H) - 0.5, edge-clamped, from
tables of the plain version's taps (``transpose_geometry``), so dyadic
and non-dyadic pyramids take the same path and the TPU's shape gates have
no counterpart. K5f interpolates each level's rows once a fine row into
shared memory and its columns from there, in bands of fine rows, spans of
fine columns and slabs of channels (``transpose_geometry.sum_fwd_geometry``,
on the device once per shape). ``resize_sum_plain`` is the plain version
(``_xla_resize_sum`` and, for other pyramids, ``resize``); its autograd is
the plain backward. The backward of a full-size level is the cotangent
itself; K5b writes every smaller level's transpose in one launch, reading
g once for all of them: its bands, footprints and weights come from
``transpose_geometry.sum_bwd_geometry`` (the plain version's taps), on the
device once per shape. A forward that needs no gradient is the registered
op ``sft::resize_sum_fwd`` (``resize_sum_fwd``, its levels a list): K5f on
the card (its tables looked up inside the op), the plain version on the
CPU, an empty output of the largest level's shape under fake tensors.
"""

from __future__ import annotations

import ctypes

import torch

from segmentation_factory_tpu_torch.models.layers.common import resize
from segmentation_factory_tpu_torch.ops import _build, transpose_geometry

MAX_LEVELS = 8
_PTRS = ctypes.POINTER(ctypes.c_void_p)
_INTS = ctypes.POINTER(ctypes.c_int)
_ARGTYPES = [_PTRS, _build.INT, _PTRS, _INTS, _INTS, _build.INT, _build.VOIDP, _INTS, _INTS,
             _build.VOIDP] + [_build.INT] * 5 + [_build.VOIDP]
_BWD_ARGTYPES = [_build.VOIDP, _build.VOIDP, ctypes.POINTER(ctypes.c_void_p), _INTS, _INTS,
                 _INTS, _INTS] + [_build.INT] * 5 + [_build.INT, _build.VOIDP]


def _target_first(levels):
    """(H, W) of the largest level, and the levels with those of that size
    first — the kernel's and the plain version's order of summation."""
    target = max(levels, key=lambda z: z.shape[1])
    h, w = target.shape[1], target.shape[2]
    full = [z for z in levels if (z.shape[1], z.shape[2]) == (h, w)]
    return (h, w), full + [z for z in levels if (z.shape[1], z.shape[2]) != (h, w)]


def resize_sum_plain(levels):
    """Sum of NHWC ``levels`` upsampled to the largest level's HW,
    accumulated in float32 and cast to the levels' dtype."""
    (h, w), ordered = _target_first(levels)
    acc = ordered[0].float()
    for z in ordered[1:]:
        acc = acc + resize(z.float(), (h, w))
    return acc.to(levels[0].dtype)


def _check(levels) -> None:
    ordered = _target_first(levels)[1]
    b, e = ordered[0].shape[0], ordered[0].shape[3]
    if len(ordered) > MAX_LEVELS:
        raise ValueError(f"at most {MAX_LEVELS} levels, got {len(ordered)}")
    if e % 4:
        raise ValueError(f"channels {e} must be a multiple of 4")
    for i, z in enumerate(ordered):
        _build.check_cuda(z, f"levels[{i}]", (b, z.shape[1], z.shape[2], e), ordered[0].dtype)


def _forward(levels):
    (h, w), ordered = _target_first(levels)
    b, e = ordered[0].shape[0], ordered[0].shape[3]
    dt = ordered[0].dtype
    out = torch.empty((b, h, w, e), dtype=dt, device=ordered[0].device)
    full = [z for z in ordered if (z.shape[1], z.shape[2]) == (h, w)]
    small = ordered[len(full):]
    nf, n = len(full), len(small)
    geo, tab = transpose_geometry.device_tables(
        "sum_fwd", (h, w, tuple((z.shape[1], z.shape[2]) for z in small), e, out.element_size()),
        out.device)
    offs = [o for lv in geo.offsets for o in lv]
    layout = (geo.vec, geo.groups.bit_length() - 1, geo.cols, geo.rows, geo.spans, geo.bands,
              geo.smem)
    _build.launch(
        "resize_sum", "sft_resize_sum", _ARGTYPES,
        (ctypes.c_void_p * nf)(*[z.data_ptr() for z in full]), nf,
        (ctypes.c_void_p * max(n, 1))(*[z.data_ptr() for z in small]),
        (ctypes.c_int * max(n, 1))(*[z.shape[1] for z in small]),
        (ctypes.c_int * max(n, 1))(*[z.shape[2] for z in small]), n, tab.data_ptr(),
        (ctypes.c_int * max(len(offs), 1))(*offs), (ctypes.c_int * 7)(*layout),
        out.data_ptr(), b, h, w, e, _build.DTYPE_CODE[dt], _build.stream_ptr(out),
    )
    resize_sum.launches += 1
    return out


def resize_sum_bwd(g, shapes):
    """K5b: the cotangent of each level of ``resize_sum`` (NHWC ``shapes``,
    in any order) for the cotangent ``g`` (B, H, W, E) of its output: g
    itself for a level of g's size, the transposed upsample of g for every
    smaller one (one launch for all of them), in g's dtype. CUDA only."""
    b, h, w, e = g.shape
    _build.check_cuda(g, "g")
    if e % 4:
        raise ValueError(f"channels {e} must be a multiple of 4")
    small = [i for i, s in enumerate(shapes) if (s[1], s[2]) != (h, w)]
    if len(small) > MAX_LEVELS:
        raise ValueError(f"at most {MAX_LEVELS} levels, got {len(small)}")
    outs = [g if i not in small else torch.empty(tuple(shapes[i]), dtype=g.dtype, device=g.device)
            for i in range(len(shapes))]
    if small:
        n = len(small)
        geo, tab = transpose_geometry.device_tables(
            "sum", (h, w, tuple((shapes[i][1], shapes[i][2]) for i in small), e), g.device)
        ptrs = (ctypes.c_void_p * n)(*[outs[i].data_ptr() for i in small])
        hs = (ctypes.c_int * n)(*[shapes[i][1] for i in small])
        ws = (ctypes.c_int * n)(*[shapes[i][2] for i in small])
        offs = [geo.offsets[0]] + [o for lv in geo.offsets[1:] for o in lv]
        layout = (ctypes.c_int * 5)(geo.bands, geo.cols, geo.quads, geo.threads,
                                    transpose_geometry.SUM_EVERY)
        _build.launch(
            "resize_sum_bwd", "sft_resize_sum_bwd", _BWD_ARGTYPES,
            g.data_ptr(), tab.data_ptr(), ptrs, hs, ws, (ctypes.c_int * len(offs))(*offs),
            layout, n, b, h, w, e, _build.DTYPE_CODE[g.dtype], _build.stream_ptr(g),
        )
        resize_sum_bwd.launches += 1
    return outs


def _fwd_op(levels):
    """K5f on the card as ``sft::resize_sum_fwd`` runs it: the checks, then
    the kernel (``launches`` counts it)."""
    _check(levels)
    return _forward(levels)


def _plain_op(levels):
    out = resize_sum_plain(levels)
    # an op's output may not alias its input (one float32 level is its own sum)
    return out.clone() if any(out is z for z in levels) else out


def _fake_op(levels):
    (h, w), ordered = _target_first(levels)
    b, e = ordered[0].shape[0], ordered[0].shape[3]
    return ordered[0].new_empty((b, h, w, e))


resize_sum_fwd = _build.register_op("resize_sum_fwd(Tensor[] levels) -> Tensor",
                                    cuda=_fwd_op, cpu=_plain_op, fake=_fake_op)


class _ResizeSum(torch.autograd.Function):
    """K5f forward, K5b backward."""

    @staticmethod
    def forward(ctx, *levels):
        ctx.shapes = [tuple(z.shape) for z in levels]
        return _forward(list(levels))

    @staticmethod
    def backward(ctx, g):
        return tuple(resize_sum_bwd(g.contiguous(), ctx.shapes))


def resize_sum(levels):
    """``resize_sum_plain`` through the kernel for CUDA tensors (one dtype,
    float32 or bfloat16, one batch and channel count, channels a multiple
    of 4, at most ``MAX_LEVELS`` levels), with K5b as the backward when a
    gradient is needed; the plain version on the CPU. Without a gradient,
    through ``sft::resize_sum_fwd`` on either device."""
    if torch.is_grad_enabled() and any(z.requires_grad for z in levels):
        if levels[0].device.type == "cpu":
            return resize_sum_plain(levels)
        _check(levels)
        return _ResizeSum.apply(*levels)
    _build.check_device(levels[0], "levels[0]")
    return resize_sum_fwd(list(levels))


resize_sum.launches = 0
resize_sum_bwd.launches = 0
