"""K5: sum of feature levels bilinearly upsampled to the largest one.

Port of ``segmentation_factory_tpu/ops/pallas_resize_sum.py``: the entry
``resize_sum`` (:347-400) and its TPU kernel ``_forward`` (:109, body
``_kernel`` :85). The CUDA kernel is ``csrc/resize_sum.cu``. It samples
every level at (dst + 0.5) * (h_l / H) - 0.5, edge-clamped, so dyadic and
non-dyadic pyramids take the same path and the TPU's shape gates have no
counterpart. ``resize_sum_plain`` is the plain version (``_xla_resize_sum``
and, for other pyramids, ``resize``). Forward only.
"""

from __future__ import annotations

import ctypes

import torch

from segmentation_factory_tpu_torch.models.layers.common import resize
from segmentation_factory_tpu_torch.ops import _build

MAX_LEVELS = 8
_ARGTYPES = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
             ctypes.POINTER(ctypes.c_int), _build.INT, _build.VOIDP] + [
    _build.INT] * 4 + [_build.INT, _build.VOIDP]


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


def resize_sum(levels):
    """``resize_sum_plain`` through the kernel for CUDA tensors (one dtype,
    float32 or bfloat16, one batch and channel count, channels a multiple
    of 4, at most ``MAX_LEVELS`` levels); the plain version on the CPU."""
    if levels[0].device.type == "cpu":
        return resize_sum_plain(levels)
    (h, w), ordered = _target_first(levels)
    b, e = ordered[0].shape[0], ordered[0].shape[3]
    dt = ordered[0].dtype
    if len(ordered) > MAX_LEVELS:
        raise ValueError(f"at most {MAX_LEVELS} levels, got {len(ordered)}")
    if e % 4:
        raise ValueError(f"channels {e} must be a multiple of 4")
    for i, z in enumerate(ordered):
        _build.check_cuda(z, f"levels[{i}]", (b, z.shape[1], z.shape[2], e), dt)
    out = torch.empty((b, h, w, e), dtype=dt, device=ordered[0].device)
    n = len(ordered)
    ptrs = (ctypes.c_void_p * n)(*[z.data_ptr() for z in ordered])
    hs = (ctypes.c_int * n)(*[z.shape[1] for z in ordered])
    ws = (ctypes.c_int * n)(*[z.shape[2] for z in ordered])
    _build.launch(
        "resize_sum", "sft_resize_sum", _ARGTYPES,
        ptrs, hs, ws, n, out.data_ptr(), b, h, w, e,
        _build.DTYPE_CODE[dt], _build.stream_ptr(out),
    )
    resize_sum.launches += 1
    return out


resize_sum.launches = 0
