"""K8: channel argmax of the bilinear upsample of low-resolution logits.

Port of ``segmentation_factory_tpu/ops/pallas_loss.py``: the entry
``resize_argmax_to`` (:377-416, body ``_argmax_kernel`` :338). The CUDA
kernel is ``csrc/resize_argmax.cu``: bands and spans of fine pixels
(``transpose_geometry.lowres_fwd_geometry``, its table on the device once
per shape), each pixel's logits sampled from shared memory by
``csrc/lowres_rows.cuh`` as the plain version samples them, so the labels
equal the plain version's; the full-resolution logits never reach device
memory. It takes any output size, so the TPU's dyadic shape gate
has no counterpart. ``resize_argmax_plain`` is the plain version,
argmax(resize(lo)). An argmax has no gradient: a CUDA ``lo`` that needs one
raises rather than pass through unnoticed. Otherwise the call is the
registered op ``sft::resize_argmax`` (``resize_argmax``): the kernel on the
card (its table looked up inside the op), the plain version on the CPU, an
empty int32 map under fake tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from segmentation_factory_tpu_torch.models.layers.common import resize
from segmentation_factory_tpu_torch.ops import _build, transpose_geometry

_ARGTYPES = ([_build.VOIDP] * 3 + [ctypes.POINTER(ctypes.c_int)] + [_build.INT] * 6
             + [_build.INT, _build.VOIDP])
_SLOTS_ARGTYPES = [_build.INT] * 3 + [ctypes.POINTER(ctypes.c_int)]


def resize_argmax_plain(lo, out_hw):
    """argmax over channels of the float32 upsample of NHWC ``lo``, first
    index on ties, int32 (B, H, W)."""
    return torch.argmax(resize(lo.float(), tuple(out_hw)), dim=-1).to(torch.int32)


@functools.lru_cache(maxsize=64)
def _tables(key: tuple, batch: int, dtype_code: int, device: torch.device):
    """(geometry, its table on ``device``, K8's layout as its kernel takes
    it) for lo of ``batch`` images: as many bands as fill the card's
    resident blocks of K8 in one wave (``transpose_geometry.lowres_fwd_geometry``)."""
    lay = transpose_geometry.lowres_fwd_geometry(*key).argmax
    slots = ctypes.c_int()
    with torch.cuda.device(device):
        _build.launch("resize_argmax", "sft_resize_argmax_slots", _SLOTS_ARGTYPES, dtype_code,
                      lay.threads, lay.smem, ctypes.byref(slots))
    geo, tab = transpose_geometry.device_tables("lowres_fwd", key + (batch, (None, slots.value)),
                                                device)
    layout = geo.layout("argmax")
    return geo, tab, (ctypes.c_int * len(layout))(*layout)


def geometry(lo, out_hw):
    """K8's geometry and its table on the device for a CUDA ``lo`` sampled
    at ``out_hw``."""
    b, hl, wl, c = lo.shape
    key = (hl, wl, int(out_hw[0]), int(out_hw[1]), c, lo.element_size())
    return _tables(key, b, _build.DTYPE_CODE[lo.dtype], lo.device)[:2]


def _forward(lo, hh: int, wh: int):
    b, hl, wl, c = lo.shape
    code = _build.DTYPE_CODE[lo.dtype]
    _, tab, layout = _tables((hl, wl, hh, wh, c, lo.element_size()), b, code, lo.device)
    out = torch.empty((b, hh, wh), dtype=torch.int32, device=lo.device)
    _build.launch(
        "resize_argmax", "sft_resize_argmax", _ARGTYPES,
        lo.data_ptr(), out.data_ptr(), tab.data_ptr(), layout, b, hl, wl, c, hh, wh, code,
        _build.stream_ptr(lo),
    )
    resize_argmax_to.launches += 1
    return out


def _op(lo, out_h: int, out_w: int):
    """K8 on the card as ``sft::resize_argmax`` runs it: the check, then the
    kernel (``launches`` of ``resize_argmax_to`` counts it)."""
    _build.check_cuda(lo, "lo")
    return _forward(lo, out_h, out_w)


resize_argmax = _build.register_op(
    "resize_argmax(Tensor lo, int out_h, int out_w) -> Tensor", cuda=_op,
    cpu=lambda lo, out_h, out_w: resize_argmax_plain(lo, (out_h, out_w)),
    fake=lambda lo, out_h, out_w: lo.new_empty((lo.shape[0], out_h, out_w), dtype=torch.int32))


def resize_argmax_to(lo, out_hw):
    """``resize_argmax_plain`` through the kernel for a CUDA ``lo``
    (float32 or bfloat16, upsampled in float32); the plain version on the
    CPU; both through ``sft::resize_argmax``."""
    _build.check_device(lo, "lo")
    if lo.device.type == "cuda":
        _build.refuse_grad("resize_argmax_to", lo)
    return resize_argmax(lo, int(out_hw[0]), int(out_hw[1]))


resize_argmax_to.launches = 0
