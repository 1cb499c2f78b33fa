"""K8: channel argmax of the bilinear upsample of low-resolution logits.

Port of ``segmentation_factory_tpu/ops/pallas_loss.py``: the entry
``resize_argmax_to`` (:377-416, body ``_argmax_kernel`` :338). The CUDA
kernel is ``csrc/resize_argmax.cu``; the full-resolution logits never reach
device memory. It takes any output size, so the TPU's dyadic shape gate
has no counterpart. ``resize_argmax_plain`` is the plain version,
argmax(resize(lo)). An argmax has no gradient: a CUDA ``lo`` that needs one
raises rather than pass through unnoticed.
"""

from __future__ import annotations

import torch

from segmentation_factory_tpu_torch.models.layers.common import resize
from segmentation_factory_tpu_torch.ops import _build

_ARGTYPES = [_build.VOIDP] * 2 + [_build.INT] * 6 + [_build.INT, _build.VOIDP]


def resize_argmax_plain(lo, out_hw):
    """argmax over channels of the float32 upsample of NHWC ``lo``, first
    index on ties, int32 (B, H, W)."""
    return torch.argmax(resize(lo.float(), tuple(out_hw)), dim=-1).to(torch.int32)


def resize_argmax_to(lo, out_hw):
    """``resize_argmax_plain`` through the kernel for a CUDA ``lo``
    (float32 or bfloat16, upsampled in float32); the plain version on the
    CPU."""
    if lo.device.type == "cpu":
        return resize_argmax_plain(lo, out_hw)
    _build.check_cuda(lo, "lo")
    _build.refuse_grad("resize_argmax_to", lo)
    b, hl, wl, c = lo.shape
    hh, wh = (int(s) for s in out_hw)
    out = torch.empty((b, hh, wh), dtype=torch.int32, device=lo.device)
    _build.launch(
        "resize_argmax", "sft_resize_argmax", _ARGTYPES,
        lo.data_ptr(), out.data_ptr(), b, hl, wl, c, hh, wh,
        _build.DTYPE_CODE[lo.dtype], _build.stream_ptr(lo),
    )
    resize_argmax_to.launches += 1
    return out


resize_argmax_to.launches = 0
