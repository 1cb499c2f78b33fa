"""Pyramid Pooling Module (PSPNet).

Port of ``segmentation_factory_tpu/models/modules/ppm.py``: pool the map to
each of the bins {1, 2, 3, 6} (``adaptive_avg_pool``) -> 1x1 ConvModule ->
upsample back with ``align_corners=True`` -> concat after the input in
reverse bin order (the order the bottleneck's weights follow) -> 3x3
bottleneck ConvModule.

Keys follow the reference ``state_dict``: ``stages.{k}.1`` (the pool is
``stages.{k}.0`` there and has no parameters), ``bottleneck``.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from segmentation_factory_tpu_torch.models.layers import ConvModule, resize, resize_align_corners


def adaptive_avg_pool(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """NHWC average pool to ``out_hw``, as the JAX function: the mean of
    equal windows (float32 sums, cast back) where the bin divides the size,
    else a bilinear resize without antialias (in bfloat16 for bfloat16
    inputs) — not ``F.adaptive_avg_pool2d``'s uneven windows."""
    b, h, w, c = x.shape
    oh, ow = out_hw
    if h % oh == 0 and w % ow == 0:
        return x.float().reshape(b, oh, h // oh, ow, w // ow, c).mean((2, 4)).to(x.dtype)
    return resize(x, (oh, ow))


SCALES = (1, 2, 3, 6)  # the pooled bins


class PPM(nn.Module):
    def __init__(self, in_ch: int, channels: int, dtype=torch.bfloat16):
        super().__init__()
        self.stages = nn.ModuleList(
            nn.ModuleList([nn.Identity(), ConvModule(in_ch, channels, 1, dtype=dtype)])
            for _ in SCALES)
        self.bottleneck = ConvModule(in_ch + len(SCALES) * channels, channels, 3, padding=1,
                                     dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        pooled = [resize_align_corners(stage[1](adaptive_avg_pool(x, (s, s))), (h, w))
                  for s, stage in zip(SCALES, self.stages)]
        return self.bottleneck(torch.cat([x] + pooled[::-1], dim=-1))
