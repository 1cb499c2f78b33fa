"""Panoptic-FPN-style decode head.

Port of ``segmentation_factory_tpu/models/heads/fpn.py``: 1x1 lateral
ConvModules over the pyramid coarsest first; walking to finer levels, the
running map meets each lateral and a 3x3 ConvModule smooths the sum; then,
in training, channel dropout (the mask an input) and the float32 1x1
classifier. Two modes, one set of weights:

- default: the running map is bilinearly resized to the lateral and
  added; the logits come out at the finest level's stride;
- ``torch_parity=True`` (the reference's forward): the running map is
  resized to the lateral with torch's legacy floor-indexed nearest where
  their sizes differ, added, then upsampled 2x by the same nearest rule
  before each smoothing conv, so the logits come out at half the finest
  stride.

Keys follow the reference ``state_dict``: ``lateral_convs.{i}``,
``output_convs.{i}`` for i >= 1 (the reference's ``output_convs.0`` is never
used by its forward and is not kept), ``conv_seg`` (a 1x1 conv).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from segmentation_factory_tpu_torch.models.heads.upernet import channel_dropout_mask, classify
from segmentation_factory_tpu_torch.models.layers import (
    ConvModule,
    resize_like,
    resize_nearest_legacy,
)
from segmentation_factory_tpu_torch.registry import register_head


class FPNHead(nn.Module):
    def __init__(self, channels: Sequence[int], num_classes: int, embed_dim: int = 128,
                 torch_parity: bool = False, dtype=torch.bfloat16):
        super().__init__()
        self.channels = list(channels)
        self.embed_dim = embed_dim
        self.torch_parity = torch_parity
        self.dtype = dtype
        e = embed_dim
        self.lateral_convs = nn.ModuleList(ConvModule(c, e, 1, dtype=dtype)
                                           for c in self.channels[::-1])
        self.output_convs = nn.ModuleDict({str(i): ConvModule(e, e, 3, padding=1, dtype=dtype)
                                           for i in range(1, len(self.channels))})
        self.conv_seg = nn.Conv2d(e, num_classes, 1)

    def dropout_mask(self, batch: int, generator: torch.Generator, device=None,
                     sizes=None) -> torch.Tensor:
        """(batch, E) channel-dropout mask drawn from ``generator``."""
        return channel_dropout_mask(batch, self.embed_dim, generator, device)

    def forward(self, feats: List[torch.Tensor],
                dmask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """feats: NHWC pyramid, finest first -> float32 logits at the finest
        stride (half of it with ``torch_parity``)."""
        if len(feats) != len(self.channels):
            raise ValueError(f"expected {len(self.channels)} levels, got {len(feats)}")
        feats = feats[::-1]
        x = self.lateral_convs[0](feats[0])
        for i in range(1, len(feats)):
            lat = self.lateral_convs[i](feats[i])
            if self.torch_parity:
                x = resize_nearest_legacy(x, lat.shape[1:3]) + lat
                x = resize_nearest_legacy(x, (2 * x.shape[1], 2 * x.shape[2]))
            else:
                x = resize_like(x, lat) + lat
            x = self.output_convs[str(i)](x)
        return classify(x, self.conv_seg, dmask)


@register_head("fpnhead")
def _fpn_head(channels, num_classes, embed_dim=128, dtype=torch.bfloat16, **kwargs):
    return FPNHead(channels, num_classes, embed_dim=embed_dim, dtype=dtype, **kwargs)
