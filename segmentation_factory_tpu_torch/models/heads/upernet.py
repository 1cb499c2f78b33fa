"""UPerNet decode head: PPM on the top level, a top-down FPN, fusion.

Port of ``segmentation_factory_tpu/models/heads/upernet.py``: 1x1 lateral
ConvModules on the three finer levels and the PPM on the coarsest; the
top-down pathway adds each coarser lateral, bilinearly resized, to the
next finer one; 3x3 ConvModules on the three finer sums; every output
resized to the finest level, concatenated (finest first), a 3x3 bottleneck
ConvModule, then, in training, channel dropout (``nn.Dropout2d``: one
factor a (image, channel), the mask an input) and the float32 1x1
classifier. No TPU kernel is on this path: the loss and the final
upsample+argmax of its logits are K7 and K8 (``engine.steps``).

Keys follow the reference ``state_dict``: ``ppm.stages.{k}.1``,
``ppm.bottleneck``, ``fpn_in.{i}``, ``fpn_out.{i}``, ``bottleneck`` and
``conv_seg`` (a 1x1 conv).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from segmentation_factory_tpu_torch.models.layers import ConvModule, resize_like
from segmentation_factory_tpu_torch.models.modules.ppm import PPM
from segmentation_factory_tpu_torch.registry import register_head

DROPOUT = 0.1  # the head's channel dropout (upernet.py:26)


def channel_dropout_mask(batch: int, channels: int, generator: torch.Generator,
                         device=None) -> torch.Tensor:
    """(batch, channels) float32 mask: 1 / keep with probability keep =
    1 - ``DROPOUT``, else 0."""
    keep = 1.0 - DROPOUT
    mask = torch.rand((batch, channels), generator=generator, device=device) < keep
    return mask.float() / keep


def classify(x: torch.Tensor, conv_seg: nn.Conv2d, dmask: Optional[torch.Tensor]) -> torch.Tensor:
    """The channel dropout ``dmask`` (B, E), if any, then the 1x1
    classifier in float32: contiguous (B, H, W, classes) float32 logits."""
    if dmask is not None:
        x = (x.float() * dmask[:, None, None, :]).to(x.dtype)
    return F.linear(x.float(), conv_seg.weight[:, :, 0, 0].float(), conv_seg.bias.float())


class UPerHead(nn.Module):
    def __init__(self, channels: Sequence[int], num_classes: int, embed_dim: int = 128,
                 dtype=torch.bfloat16):
        super().__init__()
        self.channels = list(channels)
        self.embed_dim = embed_dim
        self.dtype = dtype
        e = embed_dim
        self.ppm = PPM(self.channels[-1], e, dtype=dtype)
        self.fpn_in = nn.ModuleList(ConvModule(c, e, 1, dtype=dtype) for c in self.channels[:-1])
        self.fpn_out = nn.ModuleList(ConvModule(e, e, 3, padding=1, dtype=dtype)
                                     for _ in self.channels[:-1])
        self.bottleneck = ConvModule(len(self.channels) * e, e, 3, padding=1, dtype=dtype)
        self.conv_seg = nn.Conv2d(e, num_classes, 1)

    def dropout_mask(self, batch: int, generator: torch.Generator, device=None) -> torch.Tensor:
        """(batch, E) channel-dropout mask drawn from ``generator``."""
        return channel_dropout_mask(batch, self.embed_dim, generator, device)

    def forward(self, feats: List[torch.Tensor],
                dmask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """feats: NHWC pyramid, finest first -> (B, H/4, W/4, classes)
        float32. ``dmask``: the (B, E) dropout mask in training, None in
        eval."""
        if len(feats) != len(self.channels):
            raise ValueError(f"expected {len(self.channels)} levels, got {len(feats)}")
        lat = [conv(f) for conv, f in zip(self.fpn_in, feats[:-1])] + [self.ppm(feats[-1])]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + resize_like(lat[i], lat[i - 1])
        outs = [conv(x) for conv, x in zip(self.fpn_out, lat[:-1])] + [lat[-1]]
        x = self.bottleneck(torch.cat([resize_like(o, outs[0]) for o in outs], dim=-1))
        return classify(x, self.conv_seg, dmask)


@register_head("uperhead")
def _uper_head(channels, num_classes, embed_dim=128, dtype=torch.bfloat16):
    return UPerHead(channels, num_classes, embed_dim=embed_dim, dtype=dtype)
