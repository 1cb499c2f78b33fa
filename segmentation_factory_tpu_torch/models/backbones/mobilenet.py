"""MobileNetV2 / V3 feature extractors.

Port of ``segmentation_factory_tpu/models/backbones/mobilenet.py``
(:25-125): a stem ConvModule (3 -> 32, 3x3 / 2) and 17 inverted-residual
blocks from the (t, c, n, s) table, the features tapped after blocks 3, 6,
13 and 17 (channels 24, 32, 96, 320 at strides 4, 8, 16, 32).
``mobilenetv2`` uses relu6; ``mobilenetv3`` hardswish and a
squeeze-excite (hard-sigmoid gate, ``make_divisible(mid // 4)``
channels) after each depthwise conv, as the JAX package builds it. No TPU
kernel is on this path.

Keys follow the reference's MobileNetV2 ``state_dict``: ``features.0.{0,1}``
(the stem), ``features.{i}.conv.{0,1}.{0,1}`` (the expand and depthwise
ConvModules; without the expand when t = 1) and the projection's conv and
BatchNorm at the next two indices. The reference's MobileNetV3 is the same
graph and never wires its SqueezeExcitation in, so the squeeze-excite's
keys are the port's own: ``features.{i}.se.{fc1, fc2}``.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from segmentation_factory_tpu_torch.models.layers import (
    BatchNorm,
    ConvModule,
    SqueezeExcite,
    conv_bn_act,
)
from segmentation_factory_tpu_torch.registry import register_backbone


def make_divisible(v: float, divisor: int = 8, min_value: Optional[int] = None) -> int:
    """Round channels to a multiple of ``divisor``, never below 90 % of v."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


# (expand_ratio t, out_channels c, repeats n, stride s)
IR_TABLE = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1),
            (6, 160, 3, 2), (6, 320, 1, 1))
OUT_INDICES = (3, 6, 13, 17)
CHANNELS = [24, 32, 96, 320]


class InvertedResidual(nn.Module):
    """1x1 expand -> 3x3 depthwise -> (squeeze-excite) -> 1x1 project, with
    the identity added when the stride is 1 and the widths match."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, expand_ratio: int,
                 use_se: bool = False, act: str = "relu6", dtype=torch.bfloat16):
        super().__init__()
        mid = int(round(in_ch * expand_ratio))
        self.residual = stride == 1 and in_ch == out_ch
        self.act, self.dtype = act, dtype
        self.conv = nn.Module()
        convs = ([ConvModule(in_ch, mid, 1, act=act, dtype=dtype)] if expand_ratio != 1 else [])
        convs.append(ConvModule(mid, mid, 3, stride, padding=1, groups=mid, act=act, dtype=dtype))
        for i, m in enumerate(convs):
            self.conv.add_module(str(i), m)
        self.conv.add_module(str(len(convs)), nn.Conv2d(mid, out_ch, 1, bias=False))
        self.conv.add_module(str(len(convs) + 1), BatchNorm(out_ch))
        self.n_convs = len(convs)
        if use_se:
            self.se = SqueezeExcite(mid, make_divisible(mid // 4), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self.conv._modules
        y = x
        for i in range(self.n_convs):
            y = m[str(i)](y)
        if hasattr(self, "se"):
            y = self.se(y)
        y = conv_bn_act(y, m[str(self.n_convs)], m[str(self.n_convs + 1)], 0, None, self.dtype)
        return x + y if self.residual else y


class MobileNet(nn.Module):
    def __init__(self, use_se: bool = False, act: str = "relu6", dtype=torch.bfloat16):
        super().__init__()
        blocks = [ConvModule(3, 32, 3, 2, padding=1, act=act, dtype=dtype)]
        in_ch = 32
        for t, c, n, s in IR_TABLE:
            for i in range(n):
                blocks.append(InvertedResidual(in_ch, c, s if i == 0 else 1, t, use_se, act,
                                               dtype))
                in_ch = c
        self.features = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor, drop_path=None) -> List[torch.Tensor]:
        feats = []
        for idx, blk in enumerate(self.features):
            x = blk(x)
            if idx in OUT_INDICES:
                feats.append(x)
        return feats


@register_backbone("mobilenetv2")
def _mobilenetv2(dtype=torch.bfloat16, img_size: int = 512):
    return MobileNet(use_se=False, act="relu6", dtype=dtype), list(CHANNELS)


@register_backbone("mobilenetv3")
def _mobilenetv3(dtype=torch.bfloat16, img_size: int = 512):
    return MobileNet(use_se=True, act="hswish", dtype=dtype), list(CHANNELS)
