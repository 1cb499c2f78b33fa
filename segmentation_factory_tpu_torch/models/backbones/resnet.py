"""ResNet-50 / 101 / 152 backbones (Bottleneck blocks, BatchNorm).

Port of ``segmentation_factory_tpu/models/backbones/resnet.py`` (``Bottleneck``,
``ResNet``, ``resnet.py:32-73``): a 7x7/2 stem conv (padding 3) -> BatchNorm
-> ReLU, a 3x3/2 max-pool (padding 1), then four stages of Bottlenecks
(1x1 -> 3x3 with the stage's stride on its first block, padding 1 -> 1x1 to
4x the width, each with a BatchNorm, ReLU after the first two; a 1x1
projection of the identity where the stride or width changes; ReLU of the
sum). The four stages' outputs (strides 4 to 32, 256 / 512 / 1024 / 2048
channels) are the features. The BatchNorms take batch statistics in
training. ``frozen_bn=True`` (detection's fixed statistics and affine) and
the detection FPN (``FeaturePyramidNetwork``, ``BackboneWithFPN``) are not
ported. No TPU kernel is on this path.

Keys follow the reference ``state_dict``: ``conv1``, ``bn1``,
``layer{i}.{j}.{conv1,bn1,conv2,bn2,conv3,bn3}`` and
``layer{i}.{j}.downsample.{0,1}``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from segmentation_factory_tpu_torch.models.layers import BatchNorm, ConvModule, conv_bn_act
from segmentation_factory_tpu_torch.registry import register_backbone

RESNET_SETTINGS = {
    "resnet50": [3, 4, 6, 3],
    "resnet101": [3, 4, 23, 3],
    "resnet152": [3, 8, 36, 3],
}
CHANNELS = [256, 512, 1024, 2048]


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, planes: int, stride: int, dtype):
        super().__init__()
        out = 4 * planes
        self.conv1 = nn.Conv2d(in_ch, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = BatchNorm(out)
        self.downsample: Optional[ConvModule] = None
        if stride != 1 or in_ch != out:
            self.downsample = ConvModule(in_ch, out, 1, stride, act=None, dtype=dtype)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = conv_bn_act(x, self.conv1, self.bn1, "SAME", "relu", dt)
        y = conv_bn_act(y, self.conv2, self.bn2, 1, "relu", dt)
        y = conv_bn_act(y, self.conv3, self.bn3, "SAME", None, dt)
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + identity)


class ResNet(nn.Module):
    """NHWC image -> the four stages' NHWC maps (strides 4 to 32)."""

    def __init__(self, layers: Sequence[int], dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 7, 2, bias=False)
        self.bn1 = BatchNorm(64)
        in_ch = 64
        for i, n in enumerate(layers):
            planes = 64 * 2 ** i
            blocks = []
            for j in range(n):
                blocks.append(Bottleneck(in_ch, planes, 2 if (j == 0 and i > 0) else 1, dtype))
                in_ch = 4 * planes
            setattr(self, f"layer{i + 1}", nn.ModuleList(blocks))
        self.num_stages = len(layers)

    def forward(self, x: torch.Tensor, factors=None) -> List[torch.Tensor]:
        """``factors`` is ignored: ResNet has no drop-path."""
        x = conv_bn_act(x, self.conv1, self.bn1, 3, "relu", self.dtype)
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1).contiguous()
        feats = []
        for i in range(self.num_stages):
            for blk in getattr(self, f"layer{i + 1}"):
                x = blk(x)
            feats.append(x)
        return feats


def _make_resnet(name: str):
    def factory(dtype=torch.bfloat16, img_size: int = 512, frozen_bn: bool = False):
        if frozen_bn:
            raise NotImplementedError(
                f"{name}(frozen_bn=True) is not ported: detection's frozen BatchNorm has no port")
        return ResNet(RESNET_SETTINGS[name], dtype=dtype), list(CHANNELS)

    return factory


for _name in RESNET_SETTINGS:
    register_backbone(_name)(_make_resnet(_name))
