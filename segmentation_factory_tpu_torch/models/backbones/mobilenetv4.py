"""MobileNetV4, the conv variants (small / medium / large), spec-table driven.

Port of ``segmentation_factory_tpu/models/backbones/mobilenetv4.py``: the
spec tables ``MNV4_SPECS`` of the conv variants, ``UIB`` (:153), ``FusedIB``
(:252) and ``MobileNetV4`` (:273) over ``ConvModule`` (conv -> BatchNorm ->
ReLU). Rows:

- convbn: (in, out, kernel, stride);
- fused_ib: (in, out, stride, expand_ratio, act);
- uib: (in, out, start_dw_k, middle_dw_k, middle_down, stride, expand).

The features are the outputs of layer1..layer4 (strides 4 / 8 / 16 / 32).
The hybrid variants add mobile multi-query attention (``MobileMQA``); they
are not ported and their names raise. No TPU kernel is on this path.

Keys follow the reference's timm layout: ``conv_stem`` / ``bn1``, then
``blocks.{s}.{j}`` for layer s + 1's row j: ``{conv, bn1}`` (convbn),
``{conv_exp, bn1, conv_pwl, bn2}`` (FusedIB) and
``{dw_start, pw_exp, dw_mid, pw_proj}.{conv, bn}`` (UIB).
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from segmentation_factory_tpu_torch.models.layers import BatchNorm, ConvModule, conv_bn_act
from segmentation_factory_tpu_torch.registry import register_backbone

MNV4_SPECS = {
    "small": {
        "conv0": ("convbn", [(3, 32, 3, 2)]),
        "layer1": ("convbn", [(32, 32, 3, 2), (32, 32, 1, 1)]),
        "layer2": ("convbn", [(32, 96, 3, 2), (96, 64, 1, 1)]),
        "layer3": ("uib", [
            (64, 96, 5, 5, True, 2, 3), (96, 96, 0, 3, True, 1, 2),
            (96, 96, 0, 3, True, 1, 2), (96, 96, 0, 3, True, 1, 2),
            (96, 96, 0, 3, True, 1, 2), (96, 96, 3, 0, True, 1, 4),
        ]),
        "layer4": ("uib", [
            (96, 128, 3, 3, True, 2, 6), (128, 128, 5, 5, True, 1, 4),
            (128, 128, 0, 5, True, 1, 4), (128, 128, 0, 5, True, 1, 3),
            (128, 128, 0, 3, True, 1, 4), (128, 128, 0, 3, True, 1, 4),
        ]),
    },
    "medium": {
        "conv0": ("convbn", [(3, 32, 3, 2)]),
        "layer1": ("fused_ib", [(32, 48, 2, 4.0, True)]),
        "layer2": ("uib", [(48, 80, 3, 5, True, 2, 4), (80, 80, 3, 3, True, 1, 2)]),
        "layer3": ("uib", [
            (80, 160, 3, 5, True, 2, 6), (160, 160, 3, 3, True, 1, 4),
            (160, 160, 3, 3, True, 1, 4), (160, 160, 3, 5, True, 1, 4),
            (160, 160, 3, 3, True, 1, 4), (160, 160, 3, 0, True, 1, 4),
            (160, 160, 0, 0, True, 1, 2), (160, 160, 3, 0, True, 1, 4),
        ]),
        "layer4": ("uib", [
            (160, 256, 5, 5, True, 2, 6), (256, 256, 5, 5, True, 1, 4),
            (256, 256, 3, 5, True, 1, 4), (256, 256, 3, 5, True, 1, 4),
            (256, 256, 0, 0, True, 1, 4), (256, 256, 3, 0, True, 1, 4),
            (256, 256, 3, 5, True, 1, 2), (256, 256, 5, 5, True, 1, 4),
            (256, 256, 0, 0, True, 1, 4), (256, 256, 0, 0, True, 1, 4),
            (256, 256, 5, 0, True, 1, 2),
        ]),
    },
    "large": {
        "conv0": ("convbn", [(3, 24, 3, 2)]),
        "layer1": ("fused_ib", [(24, 48, 2, 4.0, True)]),
        "layer2": ("uib", [(48, 96, 3, 5, True, 2, 4), (96, 96, 3, 3, True, 1, 4)]),
        "layer3": ("uib", [
            (96, 192, 3, 5, True, 2, 4), (192, 192, 3, 3, True, 1, 4),
            (192, 192, 3, 3, True, 1, 4), (192, 192, 3, 3, True, 1, 4),
            (192, 192, 3, 5, True, 1, 4), (192, 192, 5, 3, True, 1, 4),
            (192, 192, 5, 3, True, 1, 4), (192, 192, 5, 3, True, 1, 4),
            (192, 192, 5, 3, True, 1, 4), (192, 192, 5, 3, True, 1, 4),
            (192, 192, 3, 0, True, 1, 4),
        ]),
        "layer4": ("uib", [
            (192, 512, 5, 5, True, 2, 4), (512, 512, 5, 5, True, 1, 4),
            (512, 512, 5, 5, True, 1, 4), (512, 512, 5, 5, True, 1, 4),
            (512, 512, 5, 0, True, 1, 4), (512, 512, 5, 3, True, 1, 4),
            (512, 512, 5, 0, True, 1, 4), (512, 512, 5, 0, True, 1, 4),
            (512, 512, 5, 3, True, 1, 4), (512, 512, 5, 5, True, 1, 4),
            (512, 512, 5, 0, True, 1, 4), (512, 512, 5, 0, True, 1, 4),
            (512, 512, 5, 0, True, 1, 4),
        ]),
    },
}
HYBRID = ("hybrid_medium", "hybrid_large")
ACT = "relu"  # the conv variants' activation (the hybrid large's GELU is not ported)
LAYERS = ("layer1", "layer2", "layer3", "layer4")


class UIB(nn.Module):
    """Universal Inverted Bottleneck: an optional start depthwise conv (no
    activation) -> 1x1 expand -> an optional middle depthwise conv -> 1x1
    project (no activation), with the residual where the stride is 1 and
    the width does not change. The stride sits on the middle depthwise conv
    (``middle_down``), else on the start one."""

    def __init__(self, in_ch: int, out_ch: int, start_dw_k: int, middle_dw_k: int,
                 middle_down: bool, stride: int, expand: float, dtype=torch.bfloat16):
        super().__init__()
        if stride > 1 and not (start_dw_k or middle_dw_k):
            raise ValueError("a UIB of stride > 1 needs a start or middle depthwise conv")
        kw = dict(dtype=dtype, keys=("conv", "bn"))
        mid = int(in_ch * expand)
        if start_dw_k:
            self.dw_start = ConvModule(in_ch, in_ch, start_dw_k, 1 if middle_dw_k else stride,
                                       start_dw_k // 2, groups=in_ch, act=None, **kw)
        self.pw_exp = ConvModule(in_ch, mid, 1, act=ACT, **kw)
        if middle_dw_k:
            self.dw_mid = ConvModule(mid, mid, middle_dw_k, stride if middle_down else 1,
                                     middle_dw_k // 2, groups=mid, act=ACT, **kw)
        self.pw_proj = ConvModule(mid, out_ch, 1, act=None, **kw)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for name in ("dw_start", "pw_exp", "dw_mid", "pw_proj"):
            if name in self._modules:
                y = self._modules[name](y)
        return x + y if self.residual else y


class FusedIB(nn.Module):
    """3x3 expand conv (stride, activation) -> 1x1 project (no activation)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, expand: float,
                 dtype=torch.bfloat16):
        super().__init__()
        mid = int(in_ch * expand)
        self.conv_exp = nn.Conv2d(in_ch, mid, 3, stride, bias=False)
        self.bn1 = BatchNorm(mid)
        self.conv_pwl = nn.Conv2d(mid, out_ch, 1, bias=False)
        self.bn2 = BatchNorm(out_ch)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_bn_act(x, self.conv_exp, self.bn1, 1, ACT, self.dtype)
        return conv_bn_act(y, self.conv_pwl, self.bn2, 0, None, self.dtype)


class MobileNetV4(nn.Module):
    """NHWC image -> the outputs of layer1..layer4, NHWC."""

    def __init__(self, variant: str, dtype=torch.bfloat16):
        super().__init__()
        spec = MNV4_SPECS[variant]
        self.dtype = dtype
        (_, out, k, s), = spec["conv0"][1]
        self.conv_stem = nn.Conv2d(3, out, k, s, bias=False)
        self.bn1 = BatchNorm(out)
        self.stem_padding = k // 2
        self.blocks = nn.ModuleList(nn.ModuleList(self._block(kind, row, dtype) for row in rows)
                                    for kind, rows in (spec[name] for name in LAYERS))

    @staticmethod
    def _block(kind: str, row, dtype) -> nn.Module:
        if kind == "convbn":
            c_in, out, k, s = row
            return ConvModule(c_in, out, k, s, k // 2, act=ACT, dtype=dtype, keys=("conv", "bn1"))
        if kind == "fused_ib":
            c_in, out, s, e, _ = row
            return FusedIB(c_in, out, s, e, dtype=dtype)
        return UIB(*row, dtype=dtype)

    def forward(self, x: torch.Tensor,
                factors: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """``factors``: unused (the conv variants have no drop-path)."""
        x = conv_bn_act(x, self.conv_stem, self.bn1, self.stem_padding, ACT, self.dtype)
        feats = []
        for layer in self.blocks:
            for blk in layer:
                x = blk(x)
            feats.append(x)
        return feats


def mnv4_channels(variant: str) -> List[int]:
    spec = MNV4_SPECS[variant]
    return [spec[name][1][-1][1] for name in LAYERS]


def _make_mnv4(variant: str):
    def factory(dtype=torch.bfloat16):
        if variant in HYBRID:
            raise NotImplementedError(
                f"mobilenetv4_{variant} is not ported: its MobileMQA blocks have no port")
        return MobileNetV4(variant, dtype=dtype), mnv4_channels(variant)

    return factory


for _v in (*MNV4_SPECS, *HYBRID):
    register_backbone(f"mobilenetv4_{_v}")(_make_mnv4(_v))
# the reference's spec key carries a typo ("samll"); accepted as an alias
register_backbone("mobilenetv4_samll")(_make_mnv4("small"))
