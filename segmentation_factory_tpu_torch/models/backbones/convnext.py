"""ConvNeXt backbone (T / S / B / L / XL).

Port of ``segmentation_factory_tpu/models/backbones/convnext.py``: a 4x4/4
stem conv and its LayerNorm, then per stage (after the first) a LayerNorm
and a 2x2/2 downsample conv; blocks of 7x7 depthwise conv -> LayerNorm ->
Linear 4x -> exact GELU -> Linear -> layer scale ``gamma`` (1e-6 at init)
-> drop-path residual; each stage's output through its own LayerNorm.
NHWC throughout, so every LayerNorm is over the last axis. The stem and
downsample convs pad ``SAME`` as flax's default does (no padding at sizes
the stride divides; otherwise the extra row / column at the bottom /
right, ``layers.conv.same_pads``). The norms round to the compute dtype as
flax's ``nn.LayerNorm(dtype=...)`` (``CastLayerNorm``). No TPU kernel is on
this path: the convolutions and Linears are cuDNN's and cuBLAS's.

The drop-path rates rise to the variant's rate (tiny 0.1) over the blocks;
the factors are an input (``drop_path_factors``: one per block).

Keys follow the reference ``state_dict``: ``downsample_layers.0.{0: conv,
1: norm}``, ``downsample_layers.{1..3}.{0: norm, 1: conv}``,
``stages.{i}.{j}.{dwconv,norm,pwconv1,pwconv2,gamma}``, ``norm{i}``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from segmentation_factory_tpu_torch.models.layers import (
    CastLayerNorm,
    conv_nhwc,
    drop_path,
    drop_path_factor,
    drop_path_rates,
)
from segmentation_factory_tpu_torch.registry import register_backbone

CONVNEXT_SETTINGS = {
    # name: (depths, dims, drop_path_rate)
    "tiny": ([3, 3, 9, 3], [96, 192, 384, 768], 0.1),
    "small": ([3, 3, 27, 3], [96, 192, 384, 768], 0.4),
    "base": ([3, 3, 27, 3], [128, 256, 512, 1024], 0.5),
    "large": ([3, 3, 27, 3], [192, 384, 768, 1536], 0.5),
    "xlarge": ([3, 3, 27, 3], [256, 512, 1024, 2048], 0.5),
}
LAYER_SCALE_INIT = 1e-6


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, dtype, drop_path_rate: float = 0.0):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, groups=dim)
        self.norm = CastLayerNorm(dim, dtype)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), LAYER_SCALE_INIT))
        self.dtype = dtype
        self.drop_path_rate = drop_path_rate

    def forward(self, x: torch.Tensor, factor: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, H, W, C) in the compute dtype; ``factor`` (B,) the drop-path
        factors in training, None in eval."""
        dt = self.dtype
        y = self.norm(conv_nhwc(x, self.dwconv, 3, dt))
        y = F.gelu(F.linear(y, self.pwconv1.weight.to(dt), self.pwconv1.bias.to(dt)))
        y = F.linear(y, self.pwconv2.weight.to(dt), self.pwconv2.bias.to(dt))
        y = (y.float() * self.gamma).to(x.dtype)  # a float32 product, kept in the stream dtype
        return x + drop_path(y, factor)


class ConvNeXt(nn.Module):
    """NHWC image -> 4 NHWC pyramid levels (strides 4 to 32), each through
    its stage's output norm."""

    def __init__(self, depths: Sequence[int], dims: Sequence[int], drop_path_rate: float = 0.0,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.downsample_layers = nn.ModuleList(
            [nn.ModuleList([nn.Conv2d(3, dims[0], 4, 4), CastLayerNorm(dims[0], dtype)])]
            + [nn.ModuleList([CastLayerNorm(dims[i - 1], dtype),
                              nn.Conv2d(dims[i - 1], dims[i], 2, 2)]) for i in range(1, 4)])
        rates = drop_path_rates(drop_path_rate, depths)
        self.stages = nn.ModuleList(
            nn.ModuleList(ConvNeXtBlock(dims[i], dtype, rates[i][j]) for j in range(depths[i]))
            for i in range(4))
        for i in range(4):
            setattr(self, f"norm{i}", CastLayerNorm(dims[i], dtype))

    def blocks(self) -> List[ConvNeXtBlock]:
        return [blk for stage in self.stages for blk in stage]

    def drop_path_factors(self, batch: int, generator: torch.Generator,
                          device=None) -> torch.Tensor:
        """(blocks, batch) float32 drop-path factors at each block's rate."""
        return torch.stack([drop_path_factor(blk.drop_path_rate, batch, generator, device)
                            for blk in self.blocks()])

    def forward(self, x: torch.Tensor,
                factors: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        dt = self.dtype
        feats, k = [], 0
        for i, stage in enumerate(self.stages):
            if i == 0:
                conv, norm = self.downsample_layers[0]
                x = norm(conv_nhwc(x, conv, "SAME", dt))
            else:
                norm, conv = self.downsample_layers[i]
                x = conv_nhwc(norm(x), conv, "SAME", dt)
            for blk in stage:
                x = blk(x, None if factors is None else factors[k])
                k += 1
            feats.append(getattr(self, f"norm{i}")(x))
        return feats


def _make_convnext(variant: str):
    def factory(dtype=torch.bfloat16):
        depths, dims, rate = CONVNEXT_SETTINGS[variant]
        return ConvNeXt(depths, dims, rate, dtype=dtype), list(dims)

    return factory


for _v in CONVNEXT_SETTINGS:
    register_backbone(f"convnext_{_v}")(_make_convnext(_v))
