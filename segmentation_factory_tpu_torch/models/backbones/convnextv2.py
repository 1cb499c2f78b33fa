"""ConvNeXtV2 backbones (atto to huge).

Port of ``segmentation_factory_tpu/models/backbones/convnextv2.py``: the
ConvNeXt of ``convnext.py`` with ``use_grn`` (GRN after the block's GELU,
no layer scale), at the eight variants' depths and widths and their
drop-path rates (``convnextv2.py:17-51``). No TPU kernel is on this path.
"""

from __future__ import annotations

import torch

from segmentation_factory_tpu_torch.models.backbones.convnext import ConvNeXt
from segmentation_factory_tpu_torch.registry import register_backbone

CONVNEXTV2_SETTINGS = {
    # name: (depths, dims, drop_path_rate)
    "atto": ([2, 2, 6, 2], [40, 80, 160, 320], 0.0),
    "femto": ([2, 2, 6, 2], [48, 96, 192, 384], 0.0),
    "pico": ([2, 2, 6, 2], [64, 128, 256, 512], 0.0),
    "nano": ([2, 2, 8, 2], [80, 160, 320, 640], 0.0),
    "tiny": ([3, 3, 9, 3], [96, 192, 384, 768], 0.1),
    "base": ([3, 3, 27, 3], [128, 256, 512, 1024], 0.4),
    "large": ([3, 3, 27, 3], [192, 384, 768, 1536], 0.5),
    "huge": ([3, 3, 27, 3], [352, 704, 1408, 2816], 0.5),
}


def _make_convnextv2(variant: str):
    def factory(dtype=torch.bfloat16, img_size: int = 512):
        depths, dims, rate = CONVNEXTV2_SETTINGS[variant]
        return ConvNeXt(depths, dims, rate, dtype=dtype, use_grn=True), list(dims)

    return factory


for _v in CONVNEXTV2_SETTINGS:
    register_backbone(f"convnextv2_{_v}")(_make_convnextv2(_v))
