from segmentation_factory_tpu_torch.models.layers.act import build_act
from segmentation_factory_tpu_torch.models.layers.common import (
    drop_path,
    drop_path_factor,
    drop_path_rates,
    ln_apply,
    resize,
    resize_align_corners,
    resize_like,
    resize_nearest_legacy,
    resize_torch_bicubic,
)
from segmentation_factory_tpu_torch.models.layers.conv import (
    ConvModule,
    SqueezeExcite,
    conv_bn_act,
    conv_nhwc,
    same_pads,
)
from segmentation_factory_tpu_torch.models.layers.norm import (
    BatchNorm,
    GRN,
    CastLayerNorm,
    GroupNorm,
    LayerNorm,
    batch_norm_eval,
    batch_norm_train,
)

__all__ = [
    "BatchNorm",
    "CastLayerNorm",
    "ConvModule",
    "GRN",
    "GroupNorm",
    "SqueezeExcite",
    "LayerNorm",
    "batch_norm_eval",
    "batch_norm_train",
    "build_act",
    "conv_bn_act",
    "conv_nhwc",
    "drop_path",
    "drop_path_factor",
    "drop_path_rates",
    "ln_apply",
    "resize",
    "resize_align_corners",
    "resize_like",
    "resize_nearest_legacy",
    "resize_torch_bicubic",
    "same_pads",
]
