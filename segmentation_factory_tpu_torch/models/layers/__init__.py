from segmentation_factory_tpu_torch.models.layers.common import (
    drop_path,
    drop_path_factor,
    drop_path_rates,
    ln_apply,
    resize,
)
from segmentation_factory_tpu_torch.models.layers.norm import (
    BatchNorm,
    LayerNorm,
    batch_norm_eval,
    batch_norm_train,
)

__all__ = [
    "BatchNorm",
    "LayerNorm",
    "batch_norm_eval",
    "batch_norm_train",
    "drop_path",
    "drop_path_factor",
    "drop_path_rates",
    "ln_apply",
    "resize",
]
