from segmentation_factory_tpu_torch.models.layers.common import (
    ln_apply,
    resize,
)
from segmentation_factory_tpu_torch.models.layers.norm import (
    BatchNorm,
    LayerNorm,
    batch_norm_eval,
)

__all__ = [
    "BatchNorm",
    "LayerNorm",
    "batch_norm_eval",
    "ln_apply",
    "resize",
]
