from segmentation_factory_tpu_torch.data.transforms import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    normalize,
)

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "normalize"]
