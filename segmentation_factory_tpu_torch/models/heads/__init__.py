from segmentation_factory_tpu_torch.models.heads import (  # noqa: F401  (registration)
    fpn,
    mask2former,
    segformer,
    upernet,
)
