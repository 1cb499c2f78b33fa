from segmentation_factory_tpu_torch.models.backbones import (  # noqa: F401  (registration)
    convnext,
    mit,
    mobilenetv4,
)
