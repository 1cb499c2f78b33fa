from segmentation_factory_tpu_torch.models.backbones import (  # noqa: F401  (registration)
    casvit,
    convnext,
    convnextv2,
    efficientvit,
    metaformer,
    mit,
    mobilenet,
    mobilenetv4,
    resnet,
)
