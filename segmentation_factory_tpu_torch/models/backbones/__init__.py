from segmentation_factory_tpu_torch.models.backbones import (  # noqa: F401  (registration)
    casvit,
    convnext,
    convnextv2,
    crossformer,
    efficientvit,
    iformer,
    kat,
    metaformer,
    mit,
    mobilenet,
    mobilenetv4,
    resnet,
)
