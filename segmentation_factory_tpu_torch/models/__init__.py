from segmentation_factory_tpu_torch.models.build import (
    SegmentationModel,
    build_model,
    default_embed_dim,
)

__all__ = ["SegmentationModel", "build_model", "default_embed_dim"]
