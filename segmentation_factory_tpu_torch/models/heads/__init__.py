from segmentation_factory_tpu_torch.models.heads import segformer  # noqa: F401  (registers segformerhead)
