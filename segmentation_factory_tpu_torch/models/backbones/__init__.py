from segmentation_factory_tpu_torch.models.backbones import mit  # noqa: F401  (registers mit_b0..b5)
