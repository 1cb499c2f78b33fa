"""ImageNet normalization, own copy of
``segmentation_factory_tpu/data/transforms.py`` (:31-32, ``normalize`` :266-270)."""

from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8-scale float NHWC -> ImageNet-normalized."""
    mean = torch.as_tensor(IMAGENET_MEAN * 255.0, device=images.device)
    std = torch.as_tensor(IMAGENET_STD * 255.0, device=images.device)
    return (images - mean) / std
