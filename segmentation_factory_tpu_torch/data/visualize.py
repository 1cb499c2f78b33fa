"""Palettes for label maps: the port's copy of
``segmentation_factory_tpu/data/visualize.py`` ``random_palette`` (:17-19)."""

from __future__ import annotations

import numpy as np


def random_palette(num_classes: int, seed: int = 0) -> np.ndarray:
    """(num_classes, 3) uint8 colours drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, (num_classes, 3)).astype(np.uint8)
