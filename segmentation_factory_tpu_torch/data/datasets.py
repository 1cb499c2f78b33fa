"""Dataset manifests: ``load(i)`` gives (image uint8 (H, W, 3), label int32
(H, W)) with labels already encoded to train ids.

The port's copy of ``segmentation_factory_tpu/data/datasets.py``:
``SegDataset`` (:44-66), ``Synthetic`` (:454-488), ``DATASETS`` and
``build_dataset`` (:492-505). The file-backed datasets (Cityscapes, VOC,
ADE20K, COCO-Stuff, Kvasir + CVC-ClinicDB, Synapse) read image files that
are not in the repository, and their decoders need PIL; they are not ported
yet and ``build_dataset`` raises for them, with their class counts kept.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from segmentation_factory_tpu_torch.data.visualize import random_palette


class SegDataset:
    """Base manifest: ``pairs`` and class metadata."""

    CLASSES: Sequence[str] = ()
    PALETTE: Optional[np.ndarray] = None  # (C, 3) uint8
    ignore_index: int = 255

    def __init__(self):
        self.pairs: List[Tuple[str, str]] = []

    @property
    def num_classes(self) -> int:
        return len(self.CLASSES)

    def __len__(self) -> int:
        return len(self.pairs)

    def load(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError


class Synthetic(SegDataset):
    """Procedural blobs: learnable in a few steps, no I/O. Sample ``i`` is
    drawn from ``seed * 100003 + i``: class-k discs on a background of class
    0, grey levels by class plus N(0, 8) noise."""

    def __init__(self, num_classes: int = 8, size: int = 512, length: int = 64, seed: int = 0):
        super().__init__()
        self.CLASSES = tuple(f"class_{i}" for i in range(num_classes))
        self._size = size
        self._seed = seed
        self.pairs = [(str(i), str(i)) for i in range(length)]
        self.PALETTE = random_palette(num_classes, seed=3)

    def load(self, i: int):
        rng = np.random.default_rng(self._seed * 100003 + i)
        s, c = self._size, self.num_classes
        yy, xx = np.mgrid[0:s, 0:s]
        lbl = np.zeros((s, s), np.int32)
        for k in range(1, c):
            cy, cx = rng.integers(0, s, 2)
            r = rng.integers(s // 16, s // 4)
            lbl[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = k
        img = (lbl[..., None] * (255 // max(c - 1, 1))).astype(np.float32)
        img = img + rng.normal(0, 8, (s, s, 3))
        return np.clip(img, 0, 255).astype(np.uint8), lbl


def _not_ported(name: str):
    def make(*args, **kwargs):
        raise NotImplementedError(
            f"dataset {name!r} is not ported: its images are files this port does not "
            "read yet; use 'synthetic'")
    return make


DATASETS = {
    "cityscapes": (_not_ported("cityscapes"), 19),
    "voc": (_not_ported("voc"), 21),
    "ade20k": (_not_ported("ade20k"), 150),
    "cocostuff": (_not_ported("cocostuff"), 171),
    "kvasir": (_not_ported("kvasir"), 2),
    "synapse": (_not_ported("synapse"), 9),
    "synthetic": (Synthetic, 8),
}


def build_dataset(name: str, root: str, split: str, **kwargs) -> SegDataset:
    """The dataset ``name`` (``DATASETS``) for ``split``; ``synthetic``
    takes only ``kwargs``. Raises KeyError for an unknown name."""
    key = name.lower()
    if key not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; available: {sorted(DATASETS)}")
    cls, n_classes = DATASETS[key]
    if key == "synthetic":
        return cls(**kwargs)
    ds = cls(root, split=split, **kwargs)
    if ds.num_classes != n_classes:
        raise ValueError(f"{name}: expected {n_classes} classes, manifest has {ds.num_classes}")
    return ds
