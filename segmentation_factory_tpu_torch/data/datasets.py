"""Dataset manifests: ``load(i)`` gives (image uint8 (H, W, 3), label int32
(H, W)) with labels already encoded to train ids.

The port's copy of ``segmentation_factory_tpu/data/datasets.py``:
``SegDataset`` (:44-66), ``Synthetic`` (:454-488), ``DATASETS`` and
``build_dataset`` (:492-505), and the class names and palettes of the
file-backed datasets (Cityscapes :79-98, VOC :123-135 and :211-217, ADE20K
and COCO-Stuff from ``class_names``, Kvasir :347-348, Synapse :403-420).
Those datasets (Cityscapes, VOC, ADE20K, COCO-Stuff, Kvasir + CVC-ClinicDB,
Synapse) read image files that are not in the repository, with decoders
the port does not have yet (JPEG, ``.h5``); they are not ported, and
``build_dataset`` raises for them. Their entries in ``DATASETS`` keep their
class counts, names and palettes, for the predictor's overlays and tables.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from segmentation_factory_tpu_torch.data import class_names
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


def voc_colormap(n: int = 256) -> np.ndarray:
    """The VOC palette: bit i of each of r, g, b from bits 3j .. 3j + 2 of
    the index."""
    cmap = np.zeros((n, 3), dtype=np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = [r, g, b]
    return cmap


def _not_ported(name: str, classes, palette):
    """A dataset that raises when it is built, carrying its metadata."""

    class NotPorted(SegDataset):
        CLASSES = tuple(classes)
        PALETTE = palette

        def __init__(self, *args, **kwargs):
            raise NotImplementedError(
                f"dataset {name!r} is not ported: its images are files this port does not "
                "read yet; use 'synthetic'")

    NotPorted.__name__ = NotPorted.__qualname__ = f"{name}_not_ported"
    return NotPorted


CITYSCAPES_CLASSES = (
    "road", "sidewalk", "building", "wall", "fence", "pole", "traffic light",
    "traffic sign", "vegetation", "terrain", "sky", "person", "rider", "car", "truck", "bus",
    "train", "motorcycle", "bicycle",
)
CITYSCAPES_PALETTE = np.asarray(
    [[128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156], [190, 153, 153],
     [153, 153, 153], [250, 170, 30], [220, 220, 0], [107, 142, 35], [152, 251, 152],
     [70, 130, 180], [220, 20, 60], [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100],
     [0, 80, 100], [0, 0, 230], [119, 11, 32]], dtype=np.uint8)
VOC_CLASSES = (
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person", "pottedplant",
    "sheep", "sofa", "train", "tvmonitor",
)
KVASIR_CLASSES = ("background", "polyp")
KVASIR_PALETTE = np.asarray([[0, 0, 0], [255, 255, 255]], dtype=np.uint8)
SYNAPSE_CLASSES = ("background", "aorta", "gallbladder", "kidney_l", "kidney_r", "liver",
                   "pancreas", "spleen", "stomach")

DATASETS = {
    "cityscapes": (_not_ported("cityscapes", CITYSCAPES_CLASSES, CITYSCAPES_PALETTE), 19),
    "voc": (_not_ported("voc", VOC_CLASSES, voc_colormap()[:21]), 21),
    "ade20k": (_not_ported("ade20k", class_names.ADE20K_CLASSES,
                           class_names.ADE20K_PALETTE), 150),
    "cocostuff": (_not_ported("cocostuff", class_names.COCOSTUFF_CLASSES,
                              class_names.COCOSTUFF_PALETTE), 171),
    "kvasir": (_not_ported("kvasir", KVASIR_CLASSES, KVASIR_PALETTE), 2),
    "synapse": (_not_ported("synapse", SYNAPSE_CLASSES, random_palette(9, seed=2)), 9),
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
