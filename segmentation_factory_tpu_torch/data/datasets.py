"""Dataset manifests: each is a list of (image path, label path) pairs and a
``load(i)`` that gives (image uint8 (H, W, 3), label int32 (H, W)) with
labels already encoded to train ids.

The port's copy of ``segmentation_factory_tpu/data/datasets.py``: the
readers ``imread`` / ``maskread`` (its ``_imread`` / ``_maskread``, :32-38), ``SegDataset`` (:44-66),
``Cityscapes`` (:67-120), ``VOCSegmentation`` (:106-279, without
``download_voc``: the machine with the card has no network), ``ADE20K``
(:282-306), ``COCOStuff`` (:312-340), ``KvasirClinicDB`` (:346-388),
``SynapseCT`` (:394-451), ``Synthetic`` (:454-488), ``DATASETS`` and
``build_dataset`` (:492-505). Files are read without PIL or h5py, by
their first bytes as PIL opens them: PNG by ``data/png.py``, JPEG (VOC,
ADE20K, COCO-Stuff and Kvasir-SEG images, Kvasir-SEG masks) by
``data/jpeg.py``, Synapse's ``.npy.h5`` volumes by ``data/hdf5.py``, its
``.npz`` slices by numpy. Any other format raises "not ported".
"""

from __future__ import annotations

import glob
import os
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np

from segmentation_factory_tpu_torch.data import class_names, hdf5, jpeg, png
from segmentation_factory_tpu_torch.data.transforms import (kvasir_train_augment,
                                                             synapse_train_augment)
from segmentation_factory_tpu_torch.data.visualize import random_palette


def _reader(path: str):
    """(raw read, RGB read) of the module that decodes the file at ``path``,
    chosen by its first bytes (PIL opens a file by its content, whatever its
    name)."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == png.SIGNATURE:
        return png.read_png, png.read_rgb
    if head.startswith(jpeg.SIGNATURE):
        return jpeg.read_jpeg, jpeg.read_rgb
    raise NotImplementedError(f"{path}: an image format other than PNG and JPEG is not ported")


def imread(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB, as ``Image.open(path).convert("RGB")``."""
    return _reader(path)[1](path)


def maskread(path: str) -> np.ndarray:
    """The label map as int32, as ``np.asarray(Image.open(path), np.int32)``:
    in the file's own mode (a 3-component JPEG mask gives (H, W, 3))."""
    return _reader(path)[0](path).astype(np.int32)


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

    def encode_label(self, lbl: np.ndarray) -> np.ndarray:
        return lbl

    def load(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        img_path, lbl_path = self.pairs[i]
        return imread(img_path), self.encode_label(maskread(lbl_path))


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


# Cityscapes: the 34 label ids -> 19 train ids (255 = ignore)
_CITYSCAPES_ID_TO_TRAIN = np.full(256, 255, dtype=np.int32)
for _id, _tid in [(7, 0), (8, 1), (11, 2), (12, 3), (13, 4), (17, 5), (19, 6), (20, 7), (21, 8),
                  (22, 9), (23, 10), (24, 11), (25, 12), (26, 13), (27, 14), (28, 15),
                  (31, 16), (32, 17), (33, 18)]:
    _CITYSCAPES_ID_TO_TRAIN[_id] = _tid


class Cityscapes(SegDataset):
    """``leftImg8bit/<split>/<city>/*_leftImg8bit.png`` paired with
    ``gtFine/<split>/<city>/*_gtFine_labelIds.png``, label ids mapped to
    train ids."""

    CLASSES = (
        "road", "sidewalk", "building", "wall", "fence", "pole", "traffic light",
        "traffic sign", "vegetation", "terrain", "sky", "person", "rider", "car", "truck",
        "bus", "train", "motorcycle", "bicycle",
    )
    PALETTE = np.asarray(
        [[128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156], [190, 153, 153],
         [153, 153, 153], [250, 170, 30], [220, 220, 0], [107, 142, 35], [152, 251, 152],
         [70, 130, 180], [220, 20, 60], [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100],
         [0, 80, 100], [0, 0, 230], [119, 11, 32]], dtype=np.uint8)

    def __init__(self, root: str, split: str = "train"):
        super().__init__()
        img_dir = os.path.join(root, "leftImg8bit", split)
        lbl_dir = os.path.join(root, "gtFine", split)
        for img_path in sorted(glob.glob(os.path.join(img_dir, "*", "*_leftImg8bit.png"))):
            city = os.path.basename(os.path.dirname(img_path))
            base = os.path.basename(img_path).replace("_leftImg8bit.png", "_gtFine_labelIds.png")
            self.pairs.append((img_path, os.path.join(lbl_dir, city, base)))

    def encode_label(self, lbl: np.ndarray) -> np.ndarray:
        return _CITYSCAPES_ID_TO_TRAIN[np.clip(lbl, 0, 255)]


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


class VOCSegmentation(SegDataset):
    """VOC 2012 under ``VOCdevkit/VOC2012`` (or ``root`` itself): the
    ``ImageSets/Segmentation/<split>.txt`` list, or with ``year`` ending in
    "aug" and ``SegmentationClassAug`` present the 10582-image
    ``train_aug.txt`` (searched in three places; lines of a bare name or
    of "image-path mask-path")."""

    CLASSES = (
        "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
        "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person", "pottedplant",
        "sheep", "sofa", "train", "tvmonitor",
    )
    PALETTE = voc_colormap()[:21]

    def __init__(self, root: str, split: str = "train", year: str = "2012_aug"):
        super().__init__()
        base = os.path.join(root, "VOCdevkit", "VOC2012")
        if not os.path.isdir(base):
            base = root  # pointed straight at the VOC2012 directory
        aug = year.endswith("aug")
        mask_dir = os.path.join(base, "SegmentationClassAug" if aug else "SegmentationClass")
        if aug and not os.path.isdir(mask_dir):
            aug = False
            mask_dir = os.path.join(base, "SegmentationClass")
        split_file = os.path.join(base, "ImageSets", "Segmentation", f"{split}.txt")
        if aug and split == "train":
            candidates = [os.path.join(base, "ImageSets", "Segmentation", "train_aug.txt"),
                          os.path.join(base, "train_aug.txt"), os.path.join(root, "train_aug.txt")]
            found = next((c for c in candidates if os.path.isfile(c)), None)
            if found is None:
                import warnings

                warnings.warn("SegmentationClassAug present but train_aug.txt not found; "
                              "falling back to the 1464-image train.txt list")
            split_file = found or split_file
        names = []
        with open(split_file) as f:
            for ln in f:
                tok = ln.split()[0] if ln.strip() else ""
                if not tok:
                    continue
                if "/" in tok:
                    tok = os.path.splitext(os.path.basename(tok))[0]
                names.append(tok)
        self.pairs = [(os.path.join(base, "JPEGImages", n + ".jpg"),
                       os.path.join(mask_dir, n + ".png")) for n in names]


def _images_and_annotations(root: str, split: str) -> List[Tuple[str, str]]:
    """``images/<split>/*.jpg`` paired with ``annotations/<split>/*.png``."""
    ann_dir = os.path.join(root, "annotations", split)
    return [(p, os.path.join(ann_dir, os.path.splitext(os.path.basename(p))[0] + ".png"))
            for p in sorted(glob.glob(os.path.join(root, "images", split, "*.jpg")))]


class ADE20K(SegDataset):
    """ADEChallengeData2016: labels 1..150 -> train ids 0..149, 0 (void)
    -> 255."""

    CLASSES = class_names.ADE20K_CLASSES
    PALETTE = class_names.ADE20K_PALETTE

    def __init__(self, root: str, split: str = "training"):
        super().__init__()
        split = {"train": "training", "val": "validation"}.get(split, split)
        self.pairs = _images_and_annotations(root, split)

    def encode_label(self, lbl: np.ndarray) -> np.ndarray:
        out = lbl.astype(np.int32) - 1
        out[out < 0] = 255
        return out


_COCO_UNUSED = (11, 25, 28, 29, 44, 65, 67, 68, 70, 82, 90)  # thing ids absent from COCO


def _coco_label_map() -> np.ndarray:
    """The 182 COCO-Stuff ids -> 171 train ids, the unused ones and 182-255
    to 255."""
    lut = np.full(256, 255, dtype=np.int32)
    kept = [i for i in range(182) if i not in _COCO_UNUSED]
    lut[kept] = np.arange(len(kept))
    return lut


class COCOStuff(SegDataset):
    """COCO-Stuff 171: ``images/<split>/*.jpg`` and
    ``annotations/<split>/*.png``, ids mapped by ``_coco_label_map``."""

    CLASSES = class_names.COCOSTUFF_CLASSES
    PALETTE = class_names.COCOSTUFF_PALETTE

    def __init__(self, root: str, split: str = "train2017"):
        super().__init__()
        split = {"train": "train2017", "val": "val2017"}.get(split, split)
        self.pairs = _images_and_annotations(root, split)
        self._lut = _coco_label_map()

    def encode_label(self, lbl: np.ndarray) -> np.ndarray:
        return self._lut[np.clip(lbl, 0, 255)]


class KvasirClinicDB(SegDataset):
    """Kvasir-SEG (``images/*.jpg``, ``masks/*.jpg``) and CVC-ClinicDB
    (``images/*.png``, ``masks/*.png``), split by a seeded shuffle:
    ``val_frac`` of the pairs to val. Masks binarised at 127. With
    ``preset_recipe`` the train split takes the polyp recipe
    (``transforms.kvasir_train_augment``) as its ``train_augment``."""

    CLASSES = ("background", "polyp")
    PALETTE = np.asarray([[0, 0, 0], [255, 255, 255]], dtype=np.uint8)

    def __init__(self, root: str, split: str = "train", val_frac: float = 0.2, seed: int = 0,
                 preset_recipe: bool = False):
        super().__init__()
        if preset_recipe:
            self.train_augment = lambda img, lbl, rng, out_hw: kvasir_train_augment(
                img, lbl, rng, out_hw, self.ignore_index)
        pairs = []
        for sub, ext in (("Kvasir-SEG", "jpg"), ("CVC-ClinicDB", "png")):
            d = os.path.join(root, sub)
            if os.path.isdir(d):
                pairs += [(p, os.path.join(d, "masks", os.path.basename(p)))
                          for p in sorted(glob.glob(os.path.join(d, "images", f"*.{ext}")))]
        idx = list(range(len(pairs)))
        random.Random(seed).shuffle(idx)
        n_val = int(len(pairs) * val_frac)
        keep = set(idx[:n_val]) if split == "val" else set(idx[n_val:])
        self.pairs = [pairs[i] for i in sorted(keep)]

    def encode_label(self, lbl: np.ndarray) -> np.ndarray:
        if lbl.ndim == 3:
            lbl = lbl[..., 0]
        return (lbl > 127).astype(np.int32)


class SynapseCT(SegDataset):
    """Synapse multi-organ CT under ``root``: ``lists/train.txt`` names the
    train slices ``train_npz/<name>.npz`` ({"image": (H, W) float in [0, 1],
    "label": (H, W)}); ``lists/test_vol.txt`` names the val cases
    ``test_vol_h5/<name>.npy.h5`` ("image" and "label" (D, H, W)). A train
    slice loads as uint8 (the image times 255, clipped, truncated) repeated
    to 3 channels; the val split is volumetric (``volumes()``)."""

    CLASSES = ("background", "aorta", "gallbladder", "kidney_l", "kidney_r", "liver",
               "pancreas", "spleen", "stomach")
    PALETTE = random_palette(9, seed=2)

    def __init__(self, root: str, split: str = "train", list_dir: Optional[str] = None):
        super().__init__()
        self.root = root
        self.split = split
        list_dir = list_dir or os.path.join(root, "lists")
        name = "train" if split == "train" else "test_vol"
        with open(os.path.join(list_dir, f"{name}.txt")) as f:
            self.names = [ln.strip() for ln in f if ln.strip()]
        self.pairs = [(n, n) for n in self.names]

    def load(self, i: int):
        if self.split != "train":
            raise IndexError("val split is volumetric; use volumes()")
        d = np.load(os.path.join(self.root, "train_npz", self.names[i] + ".npz"))
        img = np.clip(d["image"].astype(np.float32) * 255.0, 0, 255).astype(np.uint8)
        return np.repeat(img[..., None], 3, axis=-1), d["label"].astype(np.int32)

    def train_augment(self, img, lbl, rng, out_hw):
        """The Synapse train recipe (``transforms.synapse_train_augment``)."""
        return synapse_train_augment(img, lbl, rng, out_hw)

    def volumes(self):
        """Yield (name, image (D, H, W) float32, label (D, H, W) int32) per
        case."""
        for name in self.names:
            path = os.path.join(self.root, "test_vol_h5", name + ".npy.h5")
            yield (name, hdf5.read_dataset(path, "image"),
                   hdf5.read_dataset(path, "label").astype(np.int32))


DATASETS = {
    "cityscapes": (Cityscapes, 19),
    "voc": (VOCSegmentation, 21),
    "ade20k": (ADE20K, 150),
    "cocostuff": (COCOStuff, 171),
    "kvasir": (KvasirClinicDB, 2),
    "synapse": (SynapseCT, 9),
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
