"""Paired image/label transforms: geometric on the host, photometric on the
device.

The port's copy of ``segmentation_factory_tpu/data/transforms.py``: ImageNet
normalization (:31-32, ``normalize`` :266-270), ``synapse_train_augment``
(:95-127, its rotation ``random_rotation`` :56-92 inlined as the one use the
recipe makes of it), ``kvasir_train_augment`` (:130-172),
``draw_scale_crop_params`` (:185-200), ``random_scale_crop`` (:203-252) and
``center_pad_to`` (:255-263) on numpy arrays in the host loader, and
``augment_batch`` (:273-338) and ``preprocess_eval`` (:340) on device
tensors. The scale-crop, the rotation and the recipes' resizes run in the
host transform engine (``native``; the resizes on its copies of PIL's
bilinear, bicubic and nearest rules); there is no PIL path.
``augment_batch`` takes its random draws as an input (``draw_augment`` makes
them from a ``torch.Generator``), so a test can hand it the draws the JAX
function makes from its key.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from segmentation_factory_tpu_torch.data import native

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)
LUMA = (0.299, 0.587, 0.114)  # ITU-R 601


def normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8-scale float NHWC -> ImageNet-normalized."""
    mean = torch.as_tensor(IMAGENET_MEAN * 255.0, device=images.device)
    std = torch.as_tensor(IMAGENET_STD * 255.0, device=images.device)
    return (images - mean) / std


# ---------------------------------------------------------------- host, numpy


def draw_scale_crop_params(rng: np.random.Generator, h: int, w: int, crop: int,
                           scale_range: Tuple[float, float] = (0.5, 2.0)):
    """(scale, top, left) of one sample's random scale + crop, from ``rng``
    in the JAX package's order."""
    scale = rng.uniform(*scale_range)
    nh, nw = max(1, int(h * scale)), max(1, int(w * scale))
    top = int(rng.integers(0, max(nh - crop, 0) + 1))
    left = int(rng.integers(0, max(nw - crop, 0) + 1))
    return scale, top, left


def synapse_train_augment(img: np.ndarray, lbl: np.ndarray, rng: np.random.Generator,
                          out_hw: Tuple[int, int]):
    """The Synapse CT train recipe: with probability 1/2 a rot90 by k and a
    flip along a random axis, else with probability 1/2 a nearest-neighbour
    rotation in [-20, 20) degrees; then a zoom to ``out_hw`` (image bicubic,
    label nearest, as PIL resizes them). The draws from ``rng`` in the JAX
    function's order."""
    if rng.random() > 0.5:
        k = int(rng.integers(0, 4))
        img = np.rot90(img, k, axes=(0, 1))
        lbl = np.rot90(lbl, k, axes=(0, 1))
        axis = int(rng.integers(0, 2))
        img = np.flip(img, axis=axis)
        lbl = np.flip(lbl, axis=axis)
    elif rng.random() > 0.5:
        img, lbl = native.rotate_pair(img, lbl, float(rng.uniform(-20.0, 20.0)),
                                      nearest_img=True)
    if lbl.shape[:2] != tuple(out_hw):
        img = native.resize_bicubic_u8(img, out_hw)
        lbl = native.resize_nearest_pil_i32(lbl, out_hw)
    return np.ascontiguousarray(img), np.ascontiguousarray(lbl, np.int32)


def kvasir_train_augment(img: np.ndarray, lbl: np.ndarray, rng: np.random.Generator,
                         out_hw: Tuple[int, int], ignore_index: int = 255):
    """The Kvasir / ClinicDB polyp recipe (``KvasirClinicDB(preset_recipe=True)``):
    the short side resized to a uniform integer in [0.5, 1.2] x the crop
    (image by PIL's bilinear, label by PIL's nearest), a horizontal and a
    vertical flip each with probability 1/2, then a random crop padded where
    needed (image 0, label ``ignore_index``). The draws from ``rng`` in the
    JAX function's order."""
    crop = out_hw[0]
    short = int(rng.integers(int(0.5 * crop), int(1.2 * crop) + 1))
    h, w = img.shape[:2]
    scale = short / min(h, w)
    hw = (max(1, int(h * scale)), max(1, int(w * scale)))
    img = native.resize_image(img, hw)
    lbl = native.resize_nearest_pil_i32(lbl, hw)
    if rng.random() < 0.5:
        img, lbl = img[:, ::-1], lbl[:, ::-1]
    if rng.random() < 0.5:
        img, lbl = img[::-1], lbl[::-1]
    ph, pw = max(crop - img.shape[0], 0), max(crop - img.shape[1], 0)
    if ph or pw:
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)), constant_values=0)
        lbl = np.pad(lbl, ((0, ph), (0, pw)), constant_values=ignore_index)
    top = int(rng.integers(0, img.shape[0] - crop + 1))
    left = int(rng.integers(0, img.shape[1] - crop + 1))
    return (np.ascontiguousarray(img[top:top + crop, left:left + crop]),
            np.ascontiguousarray(lbl[top:top + crop, left:left + crop], np.int32))


def random_scale_crop(img: np.ndarray, lbl: np.ndarray, crop: int,
                      scale_range: Tuple[float, float] = (0.5, 2.0), ignore_index: int = 255,
                      rng: Optional[np.random.Generator] = None):
    """Random scale, random crop, pad to ``crop`` x ``crop`` (image 0, label
    ``ignore_index``), fused in the host engine."""
    rng = rng or np.random.default_rng()
    h, w = img.shape[:2]
    scale, top, left = draw_scale_crop_params(rng, h, w, crop, scale_range)
    oi, ol = native.batch_scale_crop(img[None], lbl[None].astype(np.int32),
                                     np.asarray([scale], np.float32), np.asarray([top], np.int32),
                                     np.asarray([left], np.int32), crop, ignore_index,
                                     num_threads=1)
    return oi[0], ol[0]


def center_pad_to(img: np.ndarray, lbl: np.ndarray, hw: Tuple[int, int], ignore_index=255):
    """Pad bottom/right to the eval canvas ``hw`` (image 0, label
    ``ignore_index``, so padding never reaches the confusion matrix), then
    cut to it."""
    h, w = hw
    ph, pw = max(h - img.shape[0], 0), max(w - img.shape[1], 0)
    img = np.pad(img, ((0, ph), (0, pw), (0, 0)), constant_values=0)
    lbl = np.pad(lbl, ((0, ph), (0, pw)), constant_values=ignore_index)
    return img[:h, :w], lbl[:h, :w]


# ---------------------------------------------------------------- device, torch


def draw_augment(generator: torch.Generator, batch: int, hflip: bool = True,
                 vflip: bool = False, color_jitter: float = 0.5) -> Dict[str, torch.Tensor]:
    """The random draws of ``augment_batch`` for ``batch`` images, on the
    generator's device: ``hflip`` / ``vflip`` (B,) bool (probability 0.5),
    ``brightness`` / ``contrast`` / ``saturation`` (B,) factors uniform in
    [1 - j, 1 + j], ``order`` (B, 3) a permutation of the three jitter ops
    (0 brightness, 1 contrast, 2 saturation) per image. Keys of disabled
    ops are absent."""
    dev = generator.device
    out = {}
    if hflip:
        out["hflip"] = torch.rand(batch, generator=generator, device=dev) < 0.5
    if vflip:
        out["vflip"] = torch.rand(batch, generator=generator, device=dev) < 0.5
    if color_jitter > 0:
        for key in ("brightness", "contrast", "saturation"):
            u = torch.rand(batch, generator=generator, device=dev)
            out[key] = (1 - color_jitter) + 2 * color_jitter * u
        out["order"] = torch.argsort(torch.rand((batch, 3), generator=generator, device=dev), 1)
    return out


def augment_batch(images_u8: torch.Tensor, labels: torch.Tensor, draws: Dict[str, torch.Tensor]):
    """Per-image horizontal / vertical flips, then brightness, contrast and
    saturation jitter in the per-image order ``draws["order"]``
    (torchvision ColorJitter semantics: blend toward black, the grey mean
    of the image and the per-pixel luma, clipped to [0, 255]), then
    normalize. (B, H, W, 3) uint8 and (B, H, W) labels on one device ->
    (float32 normalized images, labels)."""
    img = images_u8.float()
    for key, axis in (("hflip", 2), ("vflip", 1)):
        if key in draws:
            do = draws[key]
            img = torch.where(do[:, None, None, None], img.flip(axis), img)
            labels = torch.where(do[:, None, None], labels.flip(axis), labels)
    if "order" in draws:
        br, ct, st = (draws[k].float()[:, None, None, None]
                      for k in ("brightness", "contrast", "saturation"))
        luma = torch.tensor(LUMA, device=img.device)

        def ops(x):
            gray = (x @ luma)[..., None]
            return (torch.clamp(x * br, 0.0, 255.0),
                    torch.clamp(x * ct + gray.mean((1, 2), keepdim=True) * (1.0 - ct), 0.0,
                                255.0),
                    torch.clamp(x * st + gray * (1.0 - st), 0.0, 255.0))

        order = draws["order"]
        for step in range(3):
            o = order[:, step][:, None, None, None]
            bright, contrast, sat = ops(img)
            img = torch.where(o == 0, bright, torch.where(o == 1, contrast, sat))
    return normalize(img), labels


def preprocess_eval(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 images -> float32 normalized."""
    return normalize(images_u8.float())
