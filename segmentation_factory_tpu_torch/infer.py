"""Inference: the whole-image predictor, sliding-window and multi-scale +
flip logits.

Port of ``segmentation_factory_tpu/infer.py`` ``preprocess``,
``postprocess``, ``colorize``, ``overlay`` and ``SemSeg`` (:31-60,
:290-360), ``slide_inference`` / ``_slide_impl`` (:71-147) and
``multi_scale_flip_inference`` (:210-237) and ``evaluate_volumes``
(:240-287, Synapse's per-case protocol): the same window grid, overlap
averaging and float32 softmax averaging, eager (no per-shape compiled
program to cache). Resizes of logits are the port's ``resize`` (half-pixel,
no antialias). ``preprocess`` resizes the uint8 image with the host engine's
copy of PIL's ``BILINEAR`` (``data/native.py`` ``resize_image``), which the
JAX function calls, so both give the same bytes. ``SemSeg`` takes its
weights as a ``state_dict`` (a ``torch.load`` of a reference-layout ``.pt``,
or ``convert.from_jax_variables``) or from a directory of the port's
checkpoints (``checkpoint.py``); orbax checkpoints need JAX and are not read
here.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from segmentation_factory_tpu_torch.checkpoint import CheckpointManager
from segmentation_factory_tpu_torch.data import native
from segmentation_factory_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD, normalize
from segmentation_factory_tpu_torch.metrics import dice_per_case
from segmentation_factory_tpu_torch.models.build import build_model
from segmentation_factory_tpu_torch.models.layers import resize


def preprocess(image_u8: np.ndarray, img_size: int, divisor: int = 32):
    """Short side scaled to ``img_size``, both sides ceiled to a multiple
    of ``divisor``, resized as PIL's ``BILINEAR`` resizes it, normalized.
    Returns ((1, H, W, 3) float32 numpy, orig_hw)."""
    h, w = image_u8.shape[:2]
    scale = img_size / min(h, w)
    nh = int(math.ceil(h * scale / divisor) * divisor)
    nw = int(math.ceil(w * scale / divisor) * divisor)
    if (nh, nw) != (h, w):
        image_u8 = native.resize_image(image_u8, (nh, nw))
    img = (image_u8.astype(np.float32) - IMAGENET_MEAN * 255.0) / (IMAGENET_STD * 255.0)
    return img[None], (h, w)


def postprocess(logits: torch.Tensor, orig_hw: Tuple[int, int]) -> np.ndarray:
    """Logits resized to the original size, argmax of the first image."""
    seg = resize(logits.float(), orig_hw).argmax(-1)[0]
    return seg.to(torch.int32).cpu().numpy()


def colorize(seg: np.ndarray, palette: np.ndarray) -> np.ndarray:
    return palette[np.clip(seg, 0, len(palette) - 1)]


def overlay(image_u8: np.ndarray, seg_rgb: np.ndarray, alpha: float = 0.6) -> np.ndarray:
    """alpha * seg + (1 - alpha) * image."""
    out = (1 - alpha) * image_u8.astype(np.float32) + alpha * seg_rgb.astype(np.float32)
    return np.clip(out, 0, 255).astype(np.uint8)


def slide_inference(forward: Callable[[torch.Tensor], torch.Tensor], image: torch.Tensor,
                    num_classes: int, crop: int, stride: Optional[int] = None) -> torch.Tensor:
    """Logits (B, H, W, num_classes) float32 of ``forward`` over
    ``crop``-sized windows of the normalized ``image`` (B, H, W, 3), every
    ``stride`` pixels (default 2/3 of ``crop``; the last window flush with
    the edge), averaged where windows overlap. An image that fits one
    window is one forward."""
    stride = stride or (crop * 2) // 3
    b, h, w, _ = image.shape
    if h <= crop and w <= crop:
        return forward(image)
    rows = max(math.ceil((h - crop) / stride) + 1, 1)
    cols = max(math.ceil((w - crop) / stride) + 1, 1)
    logits = torch.zeros((b, h, w, num_classes), dtype=torch.float32, device=image.device)
    count = torch.zeros((b, h, w, 1), dtype=torch.float32, device=image.device)
    ch, cw = min(crop, h), min(crop, w)
    for r in range(rows):
        for c in range(cols):
            y0 = min(r * stride, max(h - crop, 0))
            x0 = min(c * stride, max(w - crop, 0))
            out = forward(image[:, y0:y0 + ch, x0:x0 + cw]).float()
            logits[:, y0:y0 + ch, x0:x0 + cw] += out
            count[:, y0:y0 + ch, x0:x0 + cw] += 1.0
    return logits / count.clamp_min(1.0)


def multi_scale_flip_inference(forward: Callable[[torch.Tensor], torch.Tensor],
                               image: torch.Tensor, num_classes: int,
                               scales: Sequence[float] = (0.5, 0.75, 1.0, 1.25, 1.5, 1.75),
                               flip: bool = True, crop: Optional[int] = None,
                               divisor: int = 32) -> torch.Tensor:
    """The mean over scales (and horizontal flips) of the softmax of
    ``forward``'s logits resized back to the image, (B, H, W, num_classes)
    float32. Each scale's size is rounded to a multiple of ``divisor``; a
    scaled image larger than ``crop`` runs through ``slide_inference``."""
    b, h, w, _ = image.shape
    acc = torch.zeros((b, h, w, num_classes), dtype=torch.float32, device=image.device)
    n = 0
    for s in scales:
        nh = max(int(round(h * s / divisor)) * divisor, divisor)
        nw = max(int(round(w * s / divisor)) * divisor, divisor)
        img_s = resize(image, (nh, nw))
        for flipped in ((False, True) if flip else (False,)):
            v = img_s.flip(2) if flipped else img_s
            if crop is not None and (nh > crop or nw > crop):
                out = slide_inference(forward, v, num_classes, crop)
            else:
                out = forward(v).float()
            if flipped:
                out = out.flip(2)
            acc += torch.softmax(resize(out, (h, w)), dim=-1)
            n += 1
    return acc / n


def evaluate_volumes(forward: Callable[[torch.Tensor], torch.Tensor], volumes, num_classes: int,
                     crop: int = 224, batch_slices: int = 8, device="cuda") -> dict:
    """Synapse's per-case volumetric eval: each case's slices in groups of
    ``batch_slices`` (the last group padded with zero slices), each slice
    repeated to 3 channels and normalized from ``x * 255`` in float (not
    rounded to uint8), through ``forward`` or, where a side exceeds
    ``crop``, ``slide_inference``; the argmax on ``device``, then
    ``dice_per_case`` per case. ``volumes`` yields (name, image (D, H, W)
    float in [0, 1], label (D, H, W) int), e.g. ``SynapseCT.volumes()``.
    Returns percentages: ``mean_dice_fg`` (the classes but 0, averaged
    over cases), ``per_class_dice`` (over cases) and ``per_case`` (each
    case's mean over all classes)."""
    device = torch.device(device)
    per_case = {}
    for name, img_vol, lbl_vol in volumes:
        d, h, w = img_vol.shape
        vol = torch.from_numpy(np.ascontiguousarray(img_vol, np.float32)).to(device)
        preds = torch.empty((d, h, w), dtype=torch.int64, device=device)
        for s0 in range(0, d, batch_slices):
            sl = vol[s0:s0 + batch_slices]
            n = sl.shape[0]
            if n < batch_slices:  # a full group: the JAX function's static batch
                sl = torch.cat([sl, sl.new_zeros((batch_slices - n, h, w))])
            x = normalize(sl[..., None].expand(-1, -1, -1, 3) * 255.0)
            if h > crop or w > crop:
                logits = slide_inference(forward, x, num_classes, crop)
            else:
                logits = forward(x)
            preds[s0:s0 + n] = logits.argmax(-1)[:n]
        labels = torch.from_numpy(np.ascontiguousarray(lbl_vol)).to(device)
        per_case[name] = dice_per_case(preds, labels, num_classes).cpu().numpy()
    all_dice = np.stack(list(per_case.values()))  # (cases, classes)
    mean_fg = float(all_dice[:, 1:].mean()) if num_classes > 1 else float(all_dice.mean())
    return {"mean_dice_fg": 100.0 * mean_fg,
            "per_class_dice": (100.0 * all_dice.mean(0)).tolist(),
            "per_case": {k: float(100.0 * v.mean()) for k, v in per_case.items()}}


class SemSeg:
    """Weights -> whole-image predictor on ``device``: a ``state_dict``, or
    the best (else the latest) checkpoint of ``ckpt_dir``, or the seeded
    initial weights."""

    def __init__(self, backbone: str, head: str, num_classes: int,
                 state_dict: Optional[dict] = None, img_size: int = 512,
                 palette: Optional[np.ndarray] = None, embed_dim: Optional[int] = None,
                 dtype=torch.bfloat16, device="cuda", ckpt_dir: Optional[str] = None):
        self.model = build_model(backbone, head, num_classes, embed_dim=embed_dim,
                                 dtype=dtype, device=device, img_size=img_size)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        if ckpt_dir:
            self.load(ckpt_dir)
        self.device = torch.device(device)
        self.num_classes = num_classes
        self.img_size = img_size
        if palette is None:
            palette = np.random.default_rng(0).integers(0, 255, (num_classes, 3)).astype(np.uint8)
        self.palette = palette

    def load(self, ckpt_dir: str) -> None:
        """Load the best step of ``ckpt_dir`` (its highest mIoU; the latest
        of a tie or where none was recorded). Raises FileNotFoundError when
        the directory holds no checkpoint."""
        if not os.path.isdir(ckpt_dir):
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
        mngr = CheckpointManager(ckpt_dir)
        step = mngr.best_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
        mngr.restore(self.model, step=step)

    @torch.inference_mode()
    def forward(self, batch) -> torch.Tensor:
        """(B, H, W, 3) normalized -> (B, H, W, num_classes) float32 logits."""
        return self.model(torch.as_tensor(batch).to(self.device))

    @torch.inference_mode()
    def predict(self, image_u8: np.ndarray, tta: bool = False, overlay_alpha: float = 0.6):
        """Returns (seg_map (H, W) int32, overlay_rgb (H, W, 3) uint8);
        ``tta``: the mean softmax over ``multi_scale_flip_inference``'s
        default scales and flips."""
        batch, orig_hw = preprocess(image_u8, self.img_size)
        batch = torch.from_numpy(batch).to(self.device)
        if tta:
            logits = multi_scale_flip_inference(self.forward, batch, self.num_classes)
        else:
            logits = self.forward(batch)
        seg = postprocess(logits, orig_hw)
        return seg, overlay(image_u8, colorize(seg, self.palette), overlay_alpha)
