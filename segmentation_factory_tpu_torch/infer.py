"""Whole-image predictor: short-side preprocess, forward, resize back, argmax.

Port of ``segmentation_factory_tpu/infer.py`` ``preprocess``,
``postprocess``, ``colorize``, ``overlay`` and ``SemSeg`` (:31-60,
:290-360), whole image only. PIL is imported only by ``preprocess``. The
weights come as a ``state_dict`` (a ``torch.load`` of a reference-layout
``.pt``, or ``convert.from_jax_variables``); orbax checkpoints need JAX and
are not read here.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from segmentation_factory_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from segmentation_factory_tpu_torch.models.build import build_model
from segmentation_factory_tpu_torch.models.layers import resize


def preprocess(image_u8: np.ndarray, img_size: int, divisor: int = 32):
    """Short side scaled to ``img_size``, both sides ceiled to a multiple
    of ``divisor``, normalized. Returns ((1, H, W, 3) float32, orig_hw)."""
    from PIL import Image

    h, w = image_u8.shape[:2]
    scale = img_size / min(h, w)
    nh = int(math.ceil(h * scale / divisor) * divisor)
    nw = int(math.ceil(w * scale / divisor) * divisor)
    img = np.asarray(Image.fromarray(image_u8).resize((nw, nh), Image.BILINEAR), np.float32)
    img = (img - IMAGENET_MEAN * 255.0) / (IMAGENET_STD * 255.0)
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


class SemSeg:
    """``state_dict`` -> whole-image predictor on ``device``."""

    def __init__(self, backbone: str, head: str, num_classes: int,
                 state_dict: Optional[dict] = None, img_size: int = 512,
                 palette: Optional[np.ndarray] = None, embed_dim: Optional[int] = None,
                 dtype=torch.bfloat16, device="cuda"):
        self.model = build_model(backbone, head, num_classes, embed_dim=embed_dim,
                                 dtype=dtype, device=device)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.device = torch.device(device)
        self.num_classes = num_classes
        self.img_size = img_size
        if palette is None:
            palette = np.random.default_rng(0).integers(0, 255, (num_classes, 3)).astype(np.uint8)
        self.palette = palette

    @torch.inference_mode()
    def forward(self, batch) -> torch.Tensor:
        """(B, H, W, 3) normalized -> (B, H, W, num_classes) float32 logits."""
        return self.model(torch.as_tensor(batch).to(self.device))

    def predict(self, image_u8: np.ndarray, overlay_alpha: float = 0.6):
        """Returns (seg_map (H, W) int32, overlay_rgb (H, W, 3) uint8)."""
        batch, orig_hw = preprocess(image_u8, self.img_size)
        seg = postprocess(self.forward(batch), orig_hw)
        return seg, overlay(image_u8, colorize(seg, self.palette), overlay_alpha)
