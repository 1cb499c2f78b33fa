"""Confusion matrix on the device and the IoU math on the host.

Port of ``segmentation_factory_tpu/metrics.py`` ``confusion_matrix``
(:26-41), ``update_confusion_matrix`` (:44-50), ``compute_metrics``
(:53-85) and ``dice_per_case`` (:88-96). The JAX package keeps the
histogram in uint32 because the TPU has no int64; PyTorch has no
arithmetic on uint32, and the card has int64, so the histogram here is
int64, the reference engine's own type.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def confusion_matrix(preds: torch.Tensor, labels: torch.Tensor, num_classes: int,
                     ignore_index: int = 255) -> torch.Tensor:
    """(C, C) int64 histogram, rows = ground truth, columns = prediction.
    Invalid or ignored pixels go to a scratch bin that is dropped."""
    t = labels.reshape(-1).long()
    p = preds.reshape(-1).long()
    valid = (t >= 0) & (t < num_classes) & (t != ignore_index)
    idx = torch.where(valid, t * num_classes + p, num_classes * num_classes)
    hist = torch.bincount(idx, minlength=num_classes * num_classes + 1)
    return hist[: num_classes * num_classes].view(num_classes, num_classes)


def update_confusion_matrix(hist: torch.Tensor, logits: torch.Tensor, labels: torch.Tensor,
                            ignore_index: int = 255) -> torch.Tensor:
    """hist + the confusion matrix of argmax(NHWC ``logits``) against
    ``labels``."""
    return hist + confusion_matrix(logits.argmax(-1), labels, hist.shape[0], ignore_index)


def compute_metrics(hist) -> Dict[str, float]:
    """IoU / F1 / accuracy from the (C, C) histogram in float64, classes
    absent from the ground truth skipped in the means."""
    if isinstance(hist, torch.Tensor):
        hist = hist.cpu().numpy()
    h = np.asarray(hist, dtype=np.float64)
    tp = np.diag(h)
    gt = h.sum(axis=1)
    pred = h.sum(axis=0)
    union = gt + pred - tp
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = tp / union
        f1 = 2.0 * tp / (gt + pred)
        acc_per_class = tp / gt
    present = gt > 0

    def mean(v):
        return float(np.nanmean(np.where(present, v, np.nan))) if present.any() else 0.0

    total = h.sum()
    return {
        "mIoU": 100.0 * mean(iou),
        "mF1": 100.0 * mean(f1),
        "mAcc": 100.0 * mean(acc_per_class),
        "aAcc": 100.0 * float(tp.sum() / total) if total > 0 else 0.0,
        "ious": (100.0 * iou).tolist(),
        "f1s": (100.0 * f1).tolist(),
    }


def dice_per_case(preds: torch.Tensor, labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(C,) float32 dice of each class over one case (Synapse's protocol),
    on the tensors' device: 2 |P ∩ T| / (|P| + |T|), 1.0 for a class in
    neither. A value outside [0, C) (a void label) counts in no class, as
    the JAX function's one-hot rows of zeros; the counts are exact integers
    before they become float32."""
    p = preds.reshape(-1).long()
    t = labels.reshape(-1).long()

    def count(x, valid):
        idx = torch.where(valid, x, num_classes)
        return torch.bincount(idx, minlength=num_classes + 1)[:num_classes].float()

    p_ok = (p >= 0) & (p < num_classes)
    t_ok = (t >= 0) & (t < num_classes)
    inter = count(p, p_ok & (p == t))
    denom = count(p, p_ok) + count(t, t_ok)
    return torch.where(denom > 0, 2.0 * inter / denom.clamp_min(1.0), torch.ones_like(denom))
