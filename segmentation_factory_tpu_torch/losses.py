"""Segmentation losses.

Port of ``segmentation_factory_tpu/losses.py`` (:36-285). Every function
takes logits (B, H, W, C) in any float dtype (computed in float32) and
labels (B, H, W) int with ``ignore_index`` marking void pixels, and returns
a float32 scalar. Void pixels are masked, not dropped, so shapes stay
fixed. A label outside [0, C) that is not ``ignore_index`` counts as valid
with an all-zero one-hot row, as ``jax.nn.one_hot`` gives.

``criterion`` takes logits at label resolution or at head resolution; the
second goes to ``ops.lowres_loss.lowres_criterion`` (losses.py:250-256),
which fuses the upsample with CE / OHEM-CE and dice (K7).

The OHEM k-th value comes from a sort indexed by a device tensor
(``kth_largest``): the same value as the JAX package's 32-pass bit search
(losses.py:87-107), which exists because TPU sorts are slow, and unlike
``torch.kthvalue`` / ``topk`` it needs no host copy of k.
"""

from __future__ import annotations

import math

import torch


def sigmoid_bce(logits, targets) -> torch.Tensor:
    """Per-element sigmoid binary cross-entropy, max(x, 0) - x t +
    log1p(exp(-|x|)) (losses.py:25-33): Mask2Former's mask loss."""
    return logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def _flatten(logits, labels):
    c = logits.shape[-1]
    return logits.reshape(-1, c).float(), labels.reshape(-1)


def one_hot(labels, num_classes: int) -> torch.Tensor:
    """float32 one-hot rows; labels outside [0, num_classes) give zeros."""
    return (labels[..., None] == torch.arange(num_classes, device=labels.device)).float()


def _per_pixel_ce(logits2d, labels1d, ignore_index: int, class_weights=None,
                  label_smoothing: float = 0.0):
    """Per-pixel CE (float32), validity mask and per-pixel weight
    (losses.py:41-71): lse minus the one-hot-picked logit."""
    c = logits2d.shape[-1]
    valid = labels1d != ignore_index
    safe = torch.where(valid, labels1d, torch.zeros_like(labels1d)).long()
    lse = torch.logsumexp(logits2d, dim=-1)
    picked = (logits2d * one_hot(safe, c)).sum(-1)
    if label_smoothing > 0.0:
        loss = lse - (1.0 - label_smoothing) * picked - label_smoothing * logits2d.mean(-1)
    else:
        loss = lse - picked
    if class_weights is not None:
        cw = torch.as_tensor(class_weights, dtype=torch.float32, device=logits2d.device)
        w = cw[safe.clamp(0, cw.numel() - 1)]  # jnp indexing clamps out-of-range
    else:
        w = torch.ones_like(loss)
    return loss, valid, torch.where(valid, w, torch.zeros_like(w))


def cross_entropy(logits, labels, ignore_index: int = 255, class_weights=None,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Masked softmax cross-entropy, normalised by the weight sum."""
    l2, l1 = _flatten(logits, labels)
    loss, _, w = _per_pixel_ce(l2, l1, ignore_index, class_weights, label_smoothing)
    return (loss * w).sum() / w.sum().clamp_min(1.0)


def kth_largest(x: torch.Tensor, k) -> torch.Tensor:
    """``sort_desc(x)[k - 1]`` of a 1-D float32 tensor for an int or a 0-d
    integer tensor ``k`` (on any device, no host copy). k <= 0 gives the
    largest value; callers gate that case (``n_min > 0``)."""
    k = torch.as_tensor(k, device=x.device).long().reshape(1)
    return torch.sort(x.float(), descending=True).values.gather(0, (k - 1).clamp_min(0))[0]


def ohem_keep(loss, valid, thresh: float = 0.7, min_kept_ratio: float = 1.0 / 16.0):
    """OHEM keep-set (losses.py:127-135): valid pixels whose loss exceeds
    -log(thresh), and at least the n_min = floor(valid * ratio) hardest
    (loss >= the n_min-th largest valid loss)."""
    loss_thresh = -torch.log(torch.tensor(thresh, dtype=torch.float32))
    masked = torch.where(valid, loss, torch.full_like(loss, -math.inf))
    n_valid = valid.sum()
    n_min = (n_valid.float() * min_kept_ratio).int()
    keep_topk = (masked >= kth_largest(masked, n_min)) & (n_min > 0)
    return valid & ((loss > loss_thresh.to(loss.device)) | keep_topk)


def ohem_cross_entropy(logits, labels, ignore_index: int = 255, thresh: float = 0.7,
                       min_kept_ratio: float = 1.0 / 16.0) -> torch.Tensor:
    """Online hard-example mining CE (losses.py:110-137)."""
    l2, l1 = _flatten(logits, labels)
    loss, valid, w = _per_pixel_ce(l2, l1, ignore_index)
    kw = ohem_keep(loss, valid, thresh, min_kept_ratio).float() * w
    return (loss * kw).sum() / kw.sum().clamp_min(1.0)


def focal_loss(logits, labels, ignore_index: int = 255, alpha: float = 0.25,
               gamma: float = 2.0) -> torch.Tensor:
    """Multi-class focal loss: alpha * (1 - p)^gamma * CE (losses.py:140-152)."""
    l2, l1 = _flatten(logits, labels)
    ce, _, w = _per_pixel_ce(l2, l1, ignore_index)
    loss = alpha * (1.0 - torch.exp(-ce)) ** gamma * ce
    return (loss * w).sum() / w.sum().clamp_min(1.0)


def _probs_and_target(logits, labels, ignore_index: int):
    """Softmax probabilities and one-hot targets (B, N, C), both zeroed at
    void pixels, and the (B, N, 1) float validity."""
    b, c = logits.shape[0], logits.shape[-1]
    probs = torch.softmax(logits.float().reshape(b, -1, c), dim=-1)
    lab = labels.reshape(b, -1)
    vm = (lab != ignore_index).float()[..., None]
    return probs * vm, one_hot(lab.long(), c) * vm, vm


def dice_from_sums(inter, psum, ysum, smooth: float = 1e-6) -> torch.Tensor:
    """1 - mean dice from per-image, per-class sums, with the empty-set rule:
    where an image has neither probability mass nor target pixels for a
    class, sets_sum becomes 2 * inter, so that class's dice is 1
    (losses.py:188-192, pallas_loss._dice_from_partials)."""
    sets_sum = psum + ysum
    sets_sum = torch.where(sets_sum == 0.0, 2.0 * inter, sets_sum)
    return 1.0 - ((2.0 * inter + smooth) / (sets_sum + smooth)).mean()


def dice_loss(logits, labels, ignore_index: int = 255, smooth: float = 1e-6) -> torch.Tensor:
    """Multiclass soft dice per image and per class (losses.py:162-192)."""
    probs, target, _ = _probs_and_target(logits, labels, ignore_index)
    return dice_from_sums((probs * target).sum(1), probs.sum(1), target.sum(1), smooth)


def tversky_dice_loss(logits, labels, ignore_index: int = 255, delta: float = 0.5,
                      smooth: float = 1e-6) -> torch.Tensor:
    """Tversky-delta dice per image (losses.py:195-220)."""
    probs, target, vm = _probs_and_target(logits, labels, ignore_index)
    tp = (probs * target).sum(1)
    fn = (target * (1.0 - probs)).sum(1)
    fp = ((1.0 - target) * vm * probs).sum(1)
    score = (tp + smooth) / (tp + delta * fn + (1.0 - delta) * fp + smooth)
    return (1.0 - score).mean()


def dice_bce_loss(logits, labels, ignore_index: int = 255) -> torch.Tensor:
    """CE + dice (losses.py:223-231)."""
    return cross_entropy(logits, labels, ignore_index) + dice_loss(logits, labels, ignore_index)


def criterion(logits, labels, ignore_index: int = 255, use_dice: bool = True,
              loss_type: str = "ce", class_weights=None) -> torch.Tensor:
    """Composite training loss (losses.py:234-265): the named loss plus,
    with ``use_dice``, the dice term. ``class_weights`` weigh the CE term
    only. Logits at another resolution than the labels are upsampled inside
    the loss (``lowres_criterion``)."""
    if tuple(logits.shape[1:3]) != tuple(labels.shape[1:3]):
        from segmentation_factory_tpu_torch.ops.lowres_loss import lowres_criterion

        return lowres_criterion(logits, labels, ignore_index, use_dice=use_dice,
                                loss_type=loss_type, class_weights=class_weights)
    key = loss_type.lower().replace("_", "")
    if class_weights is not None and key in ("ce", "crossentropy"):
        base = cross_entropy(logits, labels, ignore_index=ignore_index,
                             class_weights=class_weights)
    else:
        base = get_loss(loss_type)(logits, labels, ignore_index=ignore_index)
    if use_dice:
        base = base + dice_loss(logits, labels, ignore_index=ignore_index)
    return base


LOSSES = {
    "ce": cross_entropy,
    "crossentropy": cross_entropy,
    "ohem": ohem_cross_entropy,
    "ohemcrossentropy": ohem_cross_entropy,
    "focal": focal_loss,
    "dice": dice_loss,
    "tversky": tversky_dice_loss,
    "dicebce": dice_bce_loss,
}


def get_loss(name: str):
    """Loss by name, case and underscores ignored (losses.py:280-285)."""
    key = name.lower().replace("_", "")
    if key not in LOSSES:
        raise KeyError(f"unknown loss {name!r}; available: {sorted(LOSSES)}")
    return LOSSES[key]


__all__ = ["LOSSES", "criterion", "cross_entropy", "dice_bce_loss", "dice_from_sums",
           "dice_loss", "focal_loss", "get_loss", "kth_largest", "ohem_cross_entropy",
           "ohem_keep", "one_hot", "sigmoid_bce", "tversky_dice_loss"]
