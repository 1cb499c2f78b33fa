"""Train, predict and eval steps.

Port of ``segmentation_factory_tpu/engine/steps.py``: ``compute_loss``
(:24-70), ``train_step`` (:73-129), ``eval_step``, ``_predict_map`` and
``predict_step`` (:132-197). There is no TrainState: the model carries its
weights and BatchNorm statistics, the optimizer (``engine.state``) its
moments and update count. Both steps run the forward with
``resize_output=False``: in training the loss upsamples inside K7 (the
fused CE / OHEM-CE + dice), in prediction the final upsample+argmax is K8,
so the full-resolution logits never exist.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from segmentation_factory_tpu_torch import losses as L
from segmentation_factory_tpu_torch.device import model_device
from segmentation_factory_tpu_torch.metrics import confusion_matrix
from segmentation_factory_tpu_torch.ops.resize_argmax import resize_argmax_to

# per-loss aux-output weights (steps.py:24-27): CE [1, 0.4, 0.4], OHEM [1, 1]
AUX_WEIGHTS = {"ohem": (1.0, 1.0, 1.0)}
_AUX_DEFAULT = (1.0, 0.4, 0.4)


def _on(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x).to(device)


@torch.inference_mode()
def predict_step(model: torch.nn.Module, images) -> torch.Tensor:
    """(B, H, W, 3) normalized images -> (B, H, W) int32 label map, on the
    model's device."""
    images = _on(images, model_device(model))
    h, w = images.shape[1], images.shape[2]
    logits = model(images, resize_output=False)
    if (logits.shape[1], logits.shape[2]) == (h, w):
        return logits.argmax(-1).to(torch.int32)
    return resize_argmax_to(logits, (h, w))


@torch.inference_mode()
def eval_step(model: torch.nn.Module, batch: Dict, hist: torch.Tensor, *,
              ignore_index: int = 255) -> torch.Tensor:
    """hist + the (C, C) confusion matrix of the batch
    {'image': (B, H, W, 3), 'label': (B, H, W)}."""
    preds = predict_step(model, batch["image"])
    labels = _on(batch["label"], preds.device)
    return hist + confusion_matrix(preds, labels, hist.shape[0], ignore_index)


def compute_loss(logits, labels, ignore_index: int = 255, loss_type: str = "ce",
                 use_dice: bool = True) -> torch.Tensor:
    """``losses.criterion`` of the logits (a list: the main output and aux
    heads, weighted by ``AUX_WEIGHTS``), with the reference's CE class
    weights (1, 2) for two-class CE (steps.py:44-57)."""
    first = logits[0] if isinstance(logits, (tuple, list)) else logits
    key = loss_type.lower().replace("_", "")
    cw = (1.0, 2.0) if first.shape[-1] == 2 and key in ("ce", "crossentropy") else None
    if isinstance(logits, (tuple, list)):
        weights = AUX_WEIGHTS.get(loss_type, _AUX_DEFAULT)
        return sum(w * L.criterion(lg, labels, ignore_index, use_dice=use_dice,
                                   loss_type=loss_type, class_weights=cw)
                   for w, lg in zip(weights, logits))
    return L.criterion(logits, labels, ignore_index, use_dice=use_dice, loss_type=loss_type,
                       class_weights=cw)


def _batch_norms(model: torch.nn.Module):
    return [m for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]


def train_step(model: torch.nn.Module, optimizer, batch: Dict, *,
               generator: Optional[torch.Generator] = None, noise: Optional[Dict] = None,
               ignore_index: int = 255, loss_type: str = "ce",
               use_dice: bool = True) -> Dict[str, torch.Tensor]:
    """One optimizer update on {'image': (B, H, W, 3) float, 'label':
    (B, H, W) int}, on the model's device. Puts the model in training mode;
    drop-path and dropout draw from ``generator`` (or take ``noise``, see
    ``SegmentationModel.forward``). The loss takes the head-resolution
    logits. When the loss is not finite nothing changes — parameters,
    optimizer state and BatchNorm running statistics keep their values —
    and ``skipped_nonfinite`` is 1 (steps.py:120-128); the check runs on the
    device, without a host synchronisation. Returns device tensors
    ``loss``, ``lr`` (the learning rate of this update) and
    ``skipped_nonfinite``."""
    dev = model_device(model)
    images = _on(batch["image"], dev).float()
    labels = _on(batch["label"], dev).to(torch.int32)
    model.train()
    bns = _batch_norms(model)
    saved = [(bn.running_mean.clone(), bn.running_var.clone(), bn.num_batches_tracked.clone())
             for bn in bns]
    logits = model(images, resize_output=False, generator=generator, noise=noise)
    loss = compute_loss(logits, labels, ignore_index, loss_type, use_dice)
    grads = torch.autograd.grad(loss, optimizer.params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(optimizer.params, grads)]
    ok = torch.isfinite(loss.detach())
    lr = optimizer.step(grads, ok)
    with torch.no_grad():
        for bn, (mean, var, n) in zip(bns, saved):
            bn.running_mean.copy_(torch.where(ok, bn.running_mean, mean))
            bn.running_var.copy_(torch.where(ok, bn.running_var, var))
            bn.num_batches_tracked.copy_(torch.where(ok, bn.num_batches_tracked, n))
    return {"loss": loss.detach(), "lr": lr, "skipped_nonfinite": (~ok).to(torch.int32)}
