"""Predict and eval steps of the serving path.

Port of ``segmentation_factory_tpu/engine/steps.py`` ``eval_step``,
``_predict_map`` and ``predict_step`` (:132-197). There is no TrainState:
the model carries its weights. The forward runs with ``resize_output=False``
and the final upsample+argmax is one kernel (K8, ``resize_argmax_to``), so
the full-resolution logits never exist; where the head is already at full
size it is a plain argmax.
"""

from __future__ import annotations

from typing import Dict

import torch

from segmentation_factory_tpu_torch.device import model_device
from segmentation_factory_tpu_torch.metrics import confusion_matrix
from segmentation_factory_tpu_torch.ops.resize_argmax import resize_argmax_to


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
