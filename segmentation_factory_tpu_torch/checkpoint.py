"""Checkpoints: save on improvement, keep the best, resume from the latest.

The port's counterpart of ``segmentation_factory_tpu/checkpoint.py``
``CheckpointManager`` (:23-95), with its policy (``max_to_keep=2`` chosen by
mIoU, ``latest_step``, ``best_step``, ``restore``) and the port's own format:
one ``torch.save`` per step, ``<directory>/step_<step>.pt``, holding the
model's ``state_dict`` in the reference layout (so its weights load into
any port model of the same configuration), the optimizer's
``state_dict``, the step and the metrics. Orbax directories of the JAX
package are not read.

Initialisation from other runs: ``load_for_finetune`` (``checkpoint.py:
98-140`` with ``loop.py:278-327``) takes a reference ``.pth`` or a port
checkpoint directory, keeping the fresh init for the classifier
(``CLASSIFIER_KEYS``), for shape mismatches and for missing keys;
``load_pretrained_backbone`` (``convert.py:1377-1404`` with ``loop.py:
255-276``) takes a reference ``.pth``'s backbone tensors where name and
shape match.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")
# the reference's task-specific heads; DeepLabV3's main classifier is the
# JAX tree's `conv_seg` under the reference's key `head.block.4`
CLASSIFIER_KEYS = ("linear_pred", "conv_seg", "head.block.4.")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 2):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> Path:
        return self.directory / f"step_{step}.pt"

    def steps(self):
        return sorted(int(m.group(1)) for p in self.directory.iterdir()
                      if (m := _NAME.match(p.name)))

    def _metric(self, step: int) -> float:
        meta = torch.load(self._path(step), map_location="cpu", weights_only=True,
                          mmap=True)["metrics"]
        return float(meta.get("mIoU", 0.0))

    def save(self, step: int, model: torch.nn.Module, optimizer,
             metrics: Optional[Dict[str, Any]] = None) -> None:
        """Write step ``step`` (atomically: a temporary file renamed), then
        drop the checkpoints beyond ``max_to_keep``, lowest mIoU first
        (the older one of a tie)."""
        state = {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                 "step": int(step), "metrics": dict(metrics or {})}
        tmp = self._path(step).with_suffix(f".tmp{os.getpid()}")
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        steps = self.steps()
        while len(steps) > self.max_to_keep:
            worst = min(steps, key=lambda s: (self._metric(s), s))
            self._path(worst).unlink()
            steps.remove(worst)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        """The step of the highest mIoU (the later one of a tie)."""
        steps = self.steps()
        return max(steps, key=lambda s: (self._metric(s), s)) if steps else None

    def restore(self, model: torch.nn.Module, optimizer=None,
                step: Optional[int] = None) -> Tuple[Optional[int], Dict[str, Any]]:
        """Load step ``step`` (default the latest) into ``model`` and, when
        given, ``optimizer``; returns (step, metrics), (None, {}) when there
        is no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, {}
        dev = next(model.parameters()).device
        state = torch.load(self._path(step), map_location=dev, weights_only=True)
        model.load_state_dict(state["model"])
        if optimizer is not None:
            optimizer.load_state_dict(state["optimizer"])
        return state["step"], state["metrics"]


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.pth``'s tensors by name, on the CPU: a dict's
    ``model_state`` and then ``state_dict`` unwrapped, as
    ``convert.load_torch_checkpoint`` (convert.py:1407-1416) does."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model_state" in ckpt:
        ckpt = ckpt["model_state"]
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return {k: v.detach() for k, v in ckpt.items() if torch.is_tensor(v)}


def is_classifier(name: str) -> bool:
    return any(k in name for k in CLASSIFIER_KEYS)


@torch.no_grad()
def load_for_finetune(model: torch.nn.Module, path: str) -> List[str]:
    """Initialise ``model`` from ``path`` for finetuning: a reference
    ``.pth`` (the port's keys are the reference's) or a port checkpoint
    directory (its best step, else its latest). Every tensor of the model's
    ``state_dict`` (BatchNorm running statistics too) whose name is there
    with the same shape and is not a classifier's takes the checkpoint's
    value; the others keep theirs. Returns the names that kept theirs."""
    if path.endswith(".pth"):
        src = load_torch_checkpoint(path)
    else:
        mngr = CheckpointManager(path)
        step = mngr.best_step()
        step = mngr.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {path}")
        src = torch.load(mngr._path(step), map_location="cpu", weights_only=True)["model"]
    kept = []
    for name, dst in model.state_dict().items():
        old = src.get(name)
        if old is None or is_classifier(name) or tuple(old.shape) != tuple(dst.shape):
            kept.append(name)
        else:
            dst.copy_(old.to(dst.dtype))
    return kept


@torch.no_grad()
def load_pretrained_backbone(model: torch.nn.Module, path: str) -> Tuple[List[str], List[str]]:
    """Load a reference ``.pth``'s backbone into ``model.backbone`` (the
    reference's ``load_state_dict(strict=False)``): of a full model's
    checkpoint only the ``backbone.`` tensors, prefix dropped. A tensor
    loads where the backbone has its name and shape, BatchNorm running
    statistics included; the others are reported skipped.
    ``num_batches_tracked`` is bookkeeping and neither. Returns the loaded
    and the skipped names."""
    sd = load_torch_checkpoint(path)
    if any(k.startswith("backbone.") for k in sd):
        sd = {k[len("backbone."):]: v for k, v in sd.items() if k.startswith("backbone.")}
    own = model.backbone.state_dict()
    loaded, skipped = [], []
    for name, v in sd.items():
        if name.endswith("num_batches_tracked"):
            continue
        if name not in own:
            skipped.append(f"backbone/{name} (missing in model)")
        elif tuple(own[name].shape) != tuple(v.shape):
            skipped.append(f"backbone/{name} (shape mismatch)")
        else:
            own[name].copy_(v.to(own[name].dtype))
            loaded.append(f"backbone/{name}")
    return loaded, skipped
