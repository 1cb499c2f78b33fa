"""Checkpoints: save on improvement, keep the best, resume from the latest.

The port's counterpart of ``segmentation_factory_tpu/checkpoint.py``
``CheckpointManager`` (:23-95), with its policy (``max_to_keep=2`` chosen by
mIoU, ``latest_step``, ``best_step``, ``restore``) and the port's own format:
one ``torch.save`` per step, ``<directory>/step_<step>.pt``, holding the
model's ``state_dict`` in the reference layout (so its weights load into
any port model of the same configuration), the optimizer's
``state_dict``, the step and the metrics. Orbax directories of the JAX
package are not read.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


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
