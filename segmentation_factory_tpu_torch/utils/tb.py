"""Scalar logging to ``<log_dir>/scalars.jsonl``, one line per scalar.

The port's copy of ``segmentation_factory_tpu/utils/tb.py`` ``ScalarWriter``
without its optional TensorBoard backend: the JSONL lines carry the same
scalars, and the card's machine has no TensorBoard.
"""

from __future__ import annotations

import json
import os
import time


class ScalarWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "scalars.jsonl")
        self._fh = None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._fh is None:
            self._fh = open(self.path, "a")
        self._fh.write(json.dumps({"tag": tag, "value": float(value), "step": int(step),
                                   "ts": time.time()}) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
