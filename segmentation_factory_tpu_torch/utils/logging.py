"""Console logging meters and the model-size summary.

The port's copy of ``segmentation_factory_tpu/utils/logging.py``
(``SmoothedValue``, ``MetricLogger``, ``device_memory_mb``) and of
``get_model_size`` (``utils/profiling.py``). The meters see host floats:
the Trainer reads a loss from the device only every ``print_freq`` steps.
"""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Iterable, Optional

import torch


class SmoothedValue:
    """A window of values and the global average."""

    def __init__(self, window: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg, global_avg=self.global_avg,
                               value=self.value)


def device_memory_mb() -> Optional[float]:
    """Memory held by tensors on the current CUDA device in MB, None
    without a card."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    return torch.cuda.memory_allocated() / (1024 ** 2)


class MetricLogger:
    """Iteration logger with ETA; ``data_time`` holds the seconds each
    iteration waited for its item (the loader's share of a step)."""

    def __init__(self, delimiter: str = "  ", print_freq: int = 50, header: str = ""):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.print_freq = print_freq
        self.header = header
        self.data_time = SmoothedValue(fmt="{avg:.4f}")
        self.iter_time = SmoothedValue(fmt="{avg:.4f}")

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def log_every(self, iterable: Iterable, total: Optional[int] = None):
        total = total if total is not None else len(iterable)  # type: ignore[arg-type]
        start = end = time.perf_counter()
        for i, obj in enumerate(iterable):
            self.data_time.update(time.perf_counter() - end)
            yield i, obj
            self.iter_time.update(time.perf_counter() - end)
            end = time.perf_counter()
            if i % self.print_freq == 0 or i == total - 1:
                eta = datetime.timedelta(seconds=int(self.iter_time.global_avg * (total - i - 1)))
                parts = [f"{self.header}[{i:>4d}/{total}]", f"eta: {eta}",
                         *(f"{k}: {v}" for k, v in self.meters.items()),
                         f"time: {self.iter_time}", f"data: {self.data_time}"]
                mem = device_memory_mb()
                if mem is not None:
                    parts.append(f"mem: {mem:.0f}MB")
                print(self.delimiter.join(parts), flush=True)
        elapsed = datetime.timedelta(seconds=int(time.perf_counter() - start))
        print(f"{self.header} total time: {elapsed}", flush=True)


def get_model_size(model: torch.nn.Module) -> dict:
    """Parameter count and MB of the model's parameters."""
    params = list(model.parameters())
    n = sum(p.numel() for p in params)
    size = sum(p.numel() * p.element_size() for p in params)
    return {"params": n, "params_M": n / 1e6, "size_MB": size / (1024 ** 2)}
