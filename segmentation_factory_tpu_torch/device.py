"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    absent. The port never moves to the CPU on its own: the caller passes
    ``device="cpu"`` to run there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev


def model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device
