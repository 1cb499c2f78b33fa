"""Activation registry.

Port of ``segmentation_factory_tpu/models/layers/act.py`` for the names
the ported modules take (``ConvModule``'s ``act``): relu, relu6,
hardswish, exact GELU and StarReLU.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def hardswish(x: torch.Tensor) -> torch.Tensor:
    """x * clip(x + 3, 0, 6) / 6."""
    return x * (x + 3.0).clamp(0.0, 6.0) / 6.0


def relu6(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(0.0, 6.0)


def star_relu(x: torch.Tensor, scale: float = 0.8944, bias: float = -0.4472) -> torch.Tensor:
    """StarReLU (MetaFormer): scale * relu(x)^2 + bias."""
    r = torch.relu(x)
    return scale * r * r + bias


ACTIVATIONS = {
    "relu": torch.relu,
    "relu6": relu6,
    "hswish": hardswish,
    "hardswish": hardswish,
    "gelu_exact": F.gelu,
    "star_relu": star_relu,
}


def build_act(name: Optional[str]) -> Optional[Callable]:
    """Name -> activation function; None or '' -> None."""
    if not name:
        return None
    key = name.lower()
    if key not in ACTIVATIONS:
        raise KeyError(f"unknown activation {name!r}; available: {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[key]
