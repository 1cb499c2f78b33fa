"""Activation registry.

Port of ``segmentation_factory_tpu/models/layers/act.py`` for the names
the ported modules take (``ConvModule``'s ``act``): relu, relu6,
hardswish, hard sigmoid, sigmoid, GELU (``"gelu"`` the tanh form, as
``jax.nn.gelu``'s default; ``"gelu_exact"`` the erf form) and StarReLU.
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


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.hard_sigmoid``: relu6(x + 3) / 6."""
    return (x + 3.0).clamp(0.0, 6.0) / 6.0


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)``: 0.5 x (1 + tanh(sqrt(2 / pi) (x +
    0.044715 x^3)))."""
    return F.gelu(x, approximate="tanh")


def star_relu(x: torch.Tensor, scale: float = 0.8944, bias: float = -0.4472) -> torch.Tensor:
    """StarReLU (MetaFormer): scale * relu(x)^2 + bias."""
    r = torch.relu(x)
    return scale * r * r + bias


ACTIVATIONS = {
    "relu": torch.relu,
    "relu6": relu6,
    "hswish": hardswish,
    "hardswish": hardswish,
    "gelu": gelu_tanh,
    "gelu_exact": F.gelu,
    "hsigmoid": hard_sigmoid,
    "sigmoid": torch.sigmoid,
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
