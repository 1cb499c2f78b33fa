"""Norm layers of the MiT / SegFormer path, channels last.

Port of ``segmentation_factory_tpu/models/layers/norm.py`` (BatchNorm, eps
1e-5, flax momentum 0.9) and of flax's ``nn.LayerNorm``
(eps 1e-6, the final ``norm{i}`` of each MiT stage, ``mit.py:330``). Both
subclass the torch modules only for their parameters and buffers, so the
``state_dict`` keys are the reference's (weight, bias, running_mean,
running_var, num_batches_tracked).
"""

from __future__ import annotations

import torch
from torch import nn

from segmentation_factory_tpu_torch.models.layers.common import ln_apply


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis; returns float32 (``ln_apply``)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ln_apply(x, self.weight, self.bias, self.eps)


def batch_norm_eval(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Eval BatchNorm of channels-last ``x`` with flax's order of
    operations, in float32, cast back to ``x.dtype``:
    (x - mean) * (rsqrt(var + eps) * scale) + bias."""
    mul = torch.rsqrt(bn.running_var.float() + bn.eps) * bn.weight.float()
    y = (x.float() - bn.running_mean.float()) * mul + bn.bias.float()
    return y.to(x.dtype)


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Train BatchNorm of channels-last ``x`` with flax's semantics, cast
    back to ``x.dtype``: float32 batch statistics over all but the last
    axis, the variance as E[x^2] - E[x]^2 clipped at 0, normalisation with
    that biased variance. Updates ``bn``'s running statistics in place with
    the same biased variance, new = 0.9 * old + 0.1 * batch (flax momentum
    0.9; ``F.batch_norm`` would store the unbiased variance instead)."""
    xf = x.float()
    axes = tuple(range(x.dim() - 1))
    mean = xf.mean(axes)
    var = ((xf * xf).mean(axes) - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + bn.eps) * bn.weight.float()
    y = (xf - mean) * mul + bn.bias.float()
    update_running_stats(bn, mean, var)
    return y.to(x.dtype)


@torch.no_grad()
def update_running_stats(bn: nn.BatchNorm2d, mean: torch.Tensor, var: torch.Tensor) -> None:
    """``bn``'s running statistics from a batch's float32 mean and biased
    variance: new = 0.9 * old + 0.1 * batch (flax momentum 0.9 is torch
    momentum 0.1), and one more ``num_batches_tracked``."""
    keep = 1.0 - bn.momentum
    bn.running_mean.copy_(keep * bn.running_mean + (1.0 - keep) * mean)
    bn.running_var.copy_(keep * bn.running_var + (1.0 - keep) * var)
    bn.num_batches_tracked += 1


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm over the last (channel) axis of an NHWC map: batch
    statistics and a running-statistics update in training mode, the
    running statistics in eval mode."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return batch_norm_train(x, self)
        return batch_norm_eval(x, self)
