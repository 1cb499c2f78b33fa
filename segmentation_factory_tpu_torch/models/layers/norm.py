"""Norm layers of the serving path, channels last.

Port of ``segmentation_factory_tpu/models/layers/norm.py`` (BatchNorm in
eval, eps 1e-5 over the running statistics) and of flax's ``nn.LayerNorm``
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


class BatchNorm(nn.BatchNorm2d):
    """Eval-mode BatchNorm over the last (channel) axis of an NHWC map.

    Training-mode statistics belong to the training slice, which this
    package does not hold yet, so a module in training mode raises."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "train-mode BatchNorm is not ported; call model.eval()")
        return batch_norm_eval(x, self)
