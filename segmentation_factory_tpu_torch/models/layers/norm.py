"""Norm layers, channels last.

Port of ``segmentation_factory_tpu/models/layers/norm.py`` (BatchNorm, eps
1e-5, flax momentum 0.9) and of flax's ``nn.LayerNorm`` (eps 1e-6):
``LayerNorm`` returns float32 (the final ``norm{i}`` of each MiT stage,
``mit.py:330``), ``CastLayerNorm`` rounds to the compute dtype as
``nn.LayerNorm(dtype=...)`` does (ConvNeXt's norms; with ``bias=False``
flax's ``use_bias=False``, MetaFormer's); ``GroupNorm`` is flax's
``nn.GroupNorm`` over NHWC (eps 1e-6; 1e-5 as the JAX wrapper
``GroupNorm``, ``norm.py:99-109``); ``GRN`` is ConvNeXtV2's global
response normalization (``norm.py:112-130``). The first four subclass
the torch modules only for their parameters and buffers, so the
``state_dict`` keys are the reference's (weight, bias, running_mean,
running_var, num_batches_tracked).
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from segmentation_factory_tpu_torch.models.layers.common import ln_apply


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis; returns float32 (``ln_apply``)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ln_apply(x, self.weight, self.bias, self.eps)


class CastLayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(dtype=dtype)`` over the last axis: float32
    statistics with the fast variance clipped at 0, then
    (x - mean) * (rsqrt(var + eps) * scale) + bias in float32 (flax's order,
    ``_normalize``), cast to ``dtype``. ``bias=False`` is flax's
    ``use_bias=False``: the scale alone (the ``weight`` key)."""

    def __init__(self, dim: int, dtype, eps: float = 1e-6, bias: bool = True):
        super().__init__(dim, eps=eps, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
        y = (xf - mu) * (torch.rsqrt(var + self.eps) * self.weight.float())
        return (y if self.bias is None else y + self.bias.float()).to(self.dtype)


class GRN(nn.Module):
    """ConvNeXtV2's global response normalization of an NHWC map, in
    float32 (``norm.py:112-130``): gx = sqrt(sum over (H, W) of x^2 + 1e-12)
    per channel, nx = gx / (mean over channels of gx + eps), out = gamma *
    (x * nx) + beta + x, cast back to x's dtype. ``gamma`` and ``beta`` are
    the reference's (1, 1, 1, C) parameters, zeros at init."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros((1, 1, 1, dim)))
        self.beta = nn.Parameter(torch.zeros((1, 1, 1, dim)))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        gx = torch.sqrt((xf * xf).sum((1, 2), keepdim=True) + 1e-12)
        nx = gx / (gx.mean(-1, keepdim=True) + self.eps)
        return (self.gamma * (xf * nx) + self.beta + xf).to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """flax ``nn.GroupNorm(num_groups, epsilon, dtype=dtype)`` over the last
    axis of an NHWC map: float32 statistics over (H, W, a group's channels)
    with the fast variance E[x^2] - E[x]^2 clipped at 0, then
    (x - mean) * (rsqrt(var + eps) * scale) + bias in float32 (flax's
    ``_normalize``), cast to ``dtype``."""

    def __init__(self, channels: int, dtype, num_groups: int = 32, eps: float = 1e-6):
        super().__init__(num_groups, channels, eps=eps)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, g = x.shape[0], x.shape[-1], self.num_groups
        xf = x.float().reshape(b, -1, g, c // g)
        mu = xf.mean((1, 3), keepdim=True)
        var = ((xf * xf).mean((1, 3), keepdim=True) - mu * mu).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float().view(g, c // g)
        y = (xf - mu) * mul + self.bias.float().view(g, c // g)
        return y.reshape(x.shape).to(self.dtype)


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


_STATS_FROZEN = [0]  # > 0 while a checkpointed forward is recomputed


@contextlib.contextmanager
def frozen_running_stats():
    """Within it, training-mode BatchNorms leave their running statistics
    alone: the recompute of a checkpointed forward (``remat``) must not
    update them a second time."""
    _STATS_FROZEN[0] += 1
    try:
        yield
    finally:
        _STATS_FROZEN[0] -= 1


@torch.no_grad()
def update_running_stats(bn: nn.BatchNorm2d, mean: torch.Tensor, var: torch.Tensor) -> None:
    """``bn``'s running statistics from a batch's float32 mean and biased
    variance: new = 0.9 * old + 0.1 * batch (flax momentum 0.9 is torch
    momentum 0.1), and one more ``num_batches_tracked``; nothing inside
    ``frozen_running_stats``."""
    if _STATS_FROZEN[0]:
        return
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


FLAX_MOMENTUM = 0.01  # flax nn.BatchNorm's default 0.99, as torch's momentum


def raw_bn(ch: int) -> BatchNorm:
    """A BatchNorm the JAX package builds as a bare flax ``nn.BatchNorm``
    (momentum 0.99), not through its ``BatchNorm`` wrapper (0.9)."""
    return BatchNorm(ch, momentum=FLAX_MOMENTUM)
