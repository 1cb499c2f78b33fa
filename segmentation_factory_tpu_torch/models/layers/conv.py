"""Convolutions on NHWC maps, and ``ConvModule`` (conv -> norm -> act).

Port of ``segmentation_factory_tpu/models/layers/common.py`` ``ConvModule``
(:30-75) and ``SqueezeExcite`` (:94-110), and of flax ``nn.Conv``'s padding. Feature maps stay NHWC as in
the JAX package; a convolution sees them as channels-last NCHW views, so
cuDNN may keep the channels-last layout, and its output is made contiguous
NHWC (a no-op where cuDNN wrote channels last). Weights are float32 and
cast to the compute dtype at each call, as flax's ``dtype``.

Padding is an int (the same on every side), a per-axis pair, or ``"SAME"``:
flax's default, the total ``max((out - 1) * stride + window - in, 0)`` with
``total // 2`` before and the rest after, so at a size the stride does not
divide the extra row or column goes at the bottom / right.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from segmentation_factory_tpu_torch.models.layers.act import build_act
from segmentation_factory_tpu_torch.models.layers.norm import BatchNorm, GroupNorm

Padding = Union[str, int, Tuple[int, int]]


def same_pads(n: int, kernel: int, stride: int, dilation: int = 1) -> Tuple[int, int]:
    """flax / lax ``SAME`` padding (before, after) of one axis of length n."""
    window = (kernel - 1) * dilation + 1
    out = -(-n // stride)
    total = max((out - 1) * stride + window - n, 0)
    return total // 2, total - total // 2


def conv_nhwc(x: torch.Tensor, conv: nn.Conv2d, padding: Padding, dtype) -> torch.Tensor:
    """``conv`` (its stride, dilation and groups; weights cast to ``dtype``)
    on the NHWC map ``x`` with ``padding``; a contiguous NHWC result in
    ``dtype``."""
    y = x.to(dtype).permute(0, 3, 1, 2)
    if padding == "SAME":
        (t, b), (l, r) = [same_pads(n, k, s, d) for n, k, s, d in zip(
            y.shape[2:], conv.kernel_size, conv.stride, conv.dilation)]
        pad = 0
        if t != b or l != r:
            y = F.pad(y, (l, r, t, b))
        else:
            pad = (t, l)
    else:
        pad = padding
    bias = None if conv.bias is None else conv.bias.to(dtype)
    y = F.conv2d(y, conv.weight.to(dtype), bias, conv.stride, pad, conv.dilation, conv.groups)
    return y.permute(0, 2, 3, 1).contiguous()


def conv_bn_act(x: torch.Tensor, conv: nn.Conv2d, bn: Optional[nn.Module], padding: Padding,
                act: Optional[str], dtype) -> torch.Tensor:
    """``conv_nhwc``, then ``bn`` (if any), then the activation named ``act``
    (if any): the body of ``ConvModule``, for modules that hold their conv
    and norm under other names."""
    y = conv_nhwc(x, conv, padding, dtype)
    if bn is not None:
        y = bn(y)
    fn = build_act(act)
    return y if fn is None else fn(y)


NORMS = {"bn": lambda ch, dtype: BatchNorm(ch),
         # the JAX wrapper GroupNorm (layers/norm.py:99-109): 32 groups, eps 1e-5
         "gn": lambda ch, dtype: GroupNorm(ch, dtype, eps=1e-5)}


class ConvModule(nn.Module):
    """conv -> norm -> activation, NHWC in and out, in the compute dtype
    (``common.py:30-76``). ``norm``: True or ``"bn"`` (BatchNorm, the
    default), ``"gn"`` (GroupNorm, 32 groups, eps 1e-5), False / None
    (none). The conv has a bias when ``use_bias`` says so, by default only
    without a norm; ``dilation`` dilates its kernel (DeepLabV3's ASPP).
    ``keys`` names the conv and the norm in the ``state_dict``: the
    reference's Sequential (``0``, ``1``) by default; timm's
    ``ConvNormAct`` takes ``("conv", "bn")``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 1, stride: int = 1,
                 padding: Padding = "SAME", groups: int = 1, norm=True,
                 act: Optional[str] = "relu", dtype=torch.bfloat16,
                 keys: Sequence[str] = ("0", "1"), use_bias: Optional[bool] = None,
                 dilation: int = 1):
        super().__init__()
        self.keys = tuple(keys)
        norm = "bn" if norm is True else norm or None
        if norm is not None and norm not in NORMS:
            raise KeyError(f"unknown norm {norm!r}; available: {sorted(NORMS)}")
        bias = norm is None if use_bias is None else use_bias
        self.add_module(self.keys[0], nn.Conv2d(in_ch, out_ch, kernel, stride, groups=groups,
                                                bias=bias, dilation=dilation))
        if norm is not None:
            self.add_module(self.keys[1], NORMS[norm](out_ch, dtype))
        build_act(act)  # an unknown name raises here, not at the first forward
        self.padding, self.act, self.dtype = padding, act, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_bn_act(x, self._modules[self.keys[0]], self._modules.get(self.keys[1]),
                           self.padding, self.act, self.dtype)


class SqueezeExcite(nn.Module):
    """Squeeze-and-excitation of an NHWC map (``common.py:94-110``): the
    mean over (H, W), a 1x1 conv with bias to ``reduced`` channels, ``act``,
    a 1x1 conv with bias back to ``channels``, the ``gate`` activation, and
    the map times that gate, in the compute dtype. ``keys`` name the two
    convs in the ``state_dict``."""

    def __init__(self, channels: int, reduced: int, gate: str = "hsigmoid", act: str = "relu",
                 dtype=torch.bfloat16, keys: Sequence[str] = ("fc1", "fc2")):
        super().__init__()
        self.keys = tuple(keys)
        self.add_module(self.keys[0], nn.Conv2d(channels, reduced, 1))
        self.add_module(self.keys[1], nn.Conv2d(reduced, channels, 1))
        self.gate, self.act, self.dtype = build_act(gate), build_act(act), dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.float().mean((1, 2), keepdim=True).to(x.dtype)
        s = self.act(conv_nhwc(s, self._modules[self.keys[0]], 0, self.dtype))
        s = self.gate(conv_nhwc(s, self._modules[self.keys[1]], 0, self.dtype))
        return x * s
