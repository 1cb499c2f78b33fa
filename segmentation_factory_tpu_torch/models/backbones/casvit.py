"""CAS-ViT (RCViT): convolutional additive self-attention backbone.

Port of ``segmentation_factory_tpu/models/backbones/casvit.py`` (:30-155):
a stem of two 3x3 / 2 ConvModules (their convs keep a bias before the
BatchNorm), four stages of ``AdditiveBlock``s with a 3x3 / 2 conv +
BatchNorm downsample before stages 2-4, and a BatchNorm on each stage's
output. A block: a local residual (1x1 conv, BatchNorm, depthwise 3x3,
GELU, 1x1 conv), then BatchNorm -> ``AdditiveTokenMixer`` and BatchNorm ->
MLP (4x, GELU) residuals, each scaled by its drop-path factor (an input:
``drop_path_factors``, (blocks, 2, batch)). The mixer: a 1x1 qkv conv;
q and k each through a spatial gate (x * sigmoid(1x1(relu(BN(dw3x3(x))))))
and a channel gate (x * sigmoid(1x1(mean over H, W))); out =
proj(dwc(q + k) * v), both depthwise 3x3. GELU is the tanh form (flax's
``nn.gelu``). No TPU kernel is on this path.

The BatchNorms the JAX package creates as flax ``nn.BatchNorm`` (``norm1``,
``norm2``, the local one, the downsamples' and the outputs') keep flax's
default momentum 0.99 (torch momentum 0.01); those inside ConvModules (the
stem, the spatial gates) 0.9.

Keys follow the reference's ``state_dict``: ``patch_embed.{0,1,3,4}``,
``network.{2s}.{j}`` (stage s's blocks: ``local_perception.network.{0,1,2,4}``,
``norm1``, ``attn.{qkv, oper_q.0.block.{0,1,3}, oper_q.1.block.1, oper_k...,
dwc, proj}``, ``norm2``, ``mlp.{fc1, fc2}`` (1x1 convs)),
``network.{2s+1}.{proj, norm}`` (the downsamples) and ``norm{2s}`` (the
outputs).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from segmentation_factory_tpu_torch.models.layers import (
    BatchNorm,
    container,
    conv_bn_act,
    conv_nhwc,
    drop_path,
    drop_path_factor,
    drop_path_rates,
    raw_bn,
)
from segmentation_factory_tpu_torch.models.layers.act import gelu_tanh
from segmentation_factory_tpu_torch.registry import register_backbone

CASVIT_SETTINGS = {
    # name: (layers, embed_dims)
    "xs": ([2, 2, 4, 2], [48, 56, 112, 220]),
    "s": ([3, 3, 6, 3], [48, 64, 128, 256]),
    "m": ([3, 3, 6, 3], [64, 96, 192, 384]),
    "t": ([3, 3, 6, 3], [96, 128, 256, 512]),
}

def _dw(ch: int) -> nn.Conv2d:
    return nn.Conv2d(ch, ch, 3, padding=1, groups=ch)


class SpatialOperation(nn.Module):
    """x * sigmoid(1x1(relu(BN(dw3x3(x))))): ``block.{0,1,3}``."""

    def __init__(self, ch: int, dtype=torch.bfloat16):
        super().__init__()
        self.block = container(**{"0": _dw(ch), "1": BatchNorm(ch),
                                  "3": nn.Conv2d(ch, 1, 1, bias=False)})
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self.block._modules
        a = conv_bn_act(x, m["0"], m["1"], 1, "relu", self.dtype)
        return x * torch.sigmoid(conv_nhwc(a, m["3"], 0, self.dtype))


class ChannelOperation(nn.Module):
    """x * sigmoid(1x1(mean over H, W of x)): ``block.1``."""

    def __init__(self, ch: int, dtype=torch.bfloat16):
        super().__init__()
        self.block = container(**{"1": nn.Conv2d(ch, ch, 1, bias=False)})
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = x.float().mean((1, 2), keepdim=True).to(x.dtype)
        return x * torch.sigmoid(conv_nhwc(a, self.block._modules["1"], 0, self.dtype))


class AdditiveTokenMixer(nn.Module):
    def __init__(self, ch: int, dtype=torch.bfloat16):
        super().__init__()
        self.qkv = nn.Conv2d(ch, 3 * ch, 1, bias=False)
        self.oper_q = nn.Sequential(SpatialOperation(ch, dtype), ChannelOperation(ch, dtype))
        self.oper_k = nn.Sequential(SpatialOperation(ch, dtype), ChannelOperation(ch, dtype))
        self.dwc, self.proj = _dw(ch), _dw(ch)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = conv_nhwc(x, self.qkv, 0, self.dtype).chunk(3, dim=-1)
        y = conv_nhwc(self.oper_q(q) + self.oper_k(k), self.dwc, 1, self.dtype) * v
        return conv_nhwc(y, self.proj, 1, self.dtype)


def _linear(x: torch.Tensor, conv: nn.Conv2d, dtype) -> torch.Tensor:
    """A 1x1 conv on NHWC ``x`` as the Dense the JAX package runs, in
    ``dtype``."""
    return F.linear(x.to(dtype), conv.weight[:, :, 0, 0].to(dtype), conv.bias.to(dtype))


class AdditiveBlock(nn.Module):
    def __init__(self, ch: int, mlp_ratio: float = 4.0, drop_path_rate: float = 0.0,
                 dtype=torch.bfloat16):
        super().__init__()
        self.local_perception = container(network=container(**{
            "0": nn.Conv2d(ch, ch, 1), "1": raw_bn(ch), "2": _dw(ch), "4": nn.Conv2d(ch, ch, 1)}))
        self.norm1 = raw_bn(ch)
        self.attn = AdditiveTokenMixer(ch, dtype)
        self.norm2 = raw_bn(ch)
        hidden = int(ch * mlp_ratio)
        self.mlp = container(fc1=nn.Conv2d(ch, hidden, 1), fc2=nn.Conv2d(hidden, ch, 1))
        self.drop_path_rate, self.dtype = drop_path_rate, dtype

    def forward(self, x: torch.Tensor, factors: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``factors``: (2, B) drop-path factors of the mixer and the MLP
        branch, or None (eval, or a rate of 0)."""
        dt = self.dtype
        m = self.local_perception.network._modules
        y = conv_bn_act(x, m["0"], m["1"], 0, None, dt)
        y = conv_nhwc(gelu_tanh(conv_nhwc(y, m["2"], 1, dt)), m["4"], 0, dt)
        x = x + y
        f = (None, None) if factors is None else factors
        x = x + drop_path(self.attn(self.norm1(x)), f[0])
        y = _linear(gelu_tanh(_linear(self.norm2(x), self.mlp.fc1, dt)), self.mlp.fc2, dt)
        return x + drop_path(y, f[1])


class RCViT(nn.Module):
    def __init__(self, layers: Sequence[int], embed_dims: Sequence[int],
                 drop_path_rate: float = 0.0, dtype=torch.bfloat16):
        super().__init__()
        dims = list(embed_dims)
        self.patch_embed = container(**{
            "0": nn.Conv2d(3, dims[0] // 2, 3, 2, 1), "1": BatchNorm(dims[0] // 2),
            "3": nn.Conv2d(dims[0] // 2, dims[0], 3, 2, 1), "4": BatchNorm(dims[0])})
        rates = drop_path_rates(drop_path_rate, layers)
        net = {}
        for s in range(4):
            if s > 0:
                net[str(2 * s - 1)] = container(proj=nn.Conv2d(dims[s - 1], dims[s], 3, 2, 1),
                                                norm=raw_bn(dims[s]))
            net[str(2 * s)] = nn.ModuleList(AdditiveBlock(dims[s], drop_path_rate=r, dtype=dtype)
                                            for r in rates[s])
            self.add_module(f"norm{2 * s}", raw_bn(dims[s]))
        self.network = container(**net)
        self.dtype = dtype

    def blocks(self) -> List[AdditiveBlock]:
        return [b for s in range(4) for b in self.network._modules[str(2 * s)]]

    def drop_path_factors(self, batch: int, generator: torch.Generator,
                          device=None) -> torch.Tensor:
        """(blocks, 2, batch) float32 factors, each block's two at its rate."""
        return torch.stack([torch.stack([drop_path_factor(blk.drop_path_rate, batch, generator,
                                                          device) for _ in range(2)])
                            for blk in self.blocks()])

    def forward(self, x: torch.Tensor, factors: Optional[torch.Tensor] = None
                ) -> List[torch.Tensor]:
        dt, pe, net = self.dtype, self.patch_embed._modules, self.network._modules
        x = conv_bn_act(x, pe["0"], pe["1"], 1, "relu", dt)
        x = conv_bn_act(x, pe["3"], pe["4"], 1, "relu", dt)
        feats, i = [], 0
        for s in range(4):
            if s > 0:
                down = net[str(2 * s - 1)]
                x = conv_bn_act(x, down.proj, down.norm, 1, None, dt)
            for blk in net[str(2 * s)]:
                x = blk(x, None if factors is None else factors[i])
                i += 1
            feats.append(getattr(self, f"norm{2 * s}")(x))
        return feats


def _make_rcvit(variant: str):
    def factory(dtype=torch.bfloat16, img_size: int = 512, drop_path_rate: float = 0.0):
        layers, dims = CASVIT_SETTINGS[variant]
        return RCViT(layers, dims, drop_path_rate=drop_path_rate, dtype=dtype), list(dims)

    return factory


for _v in CASVIT_SETTINGS:
    register_backbone(f"rcvit_{_v}")(_make_rcvit(_v))
