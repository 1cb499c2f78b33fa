"""SegFormer all-MLP decode head, eval forward.

Port of ``segmentation_factory_tpu/models/heads/segformer.py``. The default
(``fused=True``) is the folded ``_LevelFuse`` (:101-134): levels and their
projections in reversed order (top level first); level i's slice of the
1x1 fuse conv (input channels ``i*E:(i+1)*E``) folds into its projection
as ``K_i W_i`` and ``b_i W_i`` in float32, cast to the compute dtype, and the
projected levels meet in one upsample+sum (K5, ``resize_sum``). Then eval
BatchNorm and ReLU (dropout is the identity in eval) and the classifier in
float32. ``fused=False`` is the reference dataflow (project, upsample,
concat 4E wide, fuse), kept as the fold's oracle.

Keys follow the reference ``state_dict``: ``linear_c{i}.proj``,
``linear_fuse.{conv,bn}``, ``linear_pred`` (a 1x1 conv).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from segmentation_factory_tpu_torch.models.layers import BatchNorm, resize
from segmentation_factory_tpu_torch.ops.resize_sum import resize_sum
from segmentation_factory_tpu_torch.registry import register_head


class LinearProj(nn.Module):
    """Per-level projection holder (key ``linear_c{i}.proj``)."""

    def __init__(self, in_ch: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Linear(in_ch, embed_dim)


class FuseModule(nn.Module):
    """1x1 fuse conv without bias + BatchNorm (keys ``linear_fuse.{conv,bn}``)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 1, bias=False)
        self.bn = BatchNorm(out_ch)


class SegFormerHead(nn.Module):
    def __init__(self, channels: Sequence[int], num_classes: int, embed_dim: int = 256,
                 dtype=torch.bfloat16, fused: bool = True):
        super().__init__()
        self.channels = list(channels)
        self.embed_dim = embed_dim
        self.dtype = dtype
        self.fused = fused
        for i, c in enumerate(self.channels, start=1):
            setattr(self, f"linear_c{i}", LinearProj(c, embed_dim))
        self.linear_fuse = FuseModule(len(self.channels) * embed_dim, embed_dim)
        self.linear_pred = nn.Conv2d(embed_dim, num_classes, 1)

    def forward(self, feats: List[torch.Tensor]) -> torch.Tensor:
        """feats: NHWC pyramid, finest first -> (B, H/4, W/4, NC) float32."""
        if len(feats) != len(self.channels):
            raise ValueError(f"expected {len(self.channels)} levels, got {len(feats)}")
        dt, e = self.dtype, self.embed_dim
        levels = feats[::-1]
        projs = [getattr(self, f"linear_c{i}").proj
                 for i in range(len(self.channels), 0, -1)]
        w = self.linear_fuse.conv.weight[:, :, 0, 0].t()  # (L*E, E), JAX layout
        if self.fused:
            zs = []
            for i, (y, lin) in enumerate(zip(levels, projs)):
                wi = w[i * e:(i + 1) * e].float()
                m = (lin.weight.t().float() @ wi).to(dt)  # (C_i, E)
                c = (lin.bias.float() @ wi).to(dt)
                zs.append(y.to(dt) @ m + c)
            acc = resize_sum(zs)
        else:
            th, tw = feats[0].shape[1], feats[0].shape[2]
            ups = [resize(F.linear(y.to(dt), lin.weight.to(dt), lin.bias.to(dt)), (th, tw))
                   for y, lin in zip(levels, projs)]
            acc = torch.cat(ups, dim=-1) @ w.to(dt)
        x = torch.relu(self.linear_fuse.bn(acc))
        return F.linear(x.float(), self.linear_pred.weight[:, :, 0, 0].float(),
                        self.linear_pred.bias.float())


@register_head("segformerhead")
def _segformer_head(channels, num_classes, embed_dim=256, dtype=torch.bfloat16, **kwargs):
    return SegFormerHead(channels, num_classes, embed_dim=embed_dim, dtype=dtype, **kwargs)
