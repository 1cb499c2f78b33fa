"""SegFormer all-MLP decode head.

Port of ``segmentation_factory_tpu/models/heads/segformer.py``. The default
(``fused=True``) is the folded ``_LevelFuse`` (:101-134): levels and their
projections in reversed order (top level first); level i's slice of the
1x1 fuse conv (input channels ``i*E:(i+1)*E``) folds into its projection
as ``K_i W_i`` and ``b_i W_i`` in float32, cast to the compute dtype, and the
projected levels meet in one upsample+sum (K5f/K5b, ``resize_sum``). Then
BatchNorm and ReLU, in training a per-(image, channel) dropout mask scaled
by 1 / keep (nn.Dropout with broadcast_dims=(1, 2), p = 0.1), and the
classifier in float32. In training the folded head runs that tail as one
op, K6f/K6b (``ops.head_tail.head_tail_train``, the JAX gate at :198-220
without its TPU-only conditions), and updates the BatchNorm's running
statistics from the batch statistics it returns; in eval, and with
``fused=False``, the tail is the unfused composition of :224-232
(``tail``). The mask is an input (``dropout_mask`` draws one from a
``torch.Generator``). ``fused=False`` is the reference dataflow (project,
upsample, concat 4E wide, fuse), kept as the fold's oracle.

Keys follow the reference ``state_dict``: ``linear_c{i}.proj``,
``linear_fuse.{conv,bn}``, ``linear_pred`` (a 1x1 conv).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from segmentation_factory_tpu_torch.models.layers import BatchNorm, resize
from segmentation_factory_tpu_torch.models.layers.norm import update_running_stats
from segmentation_factory_tpu_torch.ops.head_tail import head_tail_train
from segmentation_factory_tpu_torch.ops.resize_sum import resize_sum
from segmentation_factory_tpu_torch.registry import register_head

DROPOUT = 0.1  # channel dropout of the head (segformer.py:173)


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

    def dropout_mask(self, batch: int, generator: torch.Generator, device=None,
                     sizes=None) -> torch.Tensor:
        """(batch, E) float32 channel-dropout mask drawn from ``generator``:
        1 / keep with probability keep = 1 - ``DROPOUT``, else 0."""
        keep = 1.0 - DROPOUT
        mask = torch.rand((batch, self.embed_dim), generator=generator, device=device) < keep
        return mask.float() / keep

    def forward(self, feats: List[torch.Tensor],
                dmask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """feats: NHWC pyramid, finest first -> (B, H/4, W/4, NC) float32.
        ``dmask``: the (B, E) dropout mask in training, None in eval; the
        BatchNorm follows the module's training flag; a training forward of
        the folded head runs the fused tail (K6), with a mask of ones when
        ``dmask`` is None."""
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
            if self.training:
                bn = self.linear_fuse.bn
                if dmask is None:
                    dmask = torch.ones((acc.shape[0], e), device=acc.device)
                logits, mean, var = head_tail_train(
                    acc, bn.weight, bn.bias, dmask, self.linear_pred.weight,
                    self.linear_pred.bias, bn.eps)
                update_running_stats(bn, mean, var)
                return logits
        else:
            th, tw = feats[0].shape[1], feats[0].shape[2]
            ups = [resize(F.linear(y.to(dt), lin.weight.to(dt), lin.bias.to(dt)), (th, tw))
                   for y, lin in zip(levels, projs)]
            acc = torch.cat(ups, dim=-1) @ w.to(dt)
        return self.tail(acc, dmask)

    def tail(self, acc: torch.Tensor, dmask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """BatchNorm (batch statistics in training) -> ReLU -> the channel
        dropout mask, if any -> the float32 classifier (segformer.py:224-232)."""
        x = torch.relu(self.linear_fuse.bn(acc))
        if dmask is not None:
            x = (x.float() * dmask[:, None, None, :]).to(x.dtype)
        return F.linear(x.float(), self.linear_pred.weight[:, :, 0, 0].float(),
                        self.linear_pred.bias.float())


@register_head("segformerhead")
def _segformer_head(channels, num_classes, embed_dim=256, dtype=torch.bfloat16, **kwargs):
    return SegFormerHead(channels, num_classes, embed_dim=embed_dim, dtype=dtype, **kwargs)
