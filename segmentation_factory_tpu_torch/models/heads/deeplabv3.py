"""DeepLabV3 decode head: ASPP on the coarsest level, an FCN aux head on the
next one.

Port of ``segmentation_factory_tpu/models/heads/deeplabv3.py``:

- ``ASPP`` (:22-58): a 1x1 ConvModule, 3x3 ConvModules dilated at rates
  12 / 24 / 36 (padding r), an image-pool branch (the map's mean, a 1x1
  ConvModule, broadcast back), the five concatenated, a 1x1 ConvModule,
  then dropout 0.5;
- the head (:80-116): a 3x3 ConvModule on the ASPP's output, dropout 0.1,
  the float32 1x1 classifier;
- ``FCNAuxHead`` (:61-77), training only: a 3x3 ConvModule of width
  C_in // 4 on ``feats[-2]``, dropout 0.1, a float32 1x1 classifier; its
  logits are resized to the main logits' size.

Every ConvModule is conv -> BatchNorm -> ReLU. In eval the head returns the
logits (B, h/32, w/32, classes); in training ``[logits, aux]``. The three
dropouts are elementwise over (B, h, w, C) (where UPerHead and FPNHead
drop whole channels), their masks inputs: ``dropout_mask`` draws them for
given feature sizes. No TPU kernel is on this path; the loss and the
final upsample+argmax of the logits are K7 and K8 (``engine.steps``), at
an upsampling ratio of 32.

Keys follow the reference ``state_dict``: ``head.aspp.b0.{0,1}``,
``head.aspp.b{1,2,3}.block.{0,1}``, ``head.aspp.b4.gap.{1,2}``,
``head.aspp.project.{0,1}``, ``head.block.{0,1,4}`` (4: the classifier, a
1x1 conv) and ``auxlayer.block.{0,1,4}``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from segmentation_factory_tpu_torch.models.heads.upernet import classify
from segmentation_factory_tpu_torch.models.layers import (
    BatchNorm,
    ConvModule,
    conv_bn_act,
    resize,
)
from segmentation_factory_tpu_torch.registry import register_head

RATES = (12, 24, 36)
ASPP_DROPOUT = 0.5  # deeplabv3.py:57
DROPOUT = 0.1       # the head's and the aux head's (deeplabv3.py:67, :85)


def dropout_mask(shape: Sequence[int], rate: float, generator: torch.Generator,
                 device=None) -> torch.Tensor:
    """Elementwise float32 dropout mask of ``shape``: 1 / keep with
    probability keep = 1 - ``rate``, else 0."""
    keep = 1.0 - rate
    mask = torch.rand(tuple(shape), generator=generator, device=device) < keep
    return mask.float() / keep


def dropout(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """x times its mask in float32, cast back to x's dtype; None is the
    identity (eval)."""
    return x if mask is None else (x.float() * mask).to(x.dtype)


class ASPP(nn.Module):
    def __init__(self, in_ch: int, channels: int, dtype=torch.bfloat16):
        super().__init__()
        self.b0 = ConvModule(in_ch, channels, 1, dtype=dtype)
        for i, r in enumerate(RATES, start=1):
            setattr(self, f"b{i}", nn.ModuleDict({"block": ConvModule(
                in_ch, channels, 3, padding=r, dilation=r, dtype=dtype)}))
        self.b4 = nn.ModuleDict({"gap": ConvModule(in_ch, channels, 1, dtype=dtype,
                                                   keys=("1", "2"))})
        self.project = ConvModule((len(RATES) + 2) * channels, channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, h, w, _ = x.shape
        branches = [self.b0(x)]
        branches += [getattr(self, f"b{i}")["block"](x) for i in range(1, len(RATES) + 1)]
        pooled = x.float().mean((1, 2), keepdim=True).to(x.dtype)
        pooled = self.b4["gap"](pooled)
        branches.append(pooled.expand(b, h, w, pooled.shape[-1]))
        return dropout(self.project(torch.cat(branches, dim=-1)), mask)


class ConvClassifier(nn.Module):
    """3x3 ConvModule (padding 1) -> elementwise dropout -> float32 1x1
    classifier: the reference's Sequential (0 conv, 1 BatchNorm, 2 ReLU,
    3 dropout, 4 classifier)."""

    def __init__(self, in_ch: int, mid: int, num_classes: int, dtype=torch.bfloat16):
        super().__init__()
        self.add_module("0", nn.Conv2d(in_ch, mid, 3, bias=False))
        self.add_module("1", BatchNorm(mid))
        self.add_module("4", nn.Conv2d(mid, num_classes, 1))
        self.dtype = dtype

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        m = self._modules
        y = conv_bn_act(x, m["0"], m["1"], 1, "relu", self.dtype)
        return classify(dropout(y, mask), m["4"], None)


class DeepLabV3Head(nn.Module):
    def __init__(self, channels: Sequence[int], num_classes: int, embed_dim: int = 256,
                 dtype=torch.bfloat16):
        super().__init__()
        self.channels = list(channels)
        self.embed_dim = embed_dim
        self.head = nn.Module()
        self.head.aspp = ASPP(self.channels[-1], embed_dim, dtype)
        self.head.block = ConvClassifier(embed_dim, embed_dim, num_classes, dtype)
        self.auxlayer = nn.Module()
        aux_in = self.channels[-2]
        self.auxlayer.block = ConvClassifier(aux_in, aux_in // 4, num_classes, dtype)

    def dropout_mask(self, batch: int, generator: torch.Generator, device=None,
                     sizes: Optional[Sequence[Tuple[int, int]]] = None) -> List:
        """The three elementwise masks, drawn from ``generator`` for the
        backbone's feature ``sizes`` ((h, w) per level): the ASPP's and
        the head's (B, h, w, E) at the coarsest level, the aux head's
        (B, h', w', C' // 4) at the next."""
        if sizes is None:
            raise ValueError("DeepLabV3's dropout is elementwise: its masks need the "
                             "feature sizes")
        (h, w), (h2, w2) = sizes[-1], sizes[-2]
        e = self.embed_dim
        return [dropout_mask((batch, h, w, e), ASPP_DROPOUT, generator, device),
                dropout_mask((batch, h, w, e), DROPOUT, generator, device),
                dropout_mask((batch, h2, w2, self.channels[-2] // 4), DROPOUT, generator,
                             device)]

    def forward(self, feats: List[torch.Tensor], dmask: Optional[Sequence] = None):
        """feats: NHWC pyramid, finest first. ``dmask``: the three masks of
        ``dropout_mask`` in training, None in eval. Returns the float32
        logits at the coarsest level, in training with the aux head's
        logits resized to them: ``[logits, aux]``."""
        if len(feats) != len(self.channels):
            raise ValueError(f"expected {len(self.channels)} levels, got {len(feats)}")
        m_aspp, m_head, m_aux = dmask if dmask is not None else (None, None, None)
        logits = self.head.block(self.head.aspp(feats[-1], m_aspp), m_head)
        if not self.training:
            return logits
        aux = self.auxlayer.block(feats[-2], m_aux)
        return [logits, resize(aux, (logits.shape[1], logits.shape[2]))]


@register_head("deeplabv3")
def _deeplabv3_head(channels, num_classes, embed_dim=256, dtype=torch.bfloat16):
    return DeepLabV3Head(channels, num_classes, embed_dim=embed_dim, dtype=dtype)
