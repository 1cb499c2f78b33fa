"""EfficientViT-Seg decode head.

Port of ``segmentation_factory_tpu/models/heads/efficientvitseg.py``
(:30-117): 1x1 ConvModules (BatchNorm, no activation) on the top three
levels, each resized by torch's bicubic to the stride-8 level and summed
(stride 8 first, then 16, then 32); a chain of residual MBConvs (the
b presets, hswish) or FusedMBConvs (the L presets, GELU); an optional
final-expand 1x1 ConvModule; elementwise dropout (its mask an input; the
presets' rate is 0, so none); the float32 1x1 classifier. The logits stay
at stride 8: the loss and the final upsample+argmax are K7 and K8
(``engine.steps``) at an upsampling ratio of 8.

Registered as ``efficientvitseghead`` (width ``embed_dim``) and as the six
presets ``efficientvitseg_{b0,b1,b2,b3,l1,l2}``, which pin their width.

Keys follow the reference's SegHead ``state_dict``: ``input_ops.{0,1,2}``
for the stride-32, -16 and -8 levels (``input_ops.{0,1}.op_list.0``: the
reference wraps those two with their upsample; ``input_ops.2`` a plain
ConvLayer), ``middle.op_list.{j}.main``, ``output_ops.0.op_list``: the
final expand (if any) then the classifier ``{conv}``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from segmentation_factory_tpu_torch.models.backbones.efficientvit import (
    OpSequential,
    Residual,
    conv_layer,
    fused_mb_conv,
    mb_conv,
)
from segmentation_factory_tpu_torch.models.heads.deeplabv3 import dropout, dropout_mask
from segmentation_factory_tpu_torch.models.layers import resize_torch_bicubic
from segmentation_factory_tpu_torch.registry import register_head


class Classifier(nn.Module):
    """The float32 1x1 classifier with bias (the reference's ConvLayer
    ``{conv}``)."""

    def __init__(self, in_ch: int, num_classes: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.float(), self.conv.weight[:, :, 0, 0].float(), self.conv.bias.float())


class EfficientViTSegHead(nn.Module):
    def __init__(self, channels: Sequence[int], num_classes: int, embed_dim: int = 128,
                 middle_depth: int = 3, middle_op: str = "mbconv", expand_ratio: float = 4.0,
                 final_expand: Optional[float] = 4.0, act: str = "hswish", dropout: float = 0.0,
                 dtype=torch.bfloat16):
        super().__init__()
        e = embed_dim
        self.channels, self.embed_dim, self.rate, self.dtype = list(channels), e, dropout, dtype
        top = self.channels[-3:]
        self.input_ops = nn.ModuleList(
            [OpSequential([conv_layer(c, e, dtype=dtype)]) for c in top[:0:-1]]
            + [conv_layer(top[0], e, dtype=dtype)])
        if middle_op == "mbconv":
            middle = [mb_conv(e, e, 1, expand_ratio, acts=(act, act, None), dtype=dtype)
                      for _ in range(middle_depth)]
        elif middle_op == "fmbconv":
            middle = [fused_mb_conv(e, e, 1, expand_ratio, acts=(act, None), dtype=dtype)
                      for _ in range(middle_depth)]
        else:
            raise KeyError(middle_op)
        self.middle = OpSequential([Residual(m) for m in middle])
        out = []
        width = e
        if final_expand is not None:
            width = int(e * final_expand)
            out.append(conv_layer(e, width, act=act, dtype=dtype))
        out.append(Classifier(width, num_classes))
        self.output_ops = nn.ModuleList([OpSequential(out)])

    def dropout_mask(self, batch: int, generator: torch.Generator, device=None,
                     sizes: Optional[Sequence[Tuple[int, int]]] = None):
        """The elementwise mask (B, h, w, width) at the stride-8 level's size
        (``sizes[-3]``), or None at rate 0 (every preset)."""
        if self.rate == 0.0:
            return None
        if sizes is None:
            raise ValueError("the head's dropout is elementwise: its mask needs the "
                             "feature sizes")
        h, w = sizes[-3]
        return dropout_mask((batch, h, w, self.output_ops[0].op_list[-1].conv.in_channels),
                            self.rate, generator, device)

    def forward(self, feats: List[torch.Tensor],
                dmask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """feats: NHWC pyramid, finest first -> float32 logits at the size of
        ``feats[-3]`` (stride 8)."""
        if len(feats) < 3:
            raise ValueError(f"expected at least 3 levels, got {len(feats)}")
        size = (feats[-3].shape[1], feats[-3].shape[2])
        fused = None
        for op, f in zip(reversed(self.input_ops), feats[-3:]):
            y = resize_torch_bicubic(op(f), size)
            fused = y if fused is None else fused + y
        fused = self.middle(fused)
        *expand, classifier = self.output_ops[0].op_list
        for op in expand:
            fused = op(fused)
        return classifier(dropout(fused, dmask))


@register_head("efficientvitseghead")
def _evit_seg_head(channels, num_classes, embed_dim=128, dtype=torch.bfloat16, **kwargs):
    return EfficientViTSegHead(channels, num_classes, embed_dim=embed_dim, dtype=dtype, **kwargs)


SEG_PRESETS = {
    # name: (head_width, head_depth, middle_op, expand_ratio, final_expand, act)
    "efficientvitseg_b0": (32, 1, "mbconv", 4.0, 4.0, "hswish"),
    "efficientvitseg_b1": (64, 3, "mbconv", 4.0, 4.0, "hswish"),
    "efficientvitseg_b2": (96, 3, "mbconv", 4.0, 4.0, "hswish"),
    "efficientvitseg_b3": (128, 3, "mbconv", 4.0, 4.0, "hswish"),
    "efficientvitseg_l1": (256, 3, "fmbconv", 1.0, None, "gelu"),
    "efficientvitseg_l2": (256, 5, "fmbconv", 1.0, None, "gelu"),
}


def _make_seg_preset(width, depth, op, expand, final, act):
    def factory(channels, num_classes, dtype=torch.bfloat16, **kwargs):
        kwargs.pop("embed_dim", None)  # the preset pins the head width
        return EfficientViTSegHead(channels, num_classes, embed_dim=width, middle_depth=depth,
                                   middle_op=op, expand_ratio=expand, final_expand=final,
                                   act=act, dtype=dtype, **kwargs)

    return factory


for _n, _cfg in SEG_PRESETS.items():
    register_head(_n)(_make_seg_preset(*_cfg))
