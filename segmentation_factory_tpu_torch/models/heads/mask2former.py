"""Mask2Former head: the MSDeformAttn pixel decoder and the masked decoder.

Port of ``segmentation_factory_tpu/models/heads/mask2former.py``
(``Mask2FormerHead``, :31-71), registered as ``mask2formerhead``. The width
is ``max(embed_dim, 128)`` with 8 heads; 6 pixel-decoder layers (K9 in
each), 9 decoder layers and 100 queries by default. In eval, and in
training without ``mask_loss``, it returns the semantic log-probabilities
log(clip(sum_q softmax(class) * sigmoid(mask), 1e-6, 1)) (B, H/4, W/4, K)
in float32, so that CE and dice (K7) and the argmax (K8) take them as
logits; in training with ``mask_loss`` the decoder's dict, for
``losses_mask.mask2former_loss``. Every dropout of this head has rate 0,
so ``dropout_mask`` draws nothing.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from segmentation_factory_tpu_torch.models.layers.mask_decoders import (
    MultiScaleMaskedTransformerDecoder,
    semantic_inference,
)
from segmentation_factory_tpu_torch.models.layers.msdeformattn import MSDeformAttnPixelDecoder
from segmentation_factory_tpu_torch.registry import register_head


class Mask2FormerHead(nn.Module):
    def __init__(self, channels: Sequence[int], num_classes: int, embed_dim: int = 256,
                 num_queries: int = 100, pixel_layers: int = 6, decoder_layers: int = 9,
                 mask_loss: bool = False, dtype=torch.bfloat16):
        super().__init__()
        dim = max(embed_dim, 128)
        self.channels, self.dtype, self.mask_loss = list(channels), dtype, mask_loss
        self.pixel_decoder = MSDeformAttnPixelDecoder(self.channels, dim=dim, mask_dim=dim,
                                                      n_layers=pixel_layers, dtype=dtype)
        self.transformer_decoder = MultiScaleMaskedTransformerDecoder(
            num_classes, dim=dim, num_queries=num_queries, num_layers=decoder_layers,
            mask_dim=dim, dtype=dtype)

    def dropout_mask(self, batch: int, generator: torch.Generator, device=None,
                     sizes=None) -> None:
        """No random mask: every dropout of the head has rate 0."""
        return None

    def forward(self, feats: List[torch.Tensor], dmask: Optional[torch.Tensor] = None):
        """feats: NHWC pyramid, finest first. ``dmask`` is ignored (None)."""
        if len(feats) != len(self.channels):
            raise ValueError(f"expected {len(self.channels)} levels, got {len(feats)}")
        mask_features, ms_feats = self.pixel_decoder(feats)
        out = self.transformer_decoder(ms_feats, mask_features)
        if self.training and self.mask_loss:
            return out
        sem = semantic_inference(out["pred_logits"], out["pred_masks"])
        return torch.log(sem.clamp(1e-6, 1.0))


@register_head("mask2formerhead")
def _mask2former_head(channels, num_classes, embed_dim=256, dtype=torch.bfloat16, **kwargs):
    return Mask2FormerHead(channels, num_classes, embed_dim=embed_dim, dtype=dtype, **kwargs)
