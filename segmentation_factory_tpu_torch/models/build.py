"""SegmentationModel: backbone x head composer.

Port of ``segmentation_factory_tpu/models/build.py``: backbone -> decode
head -> (optionally) bilinear upsample of the logits to the input size.
Parameters are float32; ``dtype`` is the compute dtype (bfloat16 by
default, as the JAX ``build_model``); the classifier runs in float32. The
forward follows ``module.training`` (the JAX ``train`` flag): in training
the BatchNorm takes batch statistics, and drop-path and head dropout take
their random factors from ``noise`` or, without it, from ``generator``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from segmentation_factory_tpu_torch.device import resolve_device
from segmentation_factory_tpu_torch.models.layers import resize
from segmentation_factory_tpu_torch.registry import get_backbone, get_head


def default_embed_dim(backbone_name: str) -> int:
    """The reference's head-width rule (build_models.py:43-54): MiT B0/B1
    -> 256, other MiT -> 768; other names with 'tiny'/'small' -> 128, the
    rest -> 768."""
    name = backbone_name.lower()
    if name.startswith("mit_"):
        return 256 if name in ("mit_b0", "mit_b1") else 768
    if "tiny" in name or "small" in name:
        return 128
    return 768


class SegmentationModel(nn.Module):
    """NHWC image (B, H, W, 3) float -> (B, H, W, num_classes) float32.
    ``fused_blocks``: the backbone's configuration (the fused half-block
    kernels, or per-op; ``models/backbones/mit.py``)."""

    def __init__(self, backbone_name: str, head_name: str, num_classes: int,
                 embed_dim: Optional[int] = None, dtype=torch.bfloat16,
                 fused_blocks: bool = True):
        super().__init__()
        self.num_classes = num_classes
        self.backbone, channels = get_backbone(backbone_name, dtype=dtype,
                                               fused_blocks=fused_blocks)
        self.decode_head = get_head(
            head_name, channels=channels, num_classes=num_classes,
            embed_dim=embed_dim or default_embed_dim(backbone_name), dtype=dtype,
        )

    def sample_noise(self, batch: int, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """The training forward's random inputs, drawn from ``generator`` (on
        the model's device): ``drop_path`` (blocks, 2, batch) factors and the
        head's ``dropout`` (batch, E) mask."""
        dev = generator.device
        return {"drop_path": self.backbone.drop_path_factors(batch, generator, dev),
                "dropout": self.decode_head.dropout_mask(batch, generator, dev)}

    def forward(self, x: torch.Tensor, resize_output: bool = True, *,
                generator: Optional[torch.Generator] = None,
                noise: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """``resize_output=False`` returns head-resolution logits, for the
        fused upsample+loss and upsample+argmax of ``engine.steps``. In
        training the drop-path factors and dropout mask come from ``noise``
        (``sample_noise``'s layout) or are drawn from ``generator``; in eval
        both are ignored."""
        if not self.training:
            noise = None
        elif noise is None:
            if generator is None:
                raise ValueError("a training forward needs `generator` or `noise`")
            noise = self.sample_noise(x.shape[0], generator)
        feats = self.backbone(x, None if noise is None else noise["drop_path"])
        logits = self.decode_head(feats, None if noise is None else noise["dropout"])
        if not resize_output:
            return logits
        return resize(logits, (x.shape[1], x.shape[2]))


# std of a unit normal truncated at +-2 (jax.nn.initializers.variance_scaling)
TRUNC_STD = 0.87962566103423978


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded weights as flax's ``lecun_normal`` draws them: every Linear
    and Conv kernel from a normal truncated at +-2 std, with std =
    (1/fan_in)^0.5 / 0.87962566 (the std of the unit normal cut at +-2), so
    that the variance is 1/fan_in; fan_in = ``weight[0].numel()`` (9 for the
    depthwise conv, as flax's (3, 3, 1, C) kernel). Biases 0; norms keep
    scale 1, bias 0 and the running statistics 0 / 1."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                std = mod.weight[0].numel() ** -0.5 / TRUNC_STD
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()


def build_model(backbone: str, head: str, num_classes: int,
                embed_dim: Optional[int] = None, dtype=torch.bfloat16,
                device="cuda", seed: int = 0, fused_blocks: bool = True) -> SegmentationModel:
    """The model in eval mode on ``device`` (raises if that is CUDA and no
    card is present), weights drawn from ``seed``. ``fused_blocks=False``
    runs MiT per-op instead of through the fused half-block kernels; both
    configurations take the same weights."""
    dev = resolve_device(device)
    model = SegmentationModel(backbone, head, num_classes, embed_dim=embed_dim,
                              dtype=dtype, fused_blocks=fused_blocks)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
