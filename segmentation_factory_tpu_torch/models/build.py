"""SegmentationModel: backbone x head composer.

Port of ``segmentation_factory_tpu/models/build.py``: backbone -> decode
head -> (optionally) bilinear upsample of the logits to the input size.
Parameters are float32; ``dtype`` is the compute dtype (bfloat16 by
default, as the JAX ``build_model``); the classifier runs in float32. The
forward follows ``module.training`` (the JAX ``train`` flag): in training
the BatchNorm takes batch statistics, and drop-path and head dropout take
their random factors from ``noise`` or, without it, from ``generator``.
A head that returns a dict (Mask2Former's mask-classification outputs in
training with ``mask_loss``) is returned as it is, unresized
(``build.py:84-87``); one that returns a list (``[main] + aux``:
DeepLabV3's aux head) gives ``main`` in eval and the list in training,
each resized to the input unless ``resize_output=False``
(``build.py:89-95``). ``remat`` checkpoints the backbone's training forward
(``build.py:77-81``, ``nn.remat``): its activations are recomputed in the
backward, with the same drop-path factors and without a second update of
the BatchNorm running statistics. ``img_size`` is the square input size
the model is built for (the JAX package initialises its variables at
(1, img_size, img_size, 3)): it sizes RandomMixing's matrices and KAT's
``pos_embed`` (every backbone factory takes it; the other backbones have
no such state). ``backbone_kwargs`` go to the backbone's factory
(``build.py:45,54-57``): CrossFormer's ``cel`` / ``use_cpe`` /
``group_type``, iFormer's ``use_reparam``, KAT's ``pyramid_adapter``, a
family's ``drop_path_rate``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from segmentation_factory_tpu_torch.device import resolve_device
from segmentation_factory_tpu_torch.models.layers import resize
from segmentation_factory_tpu_torch.models.layers.norm import frozen_running_stats
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
    ``fused_blocks``: MiT's configuration (the fused half-block kernels, or
    per-op; ``models/backbones/mit.py``); None takes the backbone's default.
    Other backbones have no such choice and raise when given one.
    ``head_kwargs`` go to the head's factory (``build.py:59-66``), e.g.
    ``{"mask_loss": True}`` for Mask2Former, ``backbone_kwargs`` to the
    backbone's. ``remat`` checkpoints the backbone in training.
    ``img_size`` goes to the backbone's factory (MetaFormer's sizes
    RandomMixing's token counts by it, KAT its ``pos_embed``)."""

    def __init__(self, backbone_name: str, head_name: str, num_classes: int,
                 embed_dim: Optional[int] = None, dtype=torch.bfloat16,
                 fused_blocks: Optional[bool] = None,
                 head_kwargs: Optional[Mapping] = None, remat: bool = False,
                 img_size: int = 512, backbone_kwargs: Optional[Mapping] = None):
        super().__init__()
        self.num_classes = num_classes
        self.remat = remat
        bkw = {"img_size": img_size, **dict(backbone_kwargs or {})}
        if fused_blocks is not None:
            if not backbone_name.lower().startswith("mit_"):
                raise ValueError(f"fused_blocks is a choice of MiT; {backbone_name} has none")
            bkw["fused_blocks"] = fused_blocks
        self.backbone, channels = get_backbone(backbone_name, dtype=dtype, **bkw)
        self.decode_head = get_head(
            head_name, channels=channels, num_classes=num_classes,
            embed_dim=embed_dim or default_embed_dim(backbone_name), dtype=dtype,
            **dict(head_kwargs or {}))

    def feature_sizes(self, h: int, w: int) -> List[Tuple[int, int]]:
        """The backbone's four (h, w) for an (h, w) input: its own rule
        where it has one (MetaFormer's stem), else strides 4 to 32 rounding
        up (the SAME / half-padded convs of the other backbones)."""
        own = getattr(self.backbone, "feature_sizes", None)
        if own is not None:
            return own(h, w)
        return [(-(-h // s), -(-w // s)) for s in (4, 8, 16, 32)]

    def sample_noise(self, batch: int, generator: torch.Generator,
                     size: Optional[Tuple[int, int]] = None) -> Dict[str, torch.Tensor]:
        """The training forward's random inputs, drawn from ``generator`` (on
        the model's device): the backbone's ``drop_path`` factors (MiT and
        MetaFormer (blocks, 2, batch), ConvNeXt (blocks, batch); none for a
        backbone without drop-path) and the head's ``dropout`` mask (UPerHead,
        FPNHead and SegFormerHead (batch, E); None for a head without
        dropout; DeepLabV3's three elementwise masks, which need the input
        ``size`` (h, w) for the feature sizes)."""
        dev = generator.device
        noise = {}
        if hasattr(self.backbone, "drop_path_factors"):
            noise["drop_path"] = self.backbone.drop_path_factors(batch, generator, dev)
        sizes = None if size is None else self.feature_sizes(*size)
        noise["dropout"] = self.decode_head.dropout_mask(batch, generator, dev, sizes=sizes)
        return noise

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
            noise = self.sample_noise(x.shape[0], generator, (x.shape[1], x.shape[2]))
        drop_path = None if noise is None else noise.get("drop_path")
        if self.remat and self.training:
            feats = checkpoint(self.backbone, x, drop_path, use_reentrant=False,
                               context_fn=_recompute_context)
        else:
            feats = self.backbone(x, drop_path)
        logits = self.decode_head(feats, None if noise is None else noise["dropout"])
        if isinstance(logits, dict):
            return logits
        size = (x.shape[1], x.shape[2])
        if isinstance(logits, (list, tuple)):  # [main] + aux outputs
            main, aux = logits[0], list(logits[1:])
            if not (self.training and aux):
                return main if not resize_output else resize(main, size)
            return [main] + aux if not resize_output else [resize(o, size)
                                                           for o in [main] + aux]
        return logits if not resize_output else resize(logits, size)


def _recompute_context():
    """The forward runs as it is; its recompute leaves the BatchNorm
    running statistics alone."""
    return contextlib.nullcontext(), frozen_running_stats()


# std of a unit normal truncated at +-2 (jax.nn.initializers.variance_scaling)
TRUNC_STD = 0.87962566103423978


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded weights as flax's ``lecun_normal`` draws them: every Linear
    and Conv kernel from a normal truncated at +-2 std, with std =
    (1/fan_in)^0.5 / 0.87962566 (the std of the unit normal cut at +-2), so
    that the variance is 1/fan_in; fan_in = ``weight[0].numel()`` (9 for the
    depthwise conv, as flax's (3, 3, 1, C) kernel). Biases 0; norms keep
    scale 1, bias 0 and the running statistics 0 / 1; a module's own
    parameters (ConvNeXt's layer scale) keep what the module set, and so do
    the Linears it marks ``keep_init`` (MSDeformAttn's zero offset and
    weight kernels, its point-grid bias); a module's ``draw_embeddings``
    draws its embeddings (Mask2Former's ``level_embed``, ``query_feat``,
    ``query_embed``: normal(1.0); KAT's ``pos_embed``: normal(0.02)) from
    ``generator`` in module order. A transposed conv's fan_in is its input
    channels times its window (flax's (kh, kw, in, out) kernel)."""
    with torch.no_grad():
        for mod in model.modules():
            if hasattr(mod, "draw_embeddings"):
                mod.draw_embeddings(generator)
            if (isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d))
                    and not getattr(mod, "keep_init", False)):
                fan_in = mod.weight[0].numel()
                if isinstance(mod, nn.ConvTranspose2d):  # weight (in, out, kh, kw)
                    fan_in = mod.weight.shape[0] * mod.weight[0, 0].numel()
                std = fan_in ** -0.5 / TRUNC_STD
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()


def build_model(backbone: str, head: str, num_classes: int,
                embed_dim: Optional[int] = None, dtype=torch.bfloat16,
                device="cuda", seed: int = 0, fused_blocks: Optional[bool] = None,
                head_kwargs: Optional[Mapping] = None, remat: bool = False,
                img_size: int = 512, backbone_kwargs: Optional[Mapping] = None
                ) -> SegmentationModel:
    """The model in eval mode on ``device`` (raises if that is CUDA and no
    card is present), weights drawn from ``seed``. ``fused_blocks=False``
    runs MiT per-op instead of through the fused half-block kernels (its
    default); both configurations take the same weights. ``head_kwargs``
    go to the head (``{"mask_loss": True}``: Mask2Former trains on its
    Hungarian mask-classification loss). ``remat`` checkpoints the
    backbone's training forward. ``img_size``: the square input size the
    model is built for (RandomMixing's matrices; the Trainer passes its
    crop, ``SemSeg`` its ``img_size``; KAT's ``pos_embed`` grid).
    ``backbone_kwargs`` go to the backbone's factory (e.g. ``{"use_reparam":
    False}`` for iFormer)."""
    dev = resolve_device(device)
    model = SegmentationModel(backbone, head, num_classes, embed_dim=embed_dim,
                              dtype=dtype, fused_blocks=fused_blocks, head_kwargs=head_kwargs,
                              remat=remat, img_size=img_size, backbone_kwargs=backbone_kwargs)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
