"""PyTorch / CUDA port of ``segmentation_factory_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; this package imports
nothing of it (nor JAX) and keeps its own copies of what it needs. It holds
the serving path of MiT + SegFormerHead: the model, its weights bridge,
``predict_step`` / ``eval_step`` and the whole-image ``SemSeg`` predictor.
The four kernels of that path (SRA attention, Mix-FFN, the decode head's
upsample+sum and the final upsample+argmax) are hand-written CUDA C++ under
``ops/csrc``; each wrapper runs its plain PyTorch version on CPU tensors.

Public functions keep the JAX package's layouts: images NHWC float, logits
NHWC, label maps (B, H, W) int32. Entry points default to ``device="cuda"``
and raise when no CUDA device exists unless ``device="cpu"`` is passed.
"""

from segmentation_factory_tpu_torch.models.build import (
    SegmentationModel,
    build_model,
    default_embed_dim,
)

__all__ = ["SegmentationModel", "build_model", "default_embed_dim"]
