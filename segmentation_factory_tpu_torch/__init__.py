"""PyTorch / CUDA port of ``segmentation_factory_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; this package imports
nothing of it (nor JAX) and keeps its own copies of what it needs. It holds
the main path of MiT + SegFormerHead: the model and its weights bridge, the
serving steps and the whole-image ``SemSeg`` predictor, the training step
with its losses, optimizer and schedule, and the ``engine.loop.Trainer``
with its data pipeline, eval protocols, checkpoints and CLI
(``python -m segmentation_factory_tpu_torch.train``), the serving CLIs
(``validate``, ``predict``, ``export_model``) and the ``torch.export`` of
the eval forward (``export.py``). The kernels of that
path — one for every Pallas kernel of the JAX package — are hand-written
CUDA C++ under ``ops/csrc``; each wrapper runs its plain PyTorch version on
CPU tensors.

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
