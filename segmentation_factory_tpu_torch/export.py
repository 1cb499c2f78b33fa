"""Model export: the eval forward as a ``torch.export`` program in a ``.pt2``.

The port's counterpart of ``segmentation_factory_tpu/export.py``
``export_model`` (:26), ``load_exported`` (:55) and ``validate_export``
(:201). The JAX package serialises StableHLO with a symbolic batch; here
``torch.export.export`` traces ``model(images)`` (the logits resized to the
input, as ``model.apply(..., train=False)``) at a dynamic batch
``Dim("b")``, under ``no_grad`` and in eval mode, so every kernel wrapper
takes its no-gradient branch: a registered ``sft::`` op
(``ops/sra_attention.py``, ``mixffn.py``, ``block.py``, ``resize_sum.py``).
The program holds those ops, not their plain versions, and runs the
kernels on the card and the plain versions on the CPU. The SavedModel and
ONNX routes of the JAX module need TensorFlow or onnx and are not ported.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from segmentation_factory_tpu_torch.device import model_device

BF16_ATOL = 5e-2  # the JAX export CLI's bf16 bound (export_model.py)
F32_REL = 1e-4    # float32: 1e-4 of the largest live logit


class _EvalForward(torch.nn.Module):
    """``model(images)`` with the logits resized to the input."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.model(images, resize_output=True)


def export_model(model: torch.nn.Module, img_size: int, out_path: str,
                 dynamic_batch: bool = True, batch: int = 1):
    """Trace the eval forward of ``model`` on float32 images
    (B, img_size, img_size, 3), B dynamic unless ``dynamic_batch`` is False
    (then ``batch``), and write it to ``out_path`` with
    ``torch.export.save``. Returns the ``ExportedProgram``. The model is put
    in eval mode."""
    model.eval()
    example = torch.zeros((2 if dynamic_batch else batch, img_size, img_size, 3),
                          dtype=torch.float32, device=model_device(model))
    dims = ({0: torch.export.Dim("b", min=1)},) if dynamic_batch else None
    with torch.no_grad():
        program = torch.export.export(_EvalForward(model), (example,), dynamic_shapes=dims)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    torch.export.save(program, out_path)
    return program


def load_exported(path: str):
    """The ``ExportedProgram`` saved at ``path``; call it as
    ``program.module()(images)``. Its graph holds the port's ``sft::`` ops,
    so ``segmentation_factory_tpu_torch`` must be importable in the loading
    process: its ops are registered here before the program is read."""
    import segmentation_factory_tpu_torch.ops  # noqa: F401  (registers the sft:: ops)

    return torch.export.load(path)


def validate_export(model: torch.nn.Module, path: str, img_size: int, batch: int = 2,
                    atol: Optional[float] = None) -> Tuple[bool, float]:
    """The saved program against the live ``model`` on seeded normal
    images of ``batch``: (ok, max |difference| of the logits). The bound is
    ``atol`` when given, else 5e-2 for a bfloat16 model (the JAX export
    CLI's) and 1e-4 of the largest live logit for a float32 one."""
    program = load_exported(path)
    dev = model_device(model)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(batch, img_size, img_size, 3)).astype(np.float32)).to(dev)
    model.eval()
    with torch.inference_mode():
        live = model(x).float()
        got = program.module()(x).float()
    diff = float((live - got).abs().max())
    if atol is None:
        bf16 = model.decode_head.dtype == torch.bfloat16
        atol = BF16_ATOL if bf16 else F32_REL * float(live.abs().max())
    return diff <= atol, diff
