"""Shared by the port's serving-CLI tests (``test_torch_cli*.py``): one
MiT-B0 + SegFormerHead (4 classes, float32) on the same weights in both
packages, the port's copy in a checkpoint directory of its own format; the
CLIs switched to float32; the tie rule of the comparisons.
"""

import types

import jax.numpy as jnp
import pytest
import torch

from segmentation_factory_tpu.convert import convert_full_model
from segmentation_factory_tpu.models import build_model as jax_build_model
from segmentation_factory_tpu_torch import build_model, export_model, predict, validate
from segmentation_factory_tpu_torch.checkpoint import CheckpointManager

from _torch_port import load_numpy, random_state_dict

NC, SIZE, GAP, PROB_GAP = 4, 64, 1e-4, 1e-5
NO_OPTIMIZER = types.SimpleNamespace(state_dict=dict)
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def float32_clis(monkeypatch):
    """The CLIs compute in bfloat16, as the pinned configs do; the JAX side
    of these comparisons is float32 (autouse where imported)."""
    for cli in (validate, predict, export_model):
        monkeypatch.setattr(cli, "DTYPE", torch.float32)


def save(directory, step, model, metrics):
    CheckpointManager(str(directory)).save(step, model, NO_OPTIMIZER, metrics)


@pytest.fixture(scope="module")
def b0(tmp_path_factory):
    """(checkpoint directory of the port's weights, JAX model, JAX
    variables) on the same weights."""
    port = build_model("mit_b0", "segformerhead", NC, dtype=torch.float32, device="cpu")
    sd = random_state_dict(port, seed=21)
    load_numpy(port, sd)
    ckpt = tmp_path_factory.mktemp("ckpt")
    save(ckpt, 3, port, {"mIoU": 1.0})
    jmodel = jax_build_model("mit_b0", "segformerhead", NC, dtype=jnp.float32)
    return str(ckpt), jmodel, convert_full_model(sd, "mit_b0", "segformerhead")
