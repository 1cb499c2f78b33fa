"""Shared by the port's training-slice tests (``test_torch_train*.py``):
MiT-B0 + SegFormerHead weights from numpy in both packages, the port's model
on them, random batches, and the no-noise setting (drop-path and dropout
off on both sides).
"""

import numpy as np
import pytest
import torch

from segmentation_factory_tpu.convert import convert_full_model
from segmentation_factory_tpu_torch import build_model

from _torch_port import random_state_dict

NC = 19
NO_NOISE = dict(backbone_kwargs={"drop_path_rate": 0.0}, head_kwargs={"dropout": 0.0})


def no_noise(model, batch=2):
    """Drop-path factors and dropout mask of ones: rates 0 on the port side."""
    return {"drop_path": torch.ones((len(model.backbone.blocks()), 2, batch)),
            "dropout": torch.ones((batch, model.decode_head.embed_dim))}


def normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    """MiT-B0 + SegFormerHead weights as numpy (the port's state_dict) and as
    JAX variables."""
    port = build_model("mit_b0", "segformerhead", NC, dtype=torch.float32, device="cpu",
                        fused_blocks=False)
    sd = random_state_dict(port, seed=3)
    return sd, convert_full_model(sd, "mit_b0", "segformerhead")


def port_model(sd):
    model = build_model("mit_b0", "segformerhead", NC, dtype=torch.float32, device="cpu",
                        fused_blocks=False)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    return model


def batches(n, seed, size=64):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        img = normal(rng, (2, size, size, 3))
        lbl = rng.integers(0, NC, (2, size, size)).astype(np.int32)
        lbl[:, :4] = 255
        out.append((img, lbl))
    return out
