"""The port's seeded weights against flax's ``lecun_normal`` on the same
shapes: a normal truncated at +-2 std, rescaled so that its variance is
1/fan_in, biases 0.

The two frameworks draw different numbers, so the test compares the
distributions: the cut (no |w| above 2 std of the truncated normal before
its rescale), the variance (1/fan_in within a sampling tolerance) and the
fan-in. Variance tolerance: the sample variance of n draws of a normal cut
at +-2 std has a relative standard deviation below (2/n)^0.5 (its fourth
moment is below the normal's), so 5 (2/n)^0.5 fails a correct draw with
probability under 1e-6; both frameworks' draws are held to it.
"""

import jax
import numpy as np
import pytest
import torch

from segmentation_factory_tpu_torch import build_model
from segmentation_factory_tpu_torch.models.build import TRUNC_STD, init_weights

from _torch_port import two_torch_threads  # noqa: F401  (autouse)

# (module name in MiT-B0 + SegFormerHead, flax kernel shape, flax fan-in)
MODULES = [
    ("backbone.block1.0.mlp.fc1", (32, 128), 32),                     # Linear
    ("backbone.patch_embed1.proj", (7, 7, 3, 32), 147),               # patch conv
    ("backbone.block1.0.mlp.dwconv.dwconv", (3, 3, 1, 128), 9),       # depthwise conv
    ("decode_head.linear_fuse.conv", (1, 1, 1024, 256), 1024),        # head's 1x1 conv
]


@pytest.fixture(scope="module")
def model():
    return build_model("mit_b0", "segformerhead", 19, dtype=torch.float32, device="cpu", seed=3)


def _check_draw(w: np.ndarray, fan_in: int) -> None:
    std = fan_in ** -0.5 / TRUNC_STD  # std of the normal before its cut
    assert np.abs(w).max() <= 2 * std * (1 + 1e-6)
    tol = 5 * (2 / w.size) ** 0.5
    assert abs(w.var() * fan_in - 1) <= tol, (w.var() * fan_in, tol)
    assert abs(w.mean()) * fan_in ** 0.5 <= 5 / w.size ** 0.5


@pytest.mark.parametrize("name,flax_shape,fan_in", MODULES)
def test_init_matches_lecun_normal(model, name, flax_shape, fan_in):
    mod = dict(model.named_modules())[name]
    w = mod.weight.detach().numpy()
    assert mod.weight[0].numel() == fan_in
    assert int(np.prod(flax_shape)) == w.size
    _check_draw(w.astype(np.float64), fan_in)
    if mod.bias is not None:
        assert not mod.bias.detach().abs().max().item()
    ref = jax.nn.initializers.lecun_normal()(jax.random.PRNGKey(0), flax_shape, np.float32)
    _check_draw(np.asarray(ref, np.float64), fan_in)


def test_init_is_seeded_and_cut_everywhere(model):
    """Every Linear / Conv kernel of the model is cut at 2 std; the same
    seed gives the same weights."""
    again = build_model("mit_b0", "segformerhead", 19, dtype=torch.float32, device="cpu", seed=3)
    for (name, a), b in zip(model.named_modules(), again.modules()):
        if isinstance(a, (torch.nn.Linear, torch.nn.Conv2d)):
            std = a.weight[0].numel() ** -0.5 / TRUNC_STD
            assert a.weight.abs().max().item() <= 2 * std * (1 + 1e-6), name
            assert torch.equal(a.weight, b.weight), name
    init_weights(again, torch.Generator().manual_seed(4))
    assert not torch.equal(again.backbone.block1[0].mlp.fc1.weight,
                           model.backbone.block1[0].mlp.fc1.weight)
