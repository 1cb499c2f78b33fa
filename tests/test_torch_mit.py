"""The port's MiT against the JAX MiT on the same weights, on the CPU.

Both sides run float32 with the per-op configuration (the port's
``fused_blocks=False``; the JAX package's fused-block gates are off on the
CPU; tests/test_torch_fused_blocks.py holds the fused configuration). The
four pyramid levels must agree to 1e-4: each level passes 1-2 blocks of
convs, matmuls and attention whose float32 sums are ordered differently, on
LayerNorm-scaled values of order 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_factory_tpu.convert import convert_mit
from segmentation_factory_tpu.models.backbones.mit import MiT as JaxMiT
from segmentation_factory_tpu_torch.models.backbones.mit import MIT_SETTINGS, MiT

from _torch_port import load_numpy, random_state_dict

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant,depths,size", [
    ("b0", (1, 1, 1, 1), 64),
    ("b2", (1, 1, 1, 1), 64),  # B2 widths at reduced depth
    ("b0", (1, 1, 1, 1), 50),  # not /32: the VALID sr conv drops edge pixels
])
def test_mit_levels_match_jax(variant, depths, size):
    dims = MIT_SETTINGS[variant][0]
    port = MiT(dims, depths, dtype=torch.float32, fused_blocks=False).eval()
    sd = random_state_dict(port, seed=0)
    load_numpy(port, sd)
    x = np.random.default_rng(1).normal(size=(2, size, size, 3)).astype(np.float32)

    jax_mit = JaxMiT(embed_dims=dims, depths=depths, dtype=jnp.float32)
    want = jax.jit(lambda v, img: jax_mit.apply(v, img, train=False))(
        {"params": convert_mit(sd, depths)}, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_mit_b2_settings_match_jax():
    from segmentation_factory_tpu.models.backbones import mit as jmit

    assert MIT_SETTINGS == jmit.MIT_SETTINGS
