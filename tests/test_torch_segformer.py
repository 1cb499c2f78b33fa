"""The port's SegFormerHead against the JAX head and against its own
unfolded reference dataflow, on the CPU, float32, same weights.

The folded head reorders float32 sums (K W products, the upsample before
the fuse matmul) of values of order 1 over a 4E-wide contraction, hence
1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_factory_tpu.convert import convert_segformer_head
from segmentation_factory_tpu.models.heads.segformer import SegFormerHead as JaxHead
from segmentation_factory_tpu_torch.models.heads.segformer import SegFormerHead

from _torch_port import load_numpy, random_state_dict, two_torch_threads  # noqa: F401  (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)
CHANNELS = [32, 64, 160, 256]


def _feats(sizes, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, s, s, c)).astype(np.float32) for s, c in zip(sizes, CHANNELS)]


@pytest.mark.parametrize("sizes", [
    (16, 8, 4, 2),  # a 64-px input's pyramid
    (13, 7, 4, 2),  # a 50-px input's: non-dyadic
])
def test_head_matches_jax_and_unfused(sizes):
    port = SegFormerHead(CHANNELS, num_classes=5, embed_dim=64, dtype=torch.float32).eval()
    sd = random_state_dict(port, seed=0)
    load_numpy(port, sd)
    unfused = load_numpy(SegFormerHead(CHANNELS, 5, embed_dim=64, dtype=torch.float32,
                                       fused=False).eval(), sd)
    feats = _feats(sizes)

    params, stats = convert_segformer_head(sd)
    jax_head = JaxHead(channels=CHANNELS, num_classes=5, embed_dim=64, dtype=jnp.float32)
    want = jax.jit(lambda v, f: jax_head.apply(v, f, train=False))(
        {"params": params, "batch_stats": stats}, [jnp.asarray(f) for f in feats])

    tf = [torch.from_numpy(f) for f in feats]
    with torch.no_grad():
        got = port(tf)
        oracle = unfused(tf)
    assert got.shape == (2, sizes[0], sizes[0], 5) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), **TOL)


def test_head_bf16_keeps_fp32_classifier():
    port = SegFormerHead(CHANNELS, 5, embed_dim=64, dtype=torch.bfloat16).eval()
    with torch.no_grad():
        out = port([torch.from_numpy(f) for f in _feats((16, 8, 4, 2))])
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
