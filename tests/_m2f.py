"""Shared helpers of tests/test_torch_mask2former.py and
tests/test_torch_mask_loss.py: seeded numpy weights for a JAX Mask2Former
tree (its shapes from ``jax.eval_shape``, no initialisation compiled) and
the no-noise training inputs of the port."""

import jax
import numpy as np
import torch

from segmentation_factory_tpu.models.layers.msdeformattn import _offset_bias_init


def random_tree(shapes, seed: int, offset_scale: float = 0.1):
    """numpy float32 leaves for a tree of ``ShapeDtypeStruct``s: kernels
    ~ N(0, 1/fan_in), biases ~ N(0, 0.1^2), norm scales ~ 1 + N(0, 0.1^2),
    embeddings (``level_embed``, ``query_feat``, ``query_embed``) ~ N(0, 1);
    MSDeformAttn's ``sampling_offsets`` kernel ~ N(0, offset_scale^2) over
    its point-grid bias (samples a few pixels from the reference points)
    and its ``attention_weights`` kernel ~ N(0, 0.05^2)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        names = [getattr(k, "key", str(k)) for k in path]
        shape, name = tuple(s.shape), names[-1]
        parent = names[-2] if len(names) > 1 else ""
        if name in ("level_embed", "query_feat", "query_embed"):
            v = rng.normal(size=shape)
        elif parent == "sampling_offsets" and name == "kernel":
            v = offset_scale * rng.normal(size=shape)
        elif parent == "sampling_offsets":
            m, l, p = _grid_dims(names, shape)
            v = np.asarray(_offset_bias_init(m, l, p)(None, shape)) + 0.1 * rng.normal(size=shape)
        elif parent == "attention_weights" and name == "kernel":
            v = 0.05 * rng.normal(size=shape)
        elif name == "kernel":
            v = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.1 * rng.normal(size=shape)
        else:
            v = 0.1 * rng.normal(size=shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _grid_dims(names, shape):
    """(heads, levels, points) of a sampling-offset bias: 8 heads, 4
    points, the levels from its size (the head's default MSDeformAttn)."""
    return 8, shape[0] // (8 * 4 * 2), 4


def no_noise(model, batch: int):
    """The port's training noise with nothing dropped: drop-path factors of
    ones, no head dropout mask."""
    return {"drop_path": torch.ones((len(model.backbone.blocks()), 2, batch)), "dropout": None}
