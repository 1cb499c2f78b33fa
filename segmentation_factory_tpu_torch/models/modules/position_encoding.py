"""2-D sine position embedding.

Port of ``segmentation_factory_tpu/models/modules/position_encoding.py``
``sine_position_encoding`` (:17-45): per-axis sine / cosine at geometric
temperatures of normalised coordinates 1..H and 1..W (the reference's
cumsum over a mask that no pixel sets), y then x, in float32.
"""

from __future__ import annotations

import math

import torch


def sine_position_encoding(h: int, w: int, num_pos_feats: int = 128,
                           temperature: float = 10000.0, normalize: bool = True,
                           scale: float = 2 * math.pi, dtype=torch.float32,
                           device=None) -> torch.Tensor:
    """(H, W, 2 * num_pos_feats) embedding: the y features, then the x
    features, each sin / cos interleaved by channel pair."""
    f32 = dict(dtype=torch.float32, device=device)
    y = torch.arange(1, h + 1, **f32)[:, None].expand(h, w)
    x = torch.arange(1, w + 1, **f32)[None, :].expand(h, w)
    if normalize:
        eps = 1e-6
        y = y / (h + eps) * scale
        x = x / (w + eps) * scale
    dim_t = torch.arange(num_pos_feats, **f32)
    dim_t = torch.pow(torch.tensor(temperature, **f32), 2.0 * torch.floor(dim_t / 2.0) / num_pos_feats)

    def interleave(p):
        return torch.stack([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])],
                           dim=-1).reshape(h, w, num_pos_feats)

    pos = torch.cat([interleave(y[..., None] / dim_t), interleave(x[..., None] / dim_t)], dim=-1)
    return pos.to(dtype)
