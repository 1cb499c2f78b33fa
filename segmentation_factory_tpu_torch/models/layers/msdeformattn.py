"""MSDeformAttn, the deformable encoder layer and Mask2Former's pixel decoder.

Port of ``segmentation_factory_tpu/models/layers/msdeformattn.py``:
``_offset_bias_init`` (:27-44), ``MSDeformAttn`` (:46-92),
``reference_point_grid`` (:95-106), ``DeformableEncoderLayer`` (:109-132)
and ``MSDeformAttnPixelDecoder`` (:135-212). The core op is K9
(``ops/msdeform.py``). Feature maps are NHWC, token tensors (B, N, C).

Precision follows the JAX modules: projections in the compute dtype;
``sampling_offsets`` and ``attention_weights`` in float32 from the query
cast to float32, the softmax over L * P in float32, the locations float32;
the sampled values float32 (K9's output), cast to the query's dtype before
``output_proj``. In the pixel decoder the sine position encoding plus
``level_embed`` is added in float32 and then cast to the compute dtype, the
top ``n_levels`` maps run coarsest first, and ``mask_features`` is a
float32 1x1 conv. The input projections' and laterals' GroupNorms are
flax's raw ``nn.GroupNorm`` (eps 1e-6), the output convs' the JAX wrapper's
(``ConvModule(norm="gn")``, eps 1e-5).

Parameter names: the encoder layers keep the reference's, as the JAX
converter records them (``convert.py:795-814``): ``self_attn.{value_proj,
sampling_offsets, attention_weights, output_proj}``, ``norm1``,
``linear1``, ``linear2``, ``norm2``. The rest follow the reference
Mask2Former where it has a counterpart (``input_proj.{i}.{0,1}``,
``lateral_convs.{j}.{0,1}``, ``output_convs.{j}``, ``mask_features``) and
the JAX tree otherwise (``level_embed``, ``encoder.{i}``).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from segmentation_factory_tpu_torch.models.layers.common import resize_like
from segmentation_factory_tpu_torch.models.layers.conv import ConvModule, conv_nhwc
from segmentation_factory_tpu_torch.models.layers.norm import CastLayerNorm, GroupNorm
from segmentation_factory_tpu_torch.models.modules.position_encoding import (
    sine_position_encoding,
)
from segmentation_factory_tpu_torch.models.modules.transformer import dense
from segmentation_factory_tpu_torch.ops.msdeform import ms_deform_attn


def offset_bias(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """Deformable DETR's sampling-offset bias (M * L * P * 2,) float32: a
    unit direction per head around the circle, scaled to the unit square's
    edge, times point rank p + 1, the same at every level."""
    thetas = np.arange(n_heads) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], axis=-1)  # (M, 2)
    grid = grid / np.abs(grid).max(axis=-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for p in range(n_points):
        grid[:, :, p, :] *= p + 1
    return grid.reshape(-1).astype(np.float32)


class MSDeformAttn(nn.Module):
    """query (B, Q, C) x multi-level value (B, S, C) -> (B, Q, C). The
    offsets' and weights' kernels start at zero and the offsets' bias at
    ``offset_bias``: ``build.init_weights`` keeps them (``keep_init``)."""

    def __init__(self, dim: int = 256, n_levels: int = 4, n_heads: int = 8, n_points: int = 4,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dim, self.n_levels, self.n_heads, self.n_points = dim, n_levels, n_heads, n_points
        self.dtype = dtype
        self.value_proj = nn.Linear(dim, dim)
        self.sampling_offsets = nn.Linear(dim, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(dim, n_heads * n_levels * n_points)
        self.output_proj = nn.Linear(dim, dim)
        with torch.no_grad():
            for lin in (self.sampling_offsets, self.attention_weights):
                lin.weight.zero_()
                lin.bias.zero_()
                lin.keep_init = True
            self.sampling_offsets.bias.copy_(
                torch.from_numpy(offset_bias(n_heads, n_levels, n_points)))

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor, value: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """``reference_points`` (B, Q, L, 2) normalised, x then y."""
        b, q, _ = query.shape
        m, l, p = self.n_heads, self.n_levels, self.n_points
        v = dense(value, self.value_proj, self.dtype).reshape(b, -1, m, self.dim // m)
        qf = query.float()
        so, aw = self.sampling_offsets, self.attention_weights
        offsets = dense(qf, so, torch.float32).reshape(b, q, m, l, p, 2)
        weights = torch.softmax(dense(qf, aw, torch.float32).reshape(b, q, m, l * p), dim=-1)
        wh = torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32,
                          device=query.device)
        locs = reference_points[:, :, None, :, None, :] + offsets / wh[None, None, None, :, None]
        out = ms_deform_attn(v.contiguous(), spatial_shapes, locs.contiguous(),
                             weights.reshape(b, q, m, l, p).contiguous())
        return dense(out.to(query.dtype), self.output_proj, self.dtype)


def reference_point_grid(spatial_shapes: Sequence[Tuple[int, int]], device=None) -> torch.Tensor:
    """(S, L, 2) float32 pixel centres (x, y) of every level, normalised,
    the same for each of the L levels."""
    pts = []
    for h, w in spatial_shapes:
        ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        pts.append(torch.stack([xx, yy], dim=-1).reshape(-1, 2))
    ref = torch.cat(pts, dim=0)
    return ref[:, None, :].expand(ref.shape[0], len(spatial_shapes), 2)


class DeformableEncoderLayer(nn.Module):
    """MSDeformAttn over the levels, then LN, FFN (ReLU), LN, post-norm;
    dropout 0."""

    def __init__(self, dim: int = 256, n_heads: int = 8, n_points: int = 4, n_levels: int = 3,
                 ffn_dim: int = 1024, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.self_attn = MSDeformAttn(dim, n_levels, n_heads, n_points, dtype)
        self.norm1 = CastLayerNorm(dim, dtype)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm2 = CastLayerNorm(dim, dtype)

    def forward(self, src, pos, reference_points, spatial_shapes):
        y = self.self_attn(src + pos, reference_points, src, spatial_shapes)
        src = self.norm1(src + y)
        y = dense(torch.relu(dense(src, self.linear1, self.dtype)), self.linear2, self.dtype)
        return self.norm2(src + y)


class MSDeformAttnPixelDecoder(nn.Module):
    """The backbone pyramid (finest first, strides 4-32) -> (mask_features
    (B, H/4, W/4, mask_dim) float32, the transformer's maps coarsest first
    [res5, res4, res3] in the compute dtype)."""

    def __init__(self, channels: Sequence[int], dim: int = 256, mask_dim: int = 256,
                 n_heads: int = 8, n_points: int = 4, n_layers: int = 6, n_levels: int = 3,
                 dtype=torch.bfloat16):
        super().__init__()
        self.channels, self.dim, self.n_levels, self.dtype = list(channels), dim, n_levels, dtype
        top = self.channels[-n_levels:][::-1]
        self.input_proj = nn.ModuleList(
            nn.Sequential(nn.Conv2d(c, dim, 1), GroupNorm(dim, dtype)) for c in top)
        self.level_embed = nn.Parameter(torch.zeros(n_levels, dim))
        self.encoder = nn.ModuleList(
            DeformableEncoderLayer(dim, n_heads, n_points, n_levels, dtype=dtype)
            for _ in range(n_layers))
        low = self.channels[:len(self.channels) - n_levels][::-1]
        self.lateral_convs = nn.ModuleList(
            nn.Sequential(nn.Conv2d(c, dim, 1), GroupNorm(dim, dtype)) for c in low)
        self.output_convs = nn.ModuleList(
            ConvModule(dim, dim, 3, padding=1, norm="gn", act="relu", dtype=dtype, use_bias=True)
            for _ in low)
        self.mask_features = nn.Conv2d(dim, mask_dim, 1)

    def draw_embeddings(self, generator: torch.Generator) -> None:
        """``level_embed`` from normal(1.0) (flax ``initializers.normal``)."""
        with torch.no_grad():
            self.level_embed.copy_(torch.randn(self.level_embed.shape, generator=generator))

    def forward(self, feats: List[torch.Tensor]):
        l, dt, dim = self.n_levels, self.dtype, self.dim
        b = feats[0].shape[0]
        srcs, poss, shapes = [], [], []
        for i, f in enumerate(feats[-l:][::-1]):
            h, w = f.shape[1], f.shape[2]
            conv, gn = self.input_proj[i]
            x = gn(conv_nhwc(f, conv, "SAME", dt))
            pos = sine_position_encoding(h, w, dim // 2, device=f.device)
            srcs.append(x.reshape(b, h * w, dim))
            poss.append((pos.reshape(1, h * w, dim) + self.level_embed[i]).to(x.dtype))
            shapes.append((h, w))
        src = torch.cat(srcs, dim=1)
        pos = torch.cat([p.expand(b, -1, -1) for p in poss], dim=1)
        ref = reference_point_grid(shapes, src.device)
        ref = ref[None].expand(b, *ref.shape)
        for layer in self.encoder:
            src = layer(src, pos, ref, shapes)
        outs, off = [], 0
        for h, w in shapes:
            outs.append(src[:, off:off + h * w].reshape(b, h, w, dim))
            off += h * w
        y = outs[-1]
        for j, f in enumerate(reversed(feats[:len(feats) - l])):
            conv, gn = self.lateral_convs[j]
            lat = torch.relu(gn(conv_nhwc(f, conv, "SAME", dt)))
            y = self.output_convs[j](lat + resize_like(y, lat))
        mask_features = conv_nhwc(y.float(), self.mask_features, "SAME", torch.float32)
        return mask_features, outs
