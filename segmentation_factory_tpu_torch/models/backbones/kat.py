"""KAT: the Kolmogorov-Arnold Transformer (a ViT whose FFN is a rational KAN).

Port of ``segmentation_factory_tpu/models/backbones/kat.py`` (:1-237): a
16x16 / 16 patch embedding (flax ``SAME``), a learned position embedding
sized by the token grid the model is built for and resampled by
``jax.image.resize``'s bicubic at any other grid (``resample_pos_embed``),
and ``depth`` blocks of LayerNorm -> multi-head self-attention ->
residual, LayerNorm -> rational -> Linear 4x -> rational -> Linear ->
residual (``KANBlock``), each branch scaled by its drop-path factor (an
input: ``drop_path_factors``, (blocks, 2, batch)). The blocks at depth
quarters are tapped, the last after the final LayerNorm; a ViTDet-style
adapter (``pyramid_adapter``, the default) turns them into strides 4, 8,
16 and 32: two 2x2 / 2 transposed convs with a LayerNorm and GELU (tanh)
between them, one transposed conv, the tap itself, a 2x2 / 2 conv
(``SAME``).

The rational ``RationalActivation`` is P5(x) / (1 + |Q4(x)|) in float32
per group of c / 8 contiguous channels, by Horner's rule in the JAX
order, cast back; |Q| is written so that its gradient at Q = 0 is 1, as
``jax.grad(jnp.abs)(0.0)`` is (torch's ``abs`` gives 0 there): the first
rational starts as the identity with Q = 0. The reference runs it as a
CUDA extension; the JAX package as XLA elementwise math, outside Pallas,
so no TPU kernel is on this path, and neither is the attention: flax's
``MultiHeadDotProductAttention`` (q divided by sqrt(d) in the compute
dtype before q kᵀ, softmax in the compute dtype), here ``torch.matmul``.

Keys follow the reference's ``state_dict`` (the JAX ``convert_kat``,
``convert.py:1168-1252``): ``patch_embed.proj``, ``pos_embed`` (the grid's
(N, D) tokens, without the reference's class token),
``blocks.{i}.{norm1, attn.{qkv, proj}, norm2, mlp.{act1, fc1, act2,
fc2}}`` (``qkv`` fused, [q | k | v], heads major within each; the
rationals' ``weight_numerator`` (8, 6) and ``weight_denominator`` (8, 4))
and ``norm``. The adapter, which only the JAX package has, takes the JAX
names: ``up2a``, ``up2b``, ``up1``, ``down1`` and ``up2a_norm`` (flax's
``LayerNorm_0``); its transposed convs hold torch's (in, out, kh, kw)
kernel, flax's spatially flipped (``convert.from_jax_variables``).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from segmentation_factory_tpu_torch.models.layers import (
    CastLayerNorm,
    conv_nhwc,
    drop_path,
    drop_path_factor,
    drop_path_rates,
    resample_weights,
    rounded,
)
from segmentation_factory_tpu_torch.models.layers.act import gelu_tanh
from segmentation_factory_tpu_torch.models.modules.transformer import dense
from segmentation_factory_tpu_torch.registry import register_backbone

KAT_SETTINGS = {
    # name: (embed dim, depth, heads)
    "tiny": (192, 12, 3),
    "small": (384, 12, 6),
    "base": (768, 12, 12),
}
PATCH = 16
GROUPS = 8


@lru_cache(maxsize=4)
def fit_rational_to(act_name: str, p_order: int = 5, q_order: int = 4):
    """(a, b) float32 of P(x) / (1 + |Q(x)|) fitted to ``act_name`` on [-4,
    4] by the JAX package's least squares (``_fit_rational_to``, :38-71):
    the identity exactly, GELU (tanh) and swish by 20 Sanathanan-Koerner
    iterations."""
    if act_name == "identity":
        a = np.zeros(p_order + 1, np.float32)
        a[1] = 1.0
        return a, np.zeros(q_order, np.float32)
    xs = np.linspace(-4.0, 4.0, 2001)
    if act_name == "gelu":
        ys = 0.5 * xs * (1.0 + np.tanh(np.sqrt(2 / np.pi) * (xs + 0.044715 * xs ** 3)))
    elif act_name == "swish":
        ys = xs / (1.0 + np.exp(-xs))
    else:
        raise KeyError(act_name)
    A = np.stack([xs ** i for i in range(p_order + 1)], axis=-1)  # noqa: N806
    Aq = np.stack([xs ** i for i in range(1, q_order + 1)], axis=-1)  # noqa: N806
    w = np.ones_like(xs)
    a = np.zeros(p_order + 1)
    b = np.zeros(q_order)
    for _ in range(20):
        m = np.concatenate([A * w[:, None], -(ys * w)[:, None] * Aq], axis=1)
        sol, *_ = np.linalg.lstsq(m, ys * w, rcond=None)
        a, b = sol[: p_order + 1], sol[p_order + 1:]
        w = 1.0 / np.maximum(np.abs(1.0 + Aq @ b), 1e-3)
    return a.astype(np.float32), b.astype(np.float32)


def abs_jax(q: torch.Tensor) -> torch.Tensor:
    """|q| whose gradient at 0 is 1, as ``jax.grad(jnp.abs)(0.0)``."""
    return torch.where(q >= 0, q, -q)


class RationalActivation(nn.Module):
    """Group-wise learnable P5(x) / (1 + |Q4(x)|), Q without a constant
    term, each of 8 groups of contiguous channels its own coefficients."""

    def __init__(self, base_act: str = "gelu", groups: int = GROUPS):
        super().__init__()
        a0, b0 = fit_rational_to(base_act)
        # torch.tensor, not from_numpy: built under a torch.device context the
        # coefficients are made on that device, as every other parameter
        self.weight_numerator = nn.Parameter(torch.tensor(np.tile(a0, (groups, 1))))
        self.weight_denominator = nn.Parameter(torch.tensor(np.tile(b0, (groups, 1))))
        self.groups = groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c, g = x.shape[-1], self.groups
        xf = x.float().reshape(*x.shape[:-1], g, c // g)
        ar = self.weight_numerator.flip(-1)[..., None]  # (g, 6, 1): a5 first
        br = self.weight_denominator.flip(-1)[..., None]
        p = ar[:, 0].expand(xf.shape)
        for i in range(1, ar.shape[1]):
            p = p * xf + ar[:, i]
        q = br[:, 0].expand(xf.shape)
        for i in range(1, br.shape[1]):
            q = q * xf + br[:, i]
        q = q * xf
        return (p / (1.0 + abs_jax(q))).reshape(x.shape).to(x.dtype)


def resample_pos_embed(pos: torch.Tensor, grid_hw: Tuple[int, int]) -> torch.Tensor:
    """A (N, D) embedding of a square grid resized to ``grid_hw`` as
    ``jax.image.resize(..., "bicubic")`` does (``resample_weights``: Keys'
    cubic with a = -0.5, antialiased when it shrinks), in float32, cast
    back to ``pos``'s dtype (:110-127). Unchanged when N is h·w."""
    h, w = grid_hw
    n, d = pos.shape
    if n == h * w:
        return pos
    gs = math.isqrt(n)
    if gs * gs != n:
        raise ValueError(f"pos_embed token count {n} is not a square grid")
    wy = resample_weights(gs, h, pos.device, "bicubic")
    wx = resample_weights(gs, w, pos.device, "bicubic")
    out = torch.einsum("ij,jkd,lk->ild", wy, pos.float().reshape(gs, gs, d), wx)
    return out.reshape(h * w, d).to(pos.dtype)


class Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` of x with itself: q, k, v from
    one Linear ([q | k | v], heads major), q / sqrt(d) and the scores'
    softmax in the compute dtype, a Linear back."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.bfloat16):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.num_heads, self.dtype = num_heads, dtype
        self.depth_root = rounded(math.sqrt(dim // num_heads), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        dt, nh = self.dtype, self.num_heads
        q, k, v = dense(x, self.qkv, dt).reshape(b, n, 3, nh, c // nh).permute(2, 0, 3, 1, 4)
        attn = torch.softmax(torch.matmul(q / self.depth_root, k.transpose(-1, -2)), dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, c)
        return dense(out, self.proj, dt)


class KANMlp(nn.Module):
    """rational (identity at init) -> fc1 -> rational (the base activation)
    -> fc2."""

    def __init__(self, dim: int, hidden: int, base_act: str):
        super().__init__()
        self.act1 = RationalActivation("identity")
        self.fc1 = nn.Linear(dim, hidden)
        self.act2 = RationalActivation(base_act)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        return dense(self.act2(dense(self.act1(x), self.fc1, dtype)), self.fc2, dtype)


class KANBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.0, base_act: str = "gelu", dtype=torch.bfloat16):
        super().__init__()
        self.norm1 = CastLayerNorm(dim, dtype)
        self.attn = Attention(dim, num_heads, dtype)
        self.norm2 = CastLayerNorm(dim, dtype)
        self.mlp = KANMlp(dim, int(dim * mlp_ratio), base_act)
        self.drop_path_rate, self.dtype = drop_path_rate, dtype

    def forward(self, x: torch.Tensor, factors: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``factors``: (2, B) drop-path factors of the two branches, or None."""
        f = (None, None) if factors is None else factors
        x = x + drop_path(self.attn(self.norm1(x)), f[0])
        return x + drop_path(self.mlp(self.norm2(x), self.dtype), f[1])


class KATVisionTransformer(nn.Module):
    """NHWC image -> 4 NHWC levels of ``embed_dim`` channels (strides 4 to
    32 with the adapter; the normed stride-16 map alone without it).
    ``img_size``: the square input the model is built for, which sizes
    ``pos_embed``."""

    def __init__(self, embed_dim: int, depth: int, num_heads: int, base_act: str = "gelu",
                 drop_path_rate: float = 0.0, pyramid_adapter: bool = True,
                 dtype=torch.bfloat16, img_size: int = 512):
        super().__init__()
        self.dtype, self.depth, self.pyramid_adapter = dtype, depth, pyramid_adapter
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, embed_dim, PATCH, PATCH)
        grid = -(-img_size // PATCH)
        self.pos_embed = nn.Parameter(torch.zeros(grid * grid, embed_dim))
        rates = drop_path_rates(drop_path_rate, [depth])[0]
        self.blocks = nn.ModuleList(KANBlock(embed_dim, num_heads, drop_path_rate=r,
                                             base_act=base_act, dtype=dtype) for r in rates)
        self.norm = CastLayerNorm(embed_dim, dtype)
        self.taps = {depth // 4 - 1, depth // 2 - 1, 3 * depth // 4 - 1, depth - 1}
        if pyramid_adapter:
            self.up2a = nn.ConvTranspose2d(embed_dim, embed_dim, 2, 2)
            self.up2a_norm = CastLayerNorm(embed_dim, dtype)
            self.up2b = nn.ConvTranspose2d(embed_dim, embed_dim, 2, 2)
            self.up1 = nn.ConvTranspose2d(embed_dim, embed_dim, 2, 2)
            self.down1 = nn.Conv2d(embed_dim, embed_dim, 2, 2)

    def draw_embeddings(self, generator: torch.Generator) -> None:
        """``pos_embed`` from normal(0.02) (flax ``initializers.normal``)."""
        with torch.no_grad():
            self.pos_embed.copy_(0.02 * torch.randn(self.pos_embed.shape, generator=generator))

    def feature_sizes(self, h: int, w: int) -> List[Tuple[int, int]]:
        """The four levels' (h, w): a grid of ceil(side / 16) (``SAME``),
        times 4 and 2, itself, and halved rounding up."""
        gh, gw = -(-h // PATCH), -(-w // PATCH)
        if not self.pyramid_adapter:
            return [(gh, gw)]
        return [(4 * gh, 4 * gw), (2 * gh, 2 * gw), (gh, gw), (-(-gh // 2), -(-gw // 2))]

    def drop_path_factors(self, batch: int, generator: torch.Generator,
                          device=None) -> torch.Tensor:
        """(blocks, 2, batch) float32 factors: the JAX block calls one
        ``DropPath`` twice, each call its own mask."""
        return torch.stack([torch.stack([drop_path_factor(blk.drop_path_rate, batch, generator,
                                                          device) for _ in range(2)])
                            for blk in self.blocks])

    def _up(self, x: torch.Tensor, conv: nn.ConvTranspose2d) -> torch.Tensor:
        dt = self.dtype
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2).to(dt), conv.weight.to(dt),
                               conv.bias.to(dt), stride=2)
        return y.permute(0, 2, 3, 1).contiguous()

    def forward(self, x: torch.Tensor,
                factors: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        dt = self.dtype
        x = conv_nhwc(x, self.patch_embed.proj, "SAME", dt)
        b, h, w, d = x.shape
        pos = resample_pos_embed(self.pos_embed, (h, w))
        x = x.reshape(b, h * w, d) + pos.to(dt)
        feats = []
        for i, blk in enumerate(self.blocks):
            x = blk(x, None if factors is None else factors[i])
            if i in self.taps:
                feats.append(x.reshape(b, h, w, d))
        feats[-1] = self.norm(x).reshape(b, h, w, d)
        if not self.pyramid_adapter:
            return [feats[-1]]
        y = self._up(gelu_tanh(self.up2a_norm(self._up(feats[0], self.up2a))), self.up2b)
        return [y, self._up(feats[1], self.up1), feats[2],
                conv_nhwc(feats[3], self.down1, "SAME", dt)]


def _make_kat(variant: str, act: str):
    def factory(dtype=torch.bfloat16, img_size: int = 512, drop_path_rate: float = 0.0,
                pyramid_adapter: bool = True):
        dim, depth, heads = KAT_SETTINGS[variant]
        model = KATVisionTransformer(dim, depth, heads, act, drop_path_rate, pyramid_adapter,
                                     dtype, img_size)
        return model, [dim] * 4

    return factory


for _v in KAT_SETTINGS:
    for _act in ("gelu", "swish"):
        register_backbone(f"kat_{_v}_{_act}")(_make_kat(_v, _act))
