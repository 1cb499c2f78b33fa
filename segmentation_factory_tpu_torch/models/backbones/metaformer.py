"""MetaFormer backbones: IdentityFormer, RandFormer, PoolFormerV2, ConvFormer
and CAFormer.

Port of ``segmentation_factory_tpu/models/backbones/metaformer.py``: a 7x7/4
stem conv (padding 2) and its scale-only LayerNorm, then per stage (after
the first) a scale-only LayerNorm and a 3x3/2 downsample conv (padding 1);
blocks of norm -> token mixer -> residual, norm -> Linear 4x -> StarReLU
-> Linear -> residual, with a learnable per-channel scale of the residual
stream in stages 3-4 (``res_scale``, ones at init) and no layer scale; the
stages' raw block outputs are the features. The family fixes each stage's
token mixer (``FAMILY_MIXERS``) and the blocks' norm: flax's scale-only
``nn.LayerNorm`` (``CastLayerNorm`` without a bias) for ConvFormer and
CAFormer, ``ModifiedLayerNorm`` (statistics over H, W and C together) for
the others.

The mixers:

- ``identity``;
- ``RandomMixing``: a fixed row-softmax (N, N) matrix over the tokens, a
  buffer (``random_matrix``) that the optimizer never sees. Its N is the
  stage's token count at the square size the JAX package initialises the
  model at (the Trainer's crop, ``engine/state.py:280-284``), which the
  port's ``build_model`` takes as ``img_size`` and hands to the factory.
  Called at another square grid it is resampled as ``jax.image.resize``
  does (``resample_weights``), then its rows renormalised;
- ``Pooling``: a 3x3 average without the padding in its count, minus x;
- ``SepConv``: Linear 2x -> StarReLU -> depthwise 7x7 -> Linear;
- ``VanillaAttention`` (CAFormer's stages 3-4): one bias-free qkv Linear,
  self-attention over the flattened map with heads of 32 through K1
  (``ops.sra_attention``: K1f, and K1b where a gradient is needed; on a
  CUDA tensor the kernels or an error, at any N), a bias-free projection.

dtypes follow the JAX module's promotion: the float32 scale and bias of
StarReLU, ``res_scale`` and the drop-path factors compute in float32 and
cast back to the stream's dtype; ``Pooling`` returns float32 (flax divides
by a float32 count), so a PoolFormerV2 stream turns float32 after its
first block, as in the JAX package. The pooling's window sums are
``F.avg_pool2d``'s in the input's dtype (float32 accumulation on the card),
where flax sums in the input dtype.

Keys follow the reference ``state_dict``: ``downsample_layers.0.{conv,
post_norm}``, ``downsample_layers.{1..3}.{pre_norm,conv}``,
``stages.{i}.{j}.{norm1,token_mixer.*,norm2,mlp.{fc1,act,fc2},
res_scale1,res_scale2}``; the mixers' ``token_mixer.{pwconv1,act1,dwconv,
pwconv2}`` (SepConv), ``token_mixer.{qkv,proj}`` (attention) and
``token_mixer.random_matrix``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

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
)
from segmentation_factory_tpu_torch.ops.sra_attention import sra_attention
from segmentation_factory_tpu_torch.registry import register_backbone

HEAD_DIM = 32  # VanillaAttention's head width
MLP_RATIO = 4


def stage_sides(n: int) -> List[int]:
    """The four stages' map sides for an input side n: the stem (7x7/4,
    padding 2), then each downsample (3x3/2, padding 1) halving, rounding
    up."""
    sides = [(n + 4 - 7) // 4 + 1]
    for _ in range(3):
        sides.append(-(-sides[-1] // 2))
    return sides


class StarReLU(nn.Module):
    """scale * relu(x)^2 + bias, scale and bias learnable (1,) float32 (1 and
    0 at init); float32 arithmetic, cast back to x's dtype."""

    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1))
        self.bias = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = torch.relu(x.float())
        return (self.scale * r * r + self.bias).to(x.dtype)


class ModifiedLayerNorm(nn.Module):
    """Mean and variance (two-pass) over (H, W, C) of each image, in
    float32, then the (C,) scale: (x - mean) / sqrt(var + eps) * scale, cast
    back to x's dtype. The reference's ``LayerNormGeneral`` over (1, 2, 3)
    without a bias."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean((1, 2, 3), keepdim=True)
        var = ((xf - mu) ** 2).mean((1, 2, 3), keepdim=True)
        return ((xf - mu) / torch.sqrt(var + self.eps) * self.weight).to(x.dtype)


class Scale(nn.Module):
    """x * scale, the (C,) float32 scale ones at init, cast back to x's
    dtype (``res_scale``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x * self.scale).to(x.dtype)


def resample_mixing(m: torch.Tensor, n: int) -> torch.Tensor:
    """An (n0, n0) mixing matrix of a g0 x g0 grid resampled to a g x g
    grid's (n, n), as the JAX ``RandomMixing`` does (``metaformer.py:49-62``):
    the four grid axes of the float32 matrix bilinearly resized
    (``resample_weights``), then each row divided by its sum (at least
    1e-8). Both token counts must be squares."""
    n0 = m.shape[0]
    g0, g = math.isqrt(n0), math.isqrt(n)
    if g0 * g0 != n0 or g * g != n:
        raise ValueError(f"RandomMixing initialised for {n0} tokens, called with {n}; "
                         "resampling needs square token grids")
    w = resample_weights(g0, g, m.device)
    grid = m.float().reshape(g0, g0, g0, g0)
    for _ in range(4):  # contract the first axis, append the resized one
        grid = torch.tensordot(grid, w, dims=([0], [1]))
    out = grid.reshape(n, n)
    return out / torch.clamp(out.sum(-1, keepdim=True), min=1e-8)


class RandomMixing(nn.Module):
    """y = M x over the flattened tokens of each image, M a fixed
    row-softmax of uniform draws (``torch.Generator`` seeded 0, whatever
    the model's seed, as the JAX module draws from ``PRNGKey(0)``), in the
    stream's dtype."""

    def __init__(self, tokens: int):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.register_buffer("random_matrix",
                             torch.softmax(torch.rand((tokens, tokens), generator=g), dim=-1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        m = self.random_matrix
        if m.shape[0] != h * w:
            m = resample_mixing(m, h * w)
        return torch.matmul(m.to(x.dtype), x.reshape(b, h * w, c)).reshape(b, h, w, c)


class Pooling(nn.Module):
    """avg_pool 3x3 (stride 1, padding 1, the padding not counted) minus x,
    float32 (flax divides the window sums by a float32 count)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.avg_pool2d(x.permute(0, 3, 1, 2), 3, 1, 1, count_include_pad=False)
        return y.permute(0, 2, 3, 1).float() - x.float()


class SepConv(nn.Module):
    """Linear (2x, no bias) -> StarReLU -> depthwise 7x7 (padding 3, no bias)
    -> Linear (no bias), in the compute dtype."""

    def __init__(self, dim: int, dtype, expand: float = 2.0):
        super().__init__()
        mid = int(dim * expand)
        self.pwconv1 = nn.Linear(dim, mid, bias=False)
        self.act1 = StarReLU()
        self.dwconv = nn.Conv2d(mid, mid, 7, groups=mid, bias=False)
        self.pwconv2 = nn.Linear(mid, dim, bias=False)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = self.act1(F.linear(x.to(dt), self.pwconv1.weight.to(dt)))
        y = conv_nhwc(y, self.dwconv, 3, dt)
        return F.linear(y, self.pwconv2.weight.to(dt))


class VanillaAttention(nn.Module):
    """Multi-head self-attention over the flattened map: max(C // 32, 1)
    heads of 32, q, k and v from one bias-free Linear (3 x heads x 32,
    ordered (3, heads, 32)), softmax(q kᵀ / sqrt(32)) v through K1
    (``sra_attention``), a bias-free projection back to C."""

    def __init__(self, dim: int, dtype, head_dim: int = HEAD_DIM):
        super().__init__()
        self.num_heads = max(dim // head_dim, 1)
        self.head_dim = head_dim
        self.qkv = nn.Linear(dim, 3 * self.num_heads * head_dim, bias=False)
        self.proj = nn.Linear(self.num_heads * head_dim, dim, bias=False)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b, h, w, _ = x.shape
        nh, hd = self.num_heads, self.head_dim
        qkv = F.linear(x.to(dt), self.qkv.weight.to(dt)).reshape(b, h * w, 3, nh, hd)
        q, k, v = qkv.permute(2, 0, 1, 3, 4).contiguous()  # each (B, N, heads, 32), contiguous
        y = sra_attention(q, k, v, hd ** -0.5)
        return F.linear(y.reshape(b, h, w, nh * hd), self.proj.weight.to(dt))


class Mlp(nn.Module):
    """Linear (4x, no bias) -> StarReLU -> Linear (no bias)."""

    def __init__(self, dim: int, dtype):
        super().__init__()
        self.fc1 = nn.Linear(dim, MLP_RATIO * dim, bias=False)
        self.act = StarReLU()
        self.fc2 = nn.Linear(MLP_RATIO * dim, dim, bias=False)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = self.act(F.linear(x.to(dt), self.fc1.weight.to(dt)))
        return F.linear(y, self.fc2.weight.to(dt))


def make_mixer(kind: str, dim: int, dtype, tokens: int) -> nn.Module:
    if kind == "identity":
        return nn.Identity()
    if kind == "random":
        return RandomMixing(tokens)
    if kind == "pool":
        return Pooling()
    if kind == "sepconv":
        return SepConv(dim, dtype)
    if kind == "attention":
        return VanillaAttention(dim, dtype)
    raise KeyError(f"unknown token mixer {kind!r}")


class MetaFormerBlock(nn.Module):
    """norm1 -> token mixer -> (res_scale1 of) x + drop-path; norm2 -> Mlp
    -> (res_scale2 of) x + drop-path. ``block_norm``: ``"ln"`` (scale-only
    flax LayerNorm in the compute dtype) or ``"mln"`` (``ModifiedLayerNorm``)."""

    def __init__(self, dim: int, mixer: str, dtype, block_norm: str = "ln",
                 res_scale: bool = False, drop_path_rate: float = 0.0, tokens: int = 0):
        super().__init__()

        def norm():
            if block_norm == "mln":
                return ModifiedLayerNorm(dim)
            return CastLayerNorm(dim, dtype, bias=False)

        self.norm1 = norm()
        self.token_mixer = make_mixer(mixer, dim, dtype, tokens)
        self.norm2 = norm()
        self.mlp = Mlp(dim, dtype)
        if res_scale:
            self.res_scale1 = Scale(dim)
            self.res_scale2 = Scale(dim)
        self.res_scale = res_scale
        self.drop_path_rate = drop_path_rate

    def forward(self, x: torch.Tensor, factors: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``factors``: (2, B) float32 drop-path factors of the two branches
        in training, None in eval (or a block at rate 0)."""
        if self.drop_path_rate == 0.0:
            factors = None
        y = self.token_mixer(self.norm1(x))
        res = self.res_scale1(x) if self.res_scale else x
        x = res + drop_path(y, None if factors is None else factors[0])
        y = self.mlp(self.norm2(x))
        res = self.res_scale2(x) if self.res_scale else x
        return res + drop_path(y, None if factors is None else factors[1])


class MetaFormer(nn.Module):
    """NHWC image -> 4 NHWC pyramid levels (strides 4 to 32): each stage's
    last block output. ``img_size``: the square input size the model is
    built for, which sizes RandomMixing's matrices."""

    def __init__(self, dims: Sequence[int], depths: Sequence[int], mixers: Sequence[str],
                 block_norm: str = "ln", drop_path_rate: float = 0.0, dtype=torch.bfloat16,
                 img_size: int = 512):
        super().__init__()
        self.dtype = dtype
        self.downsample_layers = nn.ModuleList(
            [nn.ModuleDict({"conv": nn.Conv2d(3, dims[0], 7, 4),
                            "post_norm": CastLayerNorm(dims[0], dtype, bias=False)})]
            + [nn.ModuleDict({"pre_norm": CastLayerNorm(dims[i - 1], dtype, bias=False),
                              "conv": nn.Conv2d(dims[i - 1], dims[i], 3, 2)})
               for i in range(1, 4)])
        rates = drop_path_rates(drop_path_rate, depths)
        sides = stage_sides(img_size)
        self.stages = nn.ModuleList(
            nn.ModuleList(MetaFormerBlock(dims[s], mixers[s], dtype, block_norm,
                                          res_scale=s >= 2, drop_path_rate=rates[s][j],
                                          tokens=sides[s] ** 2)
                          for j in range(depths[s]))
            for s in range(4))

    def blocks(self) -> List[MetaFormerBlock]:
        return [blk for stage in self.stages for blk in stage]

    @staticmethod
    def feature_sizes(h: int, w: int) -> List[Tuple[int, int]]:
        """The four levels' (h, w) for an (h, w) input."""
        return list(zip(stage_sides(h), stage_sides(w)))

    def drop_path_factors(self, batch: int, generator: torch.Generator,
                          device=None) -> torch.Tensor:
        """(blocks, 2, batch) float32 drop-path factors, one row per branch
        (the JAX block draws each branch's mask apart), at each block's
        rate."""
        return torch.stack([torch.stack([drop_path_factor(blk.drop_path_rate, batch,
                                                          generator, device)
                                         for _ in range(2)])
                            for blk in self.blocks()])

    def forward(self, x: torch.Tensor,
                factors: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        dt = self.dtype
        feats, k = [], 0
        for s, stage in enumerate(self.stages):
            down = self.downsample_layers[s]
            if s == 0:
                x = down["post_norm"](conv_nhwc(x, down["conv"], 2, dt))
            else:
                x = conv_nhwc(down["pre_norm"](x), down["conv"], 1, dt)
            for blk in stage:
                x = blk(x, None if factors is None else factors[k])
                k += 1
            feats.append(x)
        return feats


# dims and depths by family: the 'm' and '36' codes differ between the
# IdentityFormer / RandFormer / PoolFormerV2 branch and ConvFormer / CAFormer
DIMS_IRP = {"s": [64, 128, 320, 512], "m": [96, 192, 384, 768]}
DIMS_CC = {"s": [64, 128, 320, 512], "m": [96, 192, 384, 576], "b": [128, 256, 512, 768]}
DEPTHS_IRP = {"12": [2, 2, 6, 2], "24": [4, 4, 12, 4], "36": [6, 6, 18, 6], "48": [8, 8, 24, 8]}
DEPTHS_CC = {"18": [3, 3, 9, 3], "36": [3, 12, 18, 3]}
CONV_FAMILIES = ("convformer", "caformer")
FAMILY_MIXERS = {
    "identityformer": ["identity"] * 4,
    "randformer": ["identity", "identity", "random", "random"],
    "poolformerv2": ["pool"] * 4,
    "convformer": ["sepconv"] * 4,
    "caformer": ["sepconv", "sepconv", "attention", "attention"],
}
VARIANTS = {
    "identityformer": ["s12", "s24", "s36", "m36", "m48"],
    "randformer": ["s12", "s24", "s36", "m36", "m48"],
    "poolformerv2": ["s12", "s24", "s36", "m36", "m48"],
    "convformer": ["s18", "s36", "m36", "b36"],
    "caformer": ["s18", "s36", "m36", "b36"],
}
# the reference's pretrained-weight tags: the same architecture under other names
WEIGHT_TAGS = ("384", "in21ft1k", "384_in21ft1k", "in21k")


def metaformer_settings(family: str, variant: str):
    """(dims, depths) of a registered family and variant."""
    if family in CONV_FAMILIES:
        return DIMS_CC[variant[0]], DEPTHS_CC[variant[1:]]
    return DIMS_IRP[variant[0]], DEPTHS_IRP[variant[1:]]


def _make_metaformer(family: str, variant: str):
    def factory(dtype=torch.bfloat16, img_size: int = 512):
        dims, depths = metaformer_settings(family, variant)
        norm = "ln" if family in CONV_FAMILIES else "mln"
        return (MetaFormer(dims, depths, FAMILY_MIXERS[family], norm, dtype=dtype,
                           img_size=img_size), list(dims))

    return factory


for _fam, _vs in VARIANTS.items():
    for _v in _vs:
        register_backbone(f"{_fam}_{_v}")(_make_metaformer(_fam, _v))
for _fam in CONV_FAMILIES:
    for _v in VARIANTS[_fam]:
        for _tag in WEIGHT_TAGS:
            # the reference ships caformer_m36's in21k factory as `caformer_m364_in21k`
            _name = ("caformer_m364_in21k" if (_fam, _v, _tag) == ("caformer", "m36", "in21k")
                     else f"{_fam}_{_v}_{_tag}")
            register_backbone(_name)(_make_metaformer(_fam, _v))
