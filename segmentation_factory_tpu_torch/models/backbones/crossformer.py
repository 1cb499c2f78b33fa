"""CrossFormer / CrossFormer++ backbones (cross-scale embedding + LSDA).

Port of ``segmentation_factory_tpu/models/backbones/crossformer.py``
(:1-333): a patch embedding of parallel stride-4 convs (one 4x4 kernel by
default, four with ``cel``) with a LayerNorm after them, then four stages
of ``CrossFormerBlock``s, a merge (LayerNorm first, then parallel stride-2
convs, no norm after) before stages 2-4; each stage's raw block output is
its feature. A block: LayerNorm -> (``use_cpe``: + LayerNorm of a
depthwise 3x3) -> group attention over short-distance (SDA: contiguous G x
G windows, even blocks) or long-distance (LDA: every I-th token, odd
blocks) groups -> residual; LayerNorm -> Linear 4x -> GELU (tanh) ->
Linear -> residual, each branch scaled by its drop-path factor (an input:
``drop_path_factors``, (blocks, 2, batch)). A map whose smaller side is at
most G attends in one group of max(h, w)², SDA (:116-122). The map is
zero-padded to a multiple of G (SDA) or I·G (LDA), and the padded keys
take an additive -1e9 in the float32 scores (:157-164).

Group attention (:63-96): q kᵀ in the compute dtype, scaled there, cast to
float32; the dynamic position bias (a float32 MLP of the (2G-1)² relative
offsets, width attn_dim // 16, gathered into (heads, G², G²); off with
``use_cpe``) and the mask added in float32, softmax in float32, cast back
before the product with v. These products are ``torch.matmul``: the JAX
package computes them with einsums outside Pallas, so no TPU kernel is on
this path.

Keys follow the reference's ``state_dict`` (the JAX ``convert_crossformer``,
``convert.py:485-530``): ``patch_embed.{projs.{i}, norm}``,
``layers.{s}.blocks.{j}.{norm1, attn.{qkv, proj, pos.{pos_proj, pos1.0,
pos1.2, pos2.0, pos2.2, pos3.0, pos3.2}}, norm2, mlp.{fc1, fc2}}`` and
``layers.{s}.downsample.{norm, reductions.{i}}`` (the merge before stage
s + 1). ``use_cpe``'s ``cpe`` and ``norm_cpe``, which no JAX converter
names, take the JAX module's names.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

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
    rounded,
)
from segmentation_factory_tpu_torch.models.layers.act import gelu_tanh
from segmentation_factory_tpu_torch.models.modules.transformer import dense
from segmentation_factory_tpu_torch.registry import register_backbone

NEG_INF = -1e9


@lru_cache(maxsize=32)
def _relative_index(g: int) -> np.ndarray:
    """(G², G²) index into the (2G-1)² relative-bias table (:51-60)."""
    coords = np.stack(np.meshgrid(np.arange(g), np.arange(g), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += g - 1
    rel[:, :, 1] += g - 1
    rel[:, :, 0] *= 2 * g - 1
    return rel.sum(-1)


@lru_cache(maxsize=32)
def _offsets(g: int) -> np.ndarray:
    """((2G-1)², 2) float32 relative offsets (dy, dx), dy major."""
    rng = np.arange(1 - g, g, dtype=np.float32)
    by, bx = np.meshgrid(rng, rng, indexing="ij")
    return np.stack([by, bx], -1).reshape(-1, 2)


class DynamicPosBias(nn.Module):
    """(dy, dx) -> per-head bias, in float32: Linear, then three of
    LayerNorm -> ReLU -> Linear (:28-48). Built as ``DynamicPosBias(attn_dim
    // 4)``, its width is max(dim // 4, 4) of that."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        hidden = max(dim // 4, 4)
        f32 = torch.float32

        def stage(out: int) -> nn.Sequential:
            return nn.Sequential(CastLayerNorm(hidden, f32), nn.ReLU(), nn.Linear(hidden, out))

        self.pos_proj = nn.Linear(2, hidden)
        self.pos1, self.pos2, self.pos3 = stage(hidden), stage(hidden), stage(num_heads)
        self._tables = {}  # (G, device) -> (offsets, index) there: copied once, not a forward

    def forward(self, g: int, device) -> torch.Tensor:
        """(heads, G², G²) float32 bias of a G x G group."""
        key = (g, str(device))
        if key not in self._tables:
            # normal tensors even when first met in a predict (inference mode),
            # so that a later training forward may save them for backward
            with torch.inference_mode(False):
                self._tables[key] = (torch.tensor(_offsets(g), device=device),
                                     torch.tensor(_relative_index(g).reshape(-1), device=device))
        table, idx = self._tables[key]
        pos = self.pos3(self.pos2(self.pos1(self.pos_proj(table))))
        n = g * g
        return pos[idx].reshape(n, n, -1).permute(2, 0, 1)


class GroupAttention(nn.Module):
    """Multi-head self-attention within each group of (groups x B, G², C)."""

    def __init__(self, dim: int, num_heads: int, position_bias: bool = True,
                 dtype=torch.bfloat16):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.scale = rounded((dim // num_heads) ** -0.5, dtype)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.pos = DynamicPosBias(dim // 4, num_heads) if position_bias else None

    def forward(self, x: torch.Tensor, g: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mask``: (groups x B, 1, G²) float32 additive key mask, or None."""
        bg, n, c = x.shape
        dt, nh = self.dtype, self.num_heads
        hd = c // nh
        q, k, v = dense(x, self.qkv, dt).reshape(bg, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
        attn = torch.matmul(q, k.transpose(-1, -2)) * self.scale
        attn = attn.float()
        if self.pos is not None:
            attn = attn + self.pos(g, x.device)[None]
        if mask is not None:
            attn = attn + mask[:, None]
        attn = torch.softmax(attn, dim=-1).to(dt)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(bg, n, c)
        return dense(out, self.proj, dt)


def group_split(y: torch.Tensor, g: int, interval: int, lsda: bool) -> torch.Tensor:
    """(B, Hp, Wp, C) -> (groups x B, G², C): SDA's G x G windows or LDA's
    dilated groups of interval I (:142-155)."""
    b, hp, wp, c = y.shape
    if not lsda:
        y = y.reshape(b, hp // g, g, wp // g, g, c).permute(0, 1, 3, 2, 4, 5)
    else:
        i = interval
        y = y.reshape(b, hp // (g * i), g, i, wp // (g * i), g, i, c)
        y = y.permute(0, 1, 4, 3, 6, 2, 5, 7)
    return y.reshape(-1, g * g, c)


def group_merge(y: torch.Tensor, b: int, hp: int, wp: int, g: int, interval: int,
                lsda: bool) -> torch.Tensor:
    """The inverse of ``group_split`` (:170-175)."""
    c = y.shape[-1]
    if not lsda:
        y = y.reshape(b, hp // g, wp // g, g, g, c).permute(0, 1, 3, 2, 4, 5)
    else:
        i = interval
        y = y.reshape(b, hp // (g * i), wp // (g * i), i, i, g, g, c)
        y = y.permute(0, 1, 5, 3, 2, 6, 4, 7)
    return y.reshape(b, hp, wp, c)


def group_mask(h: int, w: int, hp: int, wp: int, g: int, interval: int, lsda: bool,
               device) -> torch.Tensor:
    """(groups, 1, G²) float32: 0 on the map's tokens, -1e9 on the padding."""
    valid = torch.zeros((1, hp, wp, 1), device=device)
    valid[:, :h, :w] = 1.0
    vm = group_split(valid, g, interval, lsda)[:, :, 0]
    return torch.where(vm > 0, 0.0, NEG_INF)[:, None, :]


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        return dense(gelu_tanh(dense(x, self.fc1, dtype)), self.fc2, dtype)


class CrossFormerBlock(nn.Module):
    """``lsda_flag``: 0 SDA, 1 LDA (odd blocks)."""

    def __init__(self, dim: int, num_heads: int, group_size: int, interval: int,
                 lsda_flag: int, mlp_ratio: float = 4.0, drop_path_rate: float = 0.0,
                 use_cpe: bool = False, dtype=torch.bfloat16):
        super().__init__()
        self.group_size, self.interval, self.lsda_flag = group_size, interval, lsda_flag
        self.drop_path_rate, self.dtype = drop_path_rate, dtype
        self.norm1 = CastLayerNorm(dim, dtype)
        if use_cpe:
            self.cpe = nn.Conv2d(dim, dim, 3, groups=dim)
            self.norm_cpe = CastLayerNorm(dim, dtype)
        self.use_cpe = use_cpe
        self.attn = GroupAttention(dim, num_heads, position_bias=not use_cpe, dtype=dtype)
        self.norm2 = CastLayerNorm(dim, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def grouping(self, h: int, w: int) -> Tuple[int, int, bool]:
        """(G, interval, LDA?) of an h x w map: the small-map fallback
        attends in one max(h, w)² group, SDA."""
        if min(h, w) <= self.group_size:
            return max(h, w), 1, False
        lsda = bool(self.lsda_flag)
        return self.group_size, self.interval if lsda else 1, lsda

    def forward(self, x: torch.Tensor, factors: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``factors``: (2, B) drop-path factors of the two branches, or None."""
        b, h, w, c = x.shape
        g, interval, lsda = self.grouping(h, w)
        y = self.norm1(x)
        if self.use_cpe:
            y = y + self.norm_cpe(conv_nhwc(y, self.cpe, 1, self.dtype))
        div = interval * g if lsda else g
        hp, wp = h + (-h) % div, w + (-w) % div
        mask = None
        if (hp, wp) != (h, w):
            y = F.pad(y, (0, 0, 0, wp - w, 0, hp - h))
            mask = group_mask(h, w, hp, wp, g, interval, lsda, x.device)
            mask = mask.expand(b, *mask.shape).reshape(-1, *mask.shape[1:])
        y = self.attn(group_split(y, g, interval, lsda), g, mask)
        y = group_merge(y, b, hp, wp, g, interval, lsda)[:, :h, :w]
        f = (None, None) if factors is None else factors
        x = x + drop_path(y, f[0])
        return x + drop_path(self.mlp(self.norm2(x), self.dtype), f[1])


def _split_widths(dim: int, n: int) -> List[int]:
    """Each kernel's share of ``dim``: [D/2, D/4, D/8, D/8] for 4, [D/2,
    D/2] for 2, D for 1 (:206-208)."""
    return [dim // 2 ** min(i + 1, n - 1) if n > 1 else dim for i in range(n)]


class MultiKernelConvs(nn.Module):
    """Parallel convs of ``kernels`` at ``stride`` (padding (k - stride) //
    2), their outputs concatenated over channels. The stem takes its
    LayerNorm after them, a merge before them (:186-216)."""

    def __init__(self, in_ch: int, dim: int, kernels: Sequence[int], stride: int, pre_norm: bool,
                 dtype=torch.bfloat16):
        super().__init__()
        self.norm = CastLayerNorm(in_ch if pre_norm else dim, dtype)
        convs = [nn.Conv2d(in_ch, d, k, stride)
                 for d, k in zip(_split_widths(dim, len(kernels)), kernels)]
        if pre_norm:
            self.reductions = nn.ModuleList(convs)
        else:
            self.projs = nn.ModuleList(convs)
        self.pre_norm, self.stride, self.dtype = pre_norm, stride, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pre_norm:
            x = self.norm(x)
        convs = self.reductions if self.pre_norm else self.projs
        y = torch.cat([conv_nhwc(x, c, (c.kernel_size[0] - self.stride) // 2, self.dtype)
                       for c in convs], dim=-1)
        return y if self.pre_norm else self.norm(y)


class Stage(nn.Module):
    def __init__(self, blocks: List[CrossFormerBlock], downsample: Optional[nn.Module]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class CrossFormer(nn.Module):
    """NHWC image -> 4 NHWC pyramid levels (strides 4 to 32).
    ``group_sizes``: a per-stage int or a per-stage list (one G a block,
    CrossFormer++'s ``linear`` schedule)."""

    def __init__(self, embed_dim: int, depths: Sequence[int], num_heads: Sequence[int],
                 group_sizes: Sequence, intervals: Sequence[int], drop_path_rate: float = 0.1,
                 use_cpe: bool = False, stem_kernels: Sequence[int] = (4,),
                 merge_kernels: Sequence[int] = (2,), dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.patch_embed = MultiKernelConvs(3, embed_dim, stem_kernels, 4, False, dtype)
        rates = drop_path_rates(drop_path_rate, depths)
        stages = []
        for s in range(4):
            dim = embed_dim * 2 ** s
            gs = group_sizes[s]
            blocks = [CrossFormerBlock(dim, num_heads[s],
                                       gs[j] if isinstance(gs, (list, tuple)) else gs,
                                       intervals[s], j % 2, drop_path_rate=rates[s][j],
                                       use_cpe=use_cpe, dtype=dtype)
                      for j in range(depths[s])]
            down = (MultiKernelConvs(dim, 2 * dim, merge_kernels, 2, True, dtype)
                    if s < 3 else None)
            stages.append(Stage(blocks, down))
        self.layers = nn.ModuleList(stages)

    def blocks(self) -> List[CrossFormerBlock]:
        return [blk for stage in self.layers for blk in stage.blocks]

    @staticmethod
    def feature_sizes(h: int, w: int) -> List[Tuple[int, int]]:
        """The four levels' (h, w): the stem and the merges round down."""
        return [(h // s, w // s) for s in (4, 8, 16, 32)]

    def drop_path_factors(self, batch: int, generator: torch.Generator,
                          device=None) -> torch.Tensor:
        """(blocks, 2, batch) float32 factors: the JAX block calls one
        ``DropPath`` twice, each call its own mask."""
        return torch.stack([torch.stack([drop_path_factor(blk.drop_path_rate, batch, generator,
                                                          device) for _ in range(2)])
                            for blk in self.blocks()])

    def forward(self, x: torch.Tensor,
                factors: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        x = self.patch_embed(x)
        feats, k = [], 0
        for stage in self.layers:
            for blk in stage.blocks:
                x = blk(x, None if factors is None else factors[k])
                k += 1
            feats.append(x)
            if stage.downsample is not None:
                x = stage.downsample(x)
        return feats


def linear_group_schedule(depths: Sequence[int], base_resolution: int = 56,
                          min_size: int = 4) -> List[List[int]]:
    """CrossFormer++'s ``linear`` group-size schedule (:219-232), numpy's
    float64 ``arange`` as there."""
    total = sum(depths)
    step = (1 - min_size / base_resolution) / total
    fracs = np.arange(min_size / base_resolution, 1.0, step)
    out, cnt = [], 0
    for s, d in enumerate(depths):
        res = base_resolution // 2 ** s
        row = []
        for _ in range(d):
            row.append(max(4, int(np.ceil(res * fracs[cnt]))))
            cnt += 1
        out.append(row)
    return out


CROSSFORMER_SETTINGS = {
    # name: (embed dim, depths, heads, group sizes, intervals)
    "tiny": (64, [1, 1, 8, 6], [2, 4, 8, 16], [7, 7, 7, 7], [8, 4, 2, 1]),
    "small": (96, [2, 2, 6, 2], [3, 6, 12, 24], [7, 7, 7, 7], [8, 4, 2, 1]),
    "base": (96, [2, 2, 18, 2], [3, 6, 12, 24], [7, 7, 7, 7], [8, 4, 2, 1]),
    "large": (128, [2, 2, 18, 2], [4, 8, 16, 32], [7, 7, 7, 7], [8, 4, 2, 1]),
}
CROSSFORMERPP_SETTINGS = {
    "small": (64, [2, 2, 18, 2], [2, 4, 8, 16], [4, 4, 14, 7], [4, 4, 1, 1]),
    "base": (96, [2, 2, 18, 2], [3, 6, 12, 24], [4, 4, 14, 7], [4, 4, 1, 1]),
    "large": (128, [2, 2, 18, 2], [4, 8, 16, 32], [4, 4, 14, 7], [4, 4, 1, 1]),
    "huge": (128, [6, 6, 18, 2], [2, 4, 8, 16], [4, 4, 14, 7], [4, 4, 1, 1]),
}


def _make_crossformer(variant: str, pp: bool):
    settings = CROSSFORMERPP_SETTINGS if pp else CROSSFORMER_SETTINGS

    def factory(dtype=torch.bfloat16, img_size: int = 512, drop_path_rate: float = 0.1,
                group_type: str = "constant", cel: bool = False, use_cpe: bool = False):
        """``cel``: the paper's cross-scale embedding (stem kernels 4, 8,
        16, 32; merges 2, 4); ``group_type="linear"``: CrossFormer++'s
        scheduled group sizes."""
        dim, depths, heads, groups, intervals = settings[variant]
        if group_type == "linear":
            groups = linear_group_schedule(depths)
        elif group_type != "constant":
            raise ValueError(f"unknown group_type {group_type!r}")
        kernels = dict(stem_kernels=(4, 8, 16, 32), merge_kernels=(2, 4)) if cel else {}
        model = CrossFormer(dim, depths, heads, groups, intervals, drop_path_rate=drop_path_rate,
                            use_cpe=use_cpe, dtype=dtype, **kernels)
        return model, [dim, dim * 2, dim * 4, dim * 8]

    return factory


for _v in CROSSFORMER_SETTINGS:
    register_backbone(f"crossformer_{_v}")(_make_crossformer(_v, pp=False))
for _v in CROSSFORMERPP_SETTINGS:
    register_backbone(f"crossformerpp_{_v}")(_make_crossformer(_v, pp=True))
