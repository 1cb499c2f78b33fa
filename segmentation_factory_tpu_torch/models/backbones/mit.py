"""MiT (SegFormer encoder), in two configurations.

Port of ``segmentation_factory_tpu/models/backbones/mit.py``.

- Fused (``fused_blocks=True``, the default: the JAX package's own
  configuration on its chip, ``use_pallas_block()``): every block of width
  below 512 (stages 1-3) runs as two half-block kernels (``mit.py:219-227``),
  the attention half K3f/K3b (``SRAttention``'s fused branch, ``mit.py:102-110``)
  and the FFN half K4f/K4b (``MixFFN``'s, ``mit.py:156-165``), which fold in
  LN1 / LN2 and the drop-path residuals; the KV path (LN1 again, the sr conv,
  its LayerNorm and the kv Linear) stays plain PyTorch, as it stayed XLA.
  Stage 4 runs per-op.
- Per-op (``fused_blocks=False``): every block runs ``SRAttention`` through
  the SRA-attention kernels (K1f/K1b, ``mit.py:112-123``) and ``MixFFN``
  through the Mix-FFN kernels (K2f/K2b, ``mit.py:167-171``), with the
  LayerNorms, projections and residuals in plain PyTorch around them.

Both declare the same parameters, so one ``state_dict`` serves both. The
7x7/s4 stem is a plain ``Conv2d`` (the TPU's space-to-depth rewrite,
``mit.py:267-290``, is not ported). In training a block adds each branch
times its per-sample drop-path factor (``MiTBlock``, ``mit.py:224-235``), the
rates rising to ``DROP_PATH_RATE`` (0.1) over the blocks (``mit.py:311``);
the factors are an input (``drop_path_factors`` samples them from a
``torch.Generator``).

Module keys follow the reference ``state_dict``: ``patch_embed{i}.{proj,norm}``,
``block{i}.{j}.{norm1,attn.{q,kv,proj,sr,norm},norm2,mlp.{fc1,dwconv.dwconv,fc2}}``,
``norm{i}``. Inside the blocks tokens are (B, N, C); the four pyramid
levels come out NHWC, as from the JAX module.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from segmentation_factory_tpu_torch.models.layers import (
    LayerNorm,
    drop_path,
    drop_path_factor,
    drop_path_rates,
)
from segmentation_factory_tpu_torch.ops.block import attn_block_apply, ffn_block_apply
from segmentation_factory_tpu_torch.ops.mixffn import mixffn_apply
from segmentation_factory_tpu_torch.ops.sra_attention import sra_attention
from segmentation_factory_tpu_torch.registry import register_backbone

MIT_SETTINGS = {
    # name: (embed_dims, depths)
    "b0": ([32, 64, 160, 256], [2, 2, 2, 2]),
    "b1": ([64, 128, 320, 512], [2, 2, 2, 2]),
    "b2": ([64, 128, 320, 512], [3, 4, 6, 3]),
    "b3": ([64, 128, 320, 512], [3, 4, 18, 3]),
    "b4": ([64, 128, 320, 512], [3, 8, 27, 3]),
    "b5": ([64, 128, 320, 512], [3, 6, 40, 3]),
}
HEADS = (1, 2, 5, 8)
SR_RATIOS = (8, 4, 2, 1)
DROP_PATH_RATE = 0.1  # the last block's rate (mit.py:305)
FUSED_MAX_DIM = 512   # blocks this wide stay per-op in the fused configuration


class OverlapPatchEmbed(nn.Module):
    """k x k conv, stride s, padding k // 2, then LayerNorm (eps 1e-6)."""

    def __init__(self, in_ch: int, dim: int, patch: int, stride: int, dtype):
        super().__init__()
        self.proj = nn.Conv2d(in_ch, dim, patch, stride, patch // 2)
        self.norm = LayerNorm(dim)
        self.dtype = dtype

    def forward(self, x: torch.Tensor):
        """x (B, C, H, W) -> contiguous tokens (B, N, dim) in the compute
        dtype, h, w. The convolution may write its output channels-first
        (cuDNN picks the layout by shape), and the LayerNorm keeps its
        input's layout: the half-block kernels take contiguous tokens."""
        dt = self.dtype
        y = F.conv2d(x.to(dt), self.proj.weight.to(dt), self.proj.bias.to(dt),
                     self.proj.stride, self.proj.padding)
        _, _, h, w = y.shape
        return self.norm(y.flatten(2).transpose(1, 2)).to(dt).contiguous(), h, w


class SRAttention(nn.Module):
    """Spatial-reduction attention: K/V from a VALID sr x sr stride-sr conv
    (edge pixels that do not fill a window are dropped), its LayerNorm and
    one kv Linear laid out [k of all heads | v of all heads]."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int, dtype):
        super().__init__()
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.dtype = dtype
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.norm = LayerNorm(dim)

    def _kv(self, y: torch.Tensor, h: int, w: int):
        """k, v (B, M, C) from the normalized tokens y (B, N, C)."""
        dt = self.dtype
        b, _, c = y.shape
        kv_in = y
        if self.sr_ratio > 1:
            r = F.conv2d(y.transpose(1, 2).reshape(b, c, h, w), self.sr.weight.to(dt),
                         self.sr.bias.to(dt), stride=self.sr_ratio)
            kv_in = self.norm(r.flatten(2).transpose(1, 2)).to(dt)
        wkv, bkv = self.kv.weight.to(dt), self.kv.bias.to(dt)
        return F.linear(kv_in, wkv[:c], bkv[:c]), F.linear(kv_in, wkv[c:], bkv[c:])

    def forward(self, y: torch.Tensor, h: int, w: int) -> torch.Tensor:
        """y: normalized block input (B, N, C) in the compute dtype."""
        dt = self.dtype
        b, n, c = y.shape
        hd = c // self.num_heads
        q = F.linear(y, self.q.weight.to(dt), self.q.bias.to(dt))
        k, v = self._kv(y, h, w)
        m = k.shape[1]
        out = sra_attention(
            q.view(b, n, self.num_heads, hd), k.view(b, m, self.num_heads, hd),
            v.view(b, m, self.num_heads, hd), hd ** -0.5,
        )
        return F.linear(out.reshape(b, n, c), self.proj.weight.to(dt),
                        self.proj.bias.to(dt))

    def fused(self, x: torch.Tensor, h: int, w: int, norm: nn.Module,
              fac: torch.Tensor) -> torch.Tensor:
        """The attention half-block, one K3 launch: x (B, N, C) the raw block
        input, ``norm`` its LN1, ``fac`` (B,) the drop-path factors; returns
        x + fac * proj(attn(LN1(x))). LN1 is applied a second time here for
        the KV path."""
        dt = self.dtype
        b, n, c = x.shape
        k, v = self._kv(norm(x).to(dt), h, w)
        out = attn_block_apply(
            x.view(b, h, w, c), k, v, norm.weight, norm.bias,
            self.q.weight.to(dt), self.q.bias.to(dt),
            self.proj.weight.to(dt), self.proj.bias.to(dt), fac,
            self.num_heads, (c // self.num_heads) ** -0.5)
        return out.view(b, n, c)


class DWConv(nn.Module):
    """Holder of the 3x3 depthwise conv (key ``dwconv.dwconv``)."""

    def __init__(self, ch: int):
        super().__init__()
        self.dwconv = nn.Conv2d(ch, ch, 3, 1, 1, groups=ch)


class MixFFN(nn.Module):
    """fc1 -> 3x3 depthwise -> exact GELU -> fc2, one K2 launch."""

    def __init__(self, dim: int, hidden: int, dtype):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.dtype = dtype

    def _weights(self):
        """fc1, dwconv, fc2 in ``mixffn_apply``'s layout and the compute dtype."""
        dt = self.dtype
        return (self.fc1.weight.t().to(dt).contiguous(), self.fc1.bias.to(dt),
                self.dwconv.dwconv.weight.permute(2, 3, 1, 0).to(dt).contiguous(),
                self.dwconv.dwconv.bias.to(dt),
                self.fc2.weight.t().to(dt).contiguous(), self.fc2.bias.to(dt))

    def forward(self, y: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, n, c = y.shape
        return mixffn_apply(y.reshape(b, h, w, c), *self._weights()).reshape(b, n, c)

    def fused(self, x: torch.Tensor, h: int, w: int, norm: nn.Module,
              fac: torch.Tensor) -> torch.Tensor:
        """The FFN half-block, one K4 launch: x + fac * ffn(LN2(x)) for the
        raw half-block input x (B, N, C), ``norm`` its LN2."""
        b, n, c = x.shape
        w1, b1, dw, db, w2, b2 = self._weights()
        return ffn_block_apply(x.view(b, h, w, c), norm.weight, norm.bias, w1, b1, dw, db,
                               w2, b2, fac).view(b, n, c)


class MiTBlock(nn.Module):
    """``fused``: the two half-block kernels, granted below FUSED_MAX_DIM
    (``mit.py:219-222``); else per-op."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int, dtype,
                 drop_path_rate: float = 0.0, fused: bool = False):
        super().__init__()
        self.fused = fused and dim < FUSED_MAX_DIM
        self.norm1 = LayerNorm(dim)
        self.attn = SRAttention(dim, num_heads, sr_ratio, dtype)
        self.norm2 = LayerNorm(dim)
        self.mlp = MixFFN(dim, 4 * dim, dtype)
        self.dtype = dtype
        self.drop_path_rate = drop_path_rate

    def forward(self, x: torch.Tensor, h: int, w: int,
                factors: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``factors``: (2, B) float32 drop-path factors of the attention
        and FFN branches, or None (eval)."""
        if self.fused:  # each half takes its own row of the factors (mit.py:224-227)
            if factors is None:
                factors = torch.ones((2, x.shape[0]), dtype=torch.float32, device=x.device)
            x = self.attn.fused(x, h, w, self.norm1, factors[0])
            return self.mlp.fused(x, h, w, self.norm2, factors[1])
        f1, f2 = (None, None) if factors is None else factors
        x = x + drop_path(self.attn(self.norm1(x).to(self.dtype), h, w), f1)
        return x + drop_path(self.mlp(self.norm2(x).to(self.dtype), h, w), f2)


class MiT(nn.Module):
    """4-stage hierarchical encoder: NHWC image -> 4 NHWC pyramid levels.
    ``fused_blocks`` chooses the configuration (module docstring)."""

    def __init__(self, embed_dims: Sequence[int], depths: Sequence[int],
                 dtype=torch.bfloat16, fused_blocks: bool = True):
        super().__init__()
        self.depths = list(depths)
        self.dtype = dtype
        rates = drop_path_rates(DROP_PATH_RATE, depths)
        in_ch = 3
        for i, (dim, depth) in enumerate(zip(embed_dims, depths), start=1):
            setattr(self, f"patch_embed{i}", OverlapPatchEmbed(
                in_ch, dim, 7 if i == 1 else 3, 4 if i == 1 else 2, dtype))
            setattr(self, f"block{i}", nn.ModuleList(
                MiTBlock(dim, HEADS[i - 1], SR_RATIOS[i - 1], dtype, rates[i - 1][j],
                         fused_blocks)
                for j in range(depth)))
            setattr(self, f"norm{i}", LayerNorm(dim))
            in_ch = dim

    def blocks(self) -> List[MiTBlock]:
        return [blk for i in range(1, len(self.depths) + 1) for blk in getattr(self, f"block{i}")]

    def drop_path_factors(self, batch: int, generator: torch.Generator,
                          device=None) -> torch.Tensor:
        """(blocks, 2, batch) float32 drop-path factors, one row per branch,
        drawn from ``generator`` at each block's rate."""
        return torch.stack([torch.stack([drop_path_factor(blk.drop_path_rate, batch,
                                                           generator, device)
                                         for _ in range(2)]) for blk in self.blocks()])

    def forward(self, x: torch.Tensor,
                factors: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """``factors``: the (blocks, 2, B) drop-path factors in training,
        None in eval."""
        b = x.shape[0]
        x = x.permute(0, 3, 1, 2)
        feats = []
        k = 0
        for i in range(1, len(self.depths) + 1):
            t, h, w = getattr(self, f"patch_embed{i}")(x)
            for blk in getattr(self, f"block{i}"):
                t = blk(t, h, w, None if factors is None else factors[k])
                k += 1
            t = getattr(self, f"norm{i}")(t).to(self.dtype)
            feat = t.view(b, h, w, -1)
            feats.append(feat)
            x = feat.permute(0, 3, 1, 2)
        return feats


def _make_mit(variant: str):
    def factory(dtype=torch.bfloat16, img_size: int = 512, fused_blocks: bool = True):
        dims, depths = MIT_SETTINGS[variant]
        return MiT(dims, depths, dtype=dtype, fused_blocks=fused_blocks), list(dims)

    return factory


for _v in MIT_SETTINGS:
    register_backbone(f"mit_{_v}")(_make_mit(_v))
