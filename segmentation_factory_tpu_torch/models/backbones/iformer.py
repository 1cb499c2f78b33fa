"""iFormer: a mobile hybrid backbone of depthwise-conv blocks and SHMA.

Port of ``segmentation_factory_tpu/models/backbones/iformer.py`` (:1-406):
a FusedIB stem (5x5 / 2 conv + BN + GELU; 5x5 / 2 expand x4 + BN + GELU;
1x1 + BN), a 3x3 / 2 conv + BN before stages 2-4 (each conv with the
explicit symmetric padding the JAX package passes), and one flat block
schedule (``IFORMER_SETTINGS``) sliced by the stage depths, as the JAX
package slices it (``l2_faster``'s attention triplets straddle stages 3
and 4). The blocks:

- ``ConvBlock``: x + drop_path(pw2(pw1(mixer(x)))), the mixer a
  depthwise kxk + BN, or with ``use_reparam`` (the default)
  ``RepDWBlock``: BN(dw kxk(x) + dw 3x3(x) + x), both convs with a bias
  and the BN a bare flax ``nn.BatchNorm`` (momentum 0.99);
- ``RepCPE``: x + BN(dw 3x3(x));
- ``FFN2d``: x + drop_path(1x1 + BN + GELU -> 1x1 + BN);
- ``SHMABlock``: x + drop_path(SHMA(x)). SHMA: v and gate from one 1x1 +
  BN, both through the sigmoid; q and k 1x1 + BN to C / hdrr; single-head
  softmax(q kᵀ / sqrt(d)) v over all h·w tokens in float32 (TF32 off: the
  JAX einsums are float32), cast back, times the gate, a 1x1 + BN.

The ``_faster`` schedules window-split the stream (windows of 16, zero-
padded) at their first stage-3 SHMA; the later blocks run on the
windowed tensor (a depthwise conv sees window borders as zero padding)
until ``wre`` or the stage's end merges it back. GELU is the tanh form.
Drop path is an input (``drop_path_factors``: (blocks, batch), a row for
each schedule entry, the CPE rows ones) at rates linear in the flat
schedule, CPE entries included. No TPU kernel is on this path: the JAX
package's attention is einsums outside Pallas.

Keys follow the reference's ``state_dict`` (the JAX ``convert_iformer``,
``convert.py:712-771``; every conv a Conv2d_BN ``{c, bn}``):
``downsample_layers.0.{0, 2.conv_exp_bn1, 2.conv_pwl_bn2}``,
``downsample_layers.{1-3}.0``, ``stages.{s}.{j}.block.`` +
``token_channel_mixer.m.{0,1,3}`` (ConvBlock), ``cpe.m`` (RepCPE),
``channel_mixer.m.{0,2}`` (FFN2d), ``token_channel_mixer.m.{q,k,v_gate,
proj}`` (SHMA). ``RepDWBlock``, which only the JAX package has, keeps the
JAX names under the mixer's key: ``token_channel_mixer.m.0.{dw_big,
dw_small, bn}``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from segmentation_factory_tpu_torch.models.layers import (
    ConvModule,
    container,
    conv_nhwc,
    drop_path,
    drop_path_factor,
    raw_bn,
)
from segmentation_factory_tpu_torch.registry import register_backbone

CB = ("c", "bn")  # the reference's Conv2d_BN names


def _triplet(hdrr: int, ffn_ratio: int, shma_ratio: int = 1, wsp: bool = False,
             wre: bool = False, ws: int = 0):
    """RepCPE + SHMABlock + FFN2d (one attention group)."""
    return [("cpe", 3), ("shma", shma_ratio, hdrr, ws, wsp, wre), ("ffn", ffn_ratio)]


def _blocks(conv_r, ffn_r, s12, s3_pre, s3_attn, s4_attn, hdrr3=2, hdrr4=4):
    """The standard schedule: conv stages 1-2; stage 3 a conv prefix,
    attention triplets and one trailing conv; stage 4 triplets."""
    flat = [("conv", 7, conv_r)] * (2 * s12)
    flat += [("conv", 7, conv_r)] * s3_pre
    for _ in range(s3_attn):
        flat += _triplet(hdrr3, ffn_r)
    flat += [("conv", 7, conv_r)]
    for _ in range(s4_attn):
        flat += _triplet(hdrr4, ffn_r)
    return flat


def _blocks_faster(conv_r, ffn_r, s12, s3_pre, mid_plain, tail_plain=0):
    """The ``_faster`` schedule: the first stage-3 triplet window-splits
    (ws 16), a later one merges."""
    flat = [("conv", 7, conv_r)] * (2 * s12)
    flat += [("conv", 7, conv_r)] * s3_pre
    flat += _triplet(2, ffn_r, wsp=True, ws=16)
    for _ in range(mid_plain):
        flat += _triplet(2, ffn_r)
    flat += _triplet(2, ffn_r, wre=True, ws=16)
    for _ in range(tail_plain):
        flat += _triplet(2, ffn_r)
    flat += [("conv", 7, conv_r)]
    for _ in range(2):
        flat += _triplet(4, ffn_r)
    return flat


IFORMER_SETTINGS = {
    # name: (depths, dims, flat block schedule)
    "t": ([2, 2, 16, 6], [32, 64, 128, 256], _blocks(3, 2, 2, 6, 3, 2)),
    "s": ([2, 2, 19, 6], [32, 64, 176, 320], _blocks(4, 3, 2, 9, 3, 2)),
    "m": ([2, 2, 22, 6], [48, 96, 192, 384], _blocks(4, 3, 2, 9, 4, 2)),
    "l": ([2, 2, 33, 6], [48, 96, 256, 384], _blocks(4, 3, 2, 8, 8, 2)),
    "l2": ([3, 3, 46, 9], [64, 128, 256, 512], _blocks(4, 3, 3, 12, 11, 3)),
    "h": ([5, 5, 60, 18], [96, 192, 384, 768], _blocks(4, 4, 5, 14, 15, 6, hdrr3=1, hdrr4=1)),
    "m_faster": ([2, 2, 22, 6], [48, 96, 192, 384], _blocks_faster(4, 3, 2, 9, 2)),
    "l_faster": ([2, 2, 33, 6], [48, 96, 256, 384], _blocks_faster(4, 3, 2, 8, 5, tail_plain=1)),
    "l2_faster": ([3, 3, 46, 9], [48, 128, 256, 448],
                  _blocks_faster(4, 3, 3, 12, 9, tail_plain=1)),
}


def _cb(cin: int, cout: int, k: int = 1, stride: int = 1, groups: int = 1,
        act: Optional[str] = None, dtype=torch.bfloat16) -> ConvModule:
    """A JAX ``ConvModule`` (conv without a bias, BN, ``act``) with the
    symmetric padding k // 2, under the reference's ``c`` / ``bn``."""
    return ConvModule(cin, cout, k, stride, k // 2, groups, norm="bn", act=act, dtype=dtype,
                      keys=CB)


class RepDWBlock(nn.Module):
    """BN(dw kxk(x) + dw 3x3(x) + x), the convs with a bias, the BN flax's
    bare ``nn.BatchNorm``."""

    def __init__(self, c: int, kernel: int = 7, dtype=torch.bfloat16):
        super().__init__()
        self.dw_big = nn.Conv2d(c, c, kernel, groups=c)
        self.dw_small = nn.Conv2d(c, c, 3, groups=c)
        self.bn = raw_bn(c)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, k = self.dtype, self.dw_big.kernel_size[0]
        y = conv_nhwc(x, self.dw_big, k // 2, dt) + conv_nhwc(x, self.dw_small, 1, dt) + x.to(dt)
        return self.bn(y)


class ConvBlock(nn.Module):
    def __init__(self, c: int, kernel: int = 7, ratio: float = 4.0, use_reparam: bool = True,
                 dtype=torch.bfloat16):
        super().__init__()
        mixer = (RepDWBlock(c, kernel, dtype) if use_reparam
                 else _cb(c, c, kernel, groups=c, dtype=dtype))
        hidden = int(c * ratio)
        self.token_channel_mixer = container(m=container(**{
            "0": mixer, "1": _cb(c, hidden, act="gelu", dtype=dtype),
            "3": _cb(hidden, c, dtype=dtype)}))

    def forward(self, x: torch.Tensor, factor: Optional[torch.Tensor]) -> torch.Tensor:
        m = self.token_channel_mixer.m._modules
        return x + drop_path(m["3"](m["1"](m["0"](x))), factor)


class RepCPE(nn.Module):
    def __init__(self, c: int, kernel: int = 3, dtype=torch.bfloat16):
        super().__init__()
        self.cpe = container(m=_cb(c, c, kernel, groups=c, dtype=dtype))

    def forward(self, x: torch.Tensor, factor: Optional[torch.Tensor]) -> torch.Tensor:
        return x + self.cpe.m(x)


class FFN2d(nn.Module):
    def __init__(self, c: int, ratio: float = 3.0, dtype=torch.bfloat16):
        super().__init__()
        hidden = int(c * ratio)
        self.channel_mixer = container(m=container(**{
            "0": _cb(c, hidden, act="gelu", dtype=dtype), "2": _cb(hidden, c, dtype=dtype)}))

    def forward(self, x: torch.Tensor, factor: Optional[torch.Tensor]) -> torch.Tensor:
        m = self.channel_mixer.m._modules
        return x + drop_path(m["2"](m["0"](x)), factor)


class SHMA(nn.Module):
    def __init__(self, c: int, ratio: float = 1.0, head_dim_reduce_ratio: int = 4,
                 dtype=torch.bfloat16):
        super().__init__()
        self.mid, self.d_attn = int(c * ratio), c // head_dim_reduce_ratio
        self.v_gate = _cb(c, 2 * self.mid, dtype=dtype)
        self.q = _cb(c, self.d_attn, dtype=dtype)
        self.k = _cb(c, self.d_attn, dtype=dtype)
        self.proj = _cb(self.mid, c, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        n, d = h * w, self.d_attn
        v, gate = torch.sigmoid(self.v_gate(x)).chunk(2, dim=-1)
        qf = self.q(x).reshape(b, n, d).float()
        kf = self.k(x).reshape(b, n, d).float()
        attn = torch.softmax(torch.matmul(qf, kf.transpose(1, 2)) * d ** -0.5, dim=-1)
        out = torch.matmul(attn, v.reshape(b, n, self.mid).float()).reshape(b, h, w, self.mid)
        return self.proj(out.to(x.dtype) * gate)


class SHMABlock(nn.Module):
    def __init__(self, c: int, ratio: float = 1.0, head_dim_reduce_ratio: int = 4,
                 dtype=torch.bfloat16):
        super().__init__()
        self.token_channel_mixer = container(m=SHMA(c, ratio, head_dim_reduce_ratio, dtype))

    def forward(self, x: torch.Tensor, factor: Optional[torch.Tensor]) -> torch.Tensor:
        return x + drop_path(self.token_channel_mixer.m(x), factor)


def window_split(x: torch.Tensor, ws: int):
    """(B, H, W, C) -> (B·nW, ws, ws, C), zero-padded at the bottom / right
    (:239-251), and the sizes ``window_merge`` needs."""
    b, h, w, c = x.shape
    hp, wp = h + (-h) % ws, w + (-w) % ws
    if (hp, wp) != (h, w):
        x = torch.nn.functional.pad(x, (0, 0, 0, wp - w, 0, hp - h))
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c), (h, w, hp, wp)


def window_merge(x: torch.Tensor, ws: int, meta) -> torch.Tensor:
    h, w, hp, wp = meta
    c = x.shape[-1]
    b = x.shape[0] // ((hp // ws) * (wp // ws))
    x = x.reshape(b, hp // ws, wp // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, c)[:, :h, :w]


class iFormer(nn.Module):  # noqa: N801  (the model's name)
    """NHWC image -> 4 NHWC pyramid levels (strides 4 to 32)."""

    def __init__(self, depths: Sequence[int], dims: Sequence[int], schedule: Sequence[tuple],
                 drop_path_rate: float = 0.0, use_reparam: bool = True, dtype=torch.bfloat16):
        super().__init__()
        d = list(dims)
        self.depths, self.dtype = list(depths), dtype
        half = d[0] // 2
        edge = container(conv_exp_bn1=_cb(half, half * 4, 5, 2, act="gelu", dtype=dtype),
                         conv_pwl_bn2=_cb(half * 4, d[0], dtype=dtype))
        stem = container(**{"0": _cb(3, half, 5, 2, act="gelu", dtype=dtype), "2": edge})
        downs = [container(**{"0": _cb(d[s - 1], d[s], 3, 2, dtype=dtype)}) for s in (1, 2, 3)]
        self.downsample_layers = nn.ModuleList([stem] + downs)
        total = sum(depths)
        # np.linspace over the flat schedule, CPE entries included
        self.rates = [float(r) for r in np.linspace(0.0, drop_path_rate, total)]
        self.kinds: List[tuple] = []
        stages, cur = [], 0
        for s in range(4):
            row = []
            for j in range(depths[s]):
                kind, *args = schedule[cur + j]
                self.kinds.append((kind, *args))
                if kind == "conv":
                    blk = ConvBlock(d[s], args[0], args[1], use_reparam, dtype)
                elif kind == "cpe":
                    blk = RepCPE(d[s], args[0], dtype)
                elif kind == "ffn":
                    blk = FFN2d(d[s], args[0], dtype)
                elif kind == "shma":
                    blk = SHMABlock(d[s], args[0], args[1], dtype)
                else:
                    raise KeyError(kind)
                row.append(container(block=blk))
            stages.append(nn.ModuleList(row))
            cur += depths[s]
        self.stages = nn.ModuleList(stages)

    def drop_path_factors(self, batch: int, generator: torch.Generator,
                          device=None) -> torch.Tensor:
        """(blocks, batch) float32 factors, one a schedule entry at its rate
        (a CPE entry, which has no drop path, takes ones)."""
        return torch.stack([drop_path_factor(r if k[0] != "cpe" else 0.0, batch, generator,
                                             device) for r, k in zip(self.rates, self.kinds)])

    def forward(self, x: torch.Tensor,
                factors: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        stem = self.downsample_layers[0]._modules
        x = stem["0"](x)
        x = stem["2"].conv_pwl_bn2(stem["2"].conv_exp_bn1(x))
        feats, i = [], 0
        win: Optional[Tuple[int, tuple]] = None  # (ws, sizes) while the stream is windowed
        for s, stage in enumerate(self.stages):
            if s > 0:
                x = self.downsample_layers[s]._modules["0"](x)
            for entry in stage:
                kind, *args = self.kinds[i]
                f = None if factors is None or self.rates[i] == 0.0 else factors[i]
                if kind == "shma" and args[3]:  # wsp
                    x, meta = window_split(x, args[2])
                    win = (args[2], meta)
                x = entry.block(x, f)
                if kind == "shma" and args[4] and win is not None:  # wre
                    x = window_merge(x, *win)
                    win = None
                i += 1
            if win is not None:  # never carry a windowed stream across stages
                x = window_merge(x, *win)
                win = None
            feats.append(x)
        return feats


def reparameterize_iformer(state_dict: Dict[str, torch.Tensor],
                           eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """Every ``RepDWBlock``'s dw kxk + dw 3x3 + identity + BN folded into
    the kxk conv, for inference (the JAX ``reparameterize_iformer``,
    :332-390, on the port's ``state_dict``): the module still adds x, so
    the kxk kernel becomes scale·(K + I) - I and its bias scale·(b_big +
    b_small - mean) + beta, scale = gamma / sqrt(var + eps); the 3x3 and
    its bias are zero and the BN's statistics and affine the identity. The
    eval forward is unchanged (up to that BN's rsqrt(1 + eps)). Returns a
    new ``state_dict``; the arithmetic is float32, as the JAX function's."""
    out = dict(state_dict)
    for key in state_dict:
        if not key.endswith(".dw_big.weight"):
            continue
        r = key[: -len("dw_big.weight")]
        if f"{r}dw_small.weight" not in state_dict or f"{r}bn.weight" not in state_dict:
            continue
        kb = state_dict[key].float()  # (C, 1, K, K)
        ks = state_dict[f"{r}dw_small.weight"].float()
        mid = kb.shape[-1] // 2
        k = kb.clone()
        k[:, :, mid - 1:mid + 2, mid - 1:mid + 2] += ks
        center = torch.zeros_like(k)
        center[:, 0, mid, mid] = 1.0
        gamma, beta = state_dict[f"{r}bn.weight"].float(), state_dict[f"{r}bn.bias"].float()
        mean, var = (state_dict[f"{r}bn.running_mean"].float(),
                     state_dict[f"{r}bn.running_var"].float())
        scale = gamma / torch.sqrt(var + eps)
        out[key] = (k + center) * scale.view(-1, 1, 1, 1) - center
        out[f"{r}dw_big.bias"] = scale * (state_dict[f"{r}dw_big.bias"].float()
                                          + state_dict[f"{r}dw_small.bias"].float() - mean) + beta
        out[f"{r}dw_small.weight"] = torch.zeros_like(ks)
        out[f"{r}dw_small.bias"] = torch.zeros_like(state_dict[f"{r}dw_small.bias"].float())
        out[f"{r}bn.weight"], out[f"{r}bn.bias"] = torch.ones_like(gamma), torch.zeros_like(beta)
        out[f"{r}bn.running_mean"], out[f"{r}bn.running_var"] = (torch.zeros_like(mean),
                                                                 torch.ones_like(var))
    return out


def _make_iformer(variant: str):
    def factory(dtype=torch.bfloat16, img_size: int = 512, drop_path_rate: float = 0.0,
                use_reparam: bool = True):
        depths, dims, schedule = IFORMER_SETTINGS[variant]
        return (iFormer(depths, dims, schedule, drop_path_rate, use_reparam, dtype), list(dims))

    return factory


for _v in IFORMER_SETTINGS:
    register_backbone(f"iformer_{_v}")(_make_iformer(_v))
