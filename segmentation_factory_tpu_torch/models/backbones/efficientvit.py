"""EfficientViT backbones (b0-b3, l0-l3) and their block library.

Port of ``segmentation_factory_tpu/models/backbones/efficientvit.py``:
``DSConv`` (:51), ``MBConv`` (:75), ``FusedMBConv`` (:105), ``ResBlock``
(:131), ``LiteMLA`` (:158-217), ``EfficientViTBlock`` (:219-245), the
b-series (:247-296), the L-series (:298-373) and the eight registered
names (:376-404). Every conv is a ``ConvModule`` (conv -> BatchNorm ->
act) whose norm, activation and bias come from the per-conv ``norms`` /
``acts`` / ``biases`` tuples (``_nt``, the reference's ``val2tuple``): the
"fewer norm" blocks put a bias on their first convs and a BatchNorm only
on the last.

``LiteMLA`` is the multi-scale ReLU linear attention: a 1x1 qkv conv, a 5x5
aggregation (a depthwise conv of 3T groups, then a 1x1 conv of 3·heads
groups) giving a second scale of heads, and per head relu(q) (relu(k)^T
[v | 1]) with the ones column's sum as the normaliser (+ 1e-15), in
float32 by ``torch.matmul``: the JAX package computes these products with
einsums outside Pallas, so no TPU kernel is on this path.

Keys follow the reference's ``state_dict`` (mit-han-lab ``efficientvit``):
a ConvLayer is ``{conv, norm}``; the b-series holds ``input_stem.op_list``
(the stem conv, then residual DSConvs under ``.main``) and
``stages.{0..3}.op_list``; the L-series ``stages.{0..4}.op_list`` (stage 0
the stem); a residual block keeps its body under ``main``, an attention
block under ``context_module.main`` and ``local_module.main``. The
reference's qkv channels are per head [q | k | v] blocks of ``head_dim``,
and the port splits them so (the JAX package permutes the weights to [all
q | all k | all v] in its converter, ``convert.py:272-284``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from segmentation_factory_tpu_torch.models.layers import ConvModule, conv_nhwc
from segmentation_factory_tpu_torch.registry import register_backbone

EFFICIENTVIT_SETTINGS = {
    # name: (widths, depths, attention head_dim)
    "b0": ([8, 16, 32, 64, 128], [1, 2, 2, 2, 2], 16),
    "b1": ([16, 32, 64, 128, 256], [1, 2, 3, 3, 4], 16),
    "b2": ([24, 48, 96, 192, 384], [1, 3, 4, 4, 6], 32),
    "b3": ([32, 64, 128, 256, 512], [1, 4, 6, 6, 9], 32),
}

EFFICIENTVIT_LARGE_SETTINGS = {
    # name: (widths, depths)
    "l0": ([32, 64, 128, 256, 512], [1, 1, 1, 4, 4]),
    "l1": ([32, 64, 128, 256, 512], [1, 1, 1, 6, 6]),
    "l2": ([32, 64, 128, 256, 512], [1, 2, 2, 8, 8]),
    "l3": ([64, 128, 256, 512, 1024], [1, 2, 2, 8, 8]),
}


def _nt(v, n: int) -> tuple:
    """val2tuple: a scalar broadcast to an n-tuple; a sequence kept."""
    if isinstance(v, (tuple, list)):
        assert len(v) == n
        return tuple(v)
    return (v,) * n


def conv_layer(in_ch: int, out_ch: int, kernel: int = 1, stride: int = 1, groups: int = 1,
               norm: Optional[str] = "bn", act: Optional[str] = None, bias: bool = False,
               dtype=torch.bfloat16) -> ConvModule:
    """The reference's ConvLayer: ``{conv, norm}``, padding kernel // 2."""
    return ConvModule(in_ch, out_ch, kernel, stride, padding=kernel // 2, groups=groups,
                      norm=norm or False, act=act, dtype=dtype, keys=("conv", "norm"),
                      use_bias=bool(bias))


class _Convs(nn.Module):
    """ConvLayers applied in their order of creation."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for m in self._modules.values():
            x = m(x)
        return x


def _convs(names: Sequence[str], specs, norms, acts, biases, dtype) -> _Convs:
    """``_Convs`` whose conv ``names[i]`` is ``conv_layer(*specs[i])`` with the
    i-th norm, activation and bias."""
    mod = _Convs()
    for name, (cin, cout, k, stride, groups), n, a, b in zip(names, specs, norms, acts, biases):
        mod.add_module(name, conv_layer(cin, cout, k, stride, groups, n, a, b, dtype))
    return mod


def ds_conv(in_ch, out_ch, stride=1, norms="bn", acts=("relu6", None), biases=False,
            dtype=torch.bfloat16) -> _Convs:
    """Depthwise 3x3 -> pointwise 1x1 (``DSConv``)."""
    return _convs(("depth_conv", "point_conv"),
                  [(in_ch, in_ch, 3, stride, in_ch), (in_ch, out_ch, 1, 1, 1)],
                  _nt(norms, 2), _nt(acts, 2), _nt(biases, 2), dtype)


def mb_conv(in_ch, out_ch, stride=1, expand=6.0, norms="bn", acts=("relu6", "relu6", None),
            biases=False, dtype=torch.bfloat16) -> _Convs:
    """1x1 expand -> depthwise 3x3 -> 1x1 project (``MBConv``)."""
    mid = round(in_ch * expand)
    return _convs(("inverted_conv", "depth_conv", "point_conv"),
                  [(in_ch, mid, 1, 1, 1), (mid, mid, 3, stride, mid), (mid, out_ch, 1, 1, 1)],
                  _nt(norms, 3), _nt(acts, 3), _nt(biases, 3), dtype)


def fused_mb_conv(in_ch, out_ch, stride=1, expand=6.0, norms="bn", acts=("relu6", None),
                  biases=False, dtype=torch.bfloat16) -> _Convs:
    """3x3 expand -> 1x1 project (``FusedMBConv``)."""
    mid = round(in_ch * expand)
    return _convs(("spatial_conv", "point_conv"),
                  [(in_ch, mid, 3, stride, 1), (mid, out_ch, 1, 1, 1)],
                  _nt(norms, 2), _nt(acts, 2), _nt(biases, 2), dtype)


def res_block(in_ch, out_ch, stride=1, expand=1.0, norms="bn", acts=("relu6", None),
              biases=False, dtype=torch.bfloat16) -> _Convs:
    """Two 3x3 convs (``ResBlock``)."""
    mid = round(in_ch * expand)
    return _convs(("conv1", "conv2"), [(in_ch, mid, 3, stride, 1), (mid, out_ch, 3, 1, 1)],
                  _nt(norms, 2), _nt(acts, 2), _nt(biases, 2), dtype)


class Residual(nn.Module):
    """x + main(x), or main(x) alone without a shortcut (the reference's
    ResidualBlock; a strided downsample has none)."""

    def __init__(self, main: nn.Module, shortcut: bool = True):
        super().__init__()
        self.main, self.shortcut = main, shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.main(x)
        return x + y if self.shortcut else y


class OpSequential(nn.Module):
    """Its ``op_list`` applied in order."""

    def __init__(self, ops: Sequence[nn.Module]):
        super().__init__()
        self.op_list = nn.ModuleList(ops)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for op in self.op_list:
            x = op(x)
        return x


EPS = 1e-15  # LiteMLA's normaliser guard (efficientvit.py:211)


def relu_linear_attention(qkv: torch.Tensor, head_dim: int) -> torch.Tensor:
    """One scale of LiteMLA: ``qkv`` (B, H, W, heads·3·d), each head's
    channels [q | k | v] -> (B, H, W, heads·d) in float32: relu(q)
    (relu(k)^T [v | 1]), its last column the normaliser."""
    b, h, w, _ = qkv.shape
    y = qkv.reshape(b, h * w, -1, 3, head_dim).transpose(1, 2)  # (B, heads, N, 3, d)
    q = torch.relu(y[:, :, :, 0]).float()
    k = torch.relu(y[:, :, :, 1]).float()
    v = y[:, :, :, 2].float()
    v1 = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)  # (B, heads, N, d + 1)
    kv = torch.matmul(k.transpose(-1, -2), v1)  # (B, heads, d, d + 1)
    out = torch.matmul(q, kv)  # (B, heads, N, d + 1)
    out = out[..., :-1] / (out[..., -1:] + EPS)
    return out.transpose(1, 2).reshape(b, h, w, -1)


class LiteMLA(nn.Module):
    """Multi-scale ReLU linear attention (``efficientvit.py:158-217``): keys
    ``qkv.conv``, ``aggreg.{i}.{0,1}`` (the depthwise s x s conv and the
    grouped 1x1 conv of scale i) and ``proj.{conv, norm}``."""

    def __init__(self, in_ch: int, out_ch: int, head_dim: int = 32,
                 scales: Tuple[int, ...] = (5,), dtype=torch.bfloat16):
        super().__init__()
        total = (in_ch // head_dim) * head_dim
        heads = total // head_dim
        self.head_dim, self.scales, self.dtype = head_dim, tuple(scales), dtype
        self.qkv = conv_layer(in_ch, 3 * total, 1, norm=None, dtype=dtype)
        self.aggreg = nn.ModuleList(
            nn.Sequential(nn.Conv2d(3 * total, 3 * total, s, groups=3 * total, bias=False),
                          nn.Conv2d(3 * total, 3 * total, 1, groups=3 * heads, bias=False))
            for s in self.scales)
        self.proj = conv_layer(total * (1 + len(self.scales)), out_ch, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = self.qkv(x)
        multi = [qkv]
        for s, (dw, pw) in zip(self.scales, self.aggreg):
            multi.append(conv_nhwc(conv_nhwc(qkv, dw, s // 2, self.dtype), pw, 0, self.dtype))
        y = torch.cat([relu_linear_attention(m, self.head_dim).to(x.dtype) for m in multi],
                      dim=-1)
        return self.proj(y)


class EfficientViTBlock(nn.Module):
    """LiteMLA residual, then a fewer-norm MBConv residual (biases on the
    first two convs, BatchNorm only after the projection)."""

    def __init__(self, ch: int, head_dim: int = 32, expand: float = 4.0, act: str = "hswish",
                 scales: Tuple[int, ...] = (5,), dtype=torch.bfloat16):
        super().__init__()
        self.context_module = Residual(LiteMLA(ch, ch, head_dim, scales, dtype))
        self.local_module = Residual(mb_conv(ch, ch, 1, expand, (None, None, "bn"),
                                             (act, act, None), (True, True, False), dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.local_module(self.context_module(x))


class _Backbone(nn.Module):
    """The four stages' outputs (strides 4, 8, 16, 32) after the stem."""

    def parts(self) -> Tuple[nn.Module, Sequence[nn.Module]]:
        raise NotImplementedError

    def forward(self, x: torch.Tensor, drop_path=None) -> List[torch.Tensor]:
        stem, stages = self.parts()
        x = stem(x)
        feats = []
        for stage in stages:
            x = stage(x)
            feats.append(x)
        return feats


class EfficientViTBackbone(_Backbone):
    """The b-series: a stem conv and residual DSConvs, MBConv stages 1-2
    (the first block strided, without a shortcut), then stages 3-4 of a
    fewer-norm MBConv downsample and attention blocks."""

    def __init__(self, widths: Sequence[int], depths: Sequence[int], head_dim: int = 32,
                 expand: float = 4.0, act: str = "hswish", dtype=torch.bfloat16):
        super().__init__()
        w, d, a = list(widths), list(depths), act
        self.input_stem = OpSequential(
            [conv_layer(3, w[0], 3, 2, act=a, dtype=dtype)]
            + [Residual(ds_conv(w[0], w[0], acts=(a, None), dtype=dtype)) for _ in range(d[0])])
        stages = []
        for s in (1, 2):
            stages.append(OpSequential([
                Residual(mb_conv(w[s - 1] if i == 0 else w[s], w[s], 2 if i == 0 else 1, expand,
                                 acts=(a, a, None), dtype=dtype), shortcut=i > 0)
                for i in range(d[s])]))
        for s in (3, 4):
            down = Residual(mb_conv(w[s - 1], w[s], 2, expand, (None, None, "bn"), (a, a, None),
                                    (True, True, False), dtype), shortcut=False)
            stages.append(OpSequential([down] + [
                EfficientViTBlock(w[s], head_dim, expand, a, dtype=dtype) for _ in range(d[s])]))
        self.stages = nn.ModuleList(stages)

    def parts(self):
        return self.input_stem, self.stages


class EfficientViTLargeBackbone(_Backbone):
    """The L-series: stage 0 (a stem conv and residual ResBlocks), then
    stages 1-4 of kinds fmb / fmb / mb / att with expands 4 / 4 / 4 / 6,
    each opened by a non-residual downsample of its own kind (mb for att)
    expanding 4x more; stages 3-4 fewer-norm; GELU (tanh), 32-dim heads."""

    BLOCKS = ("res", "fmb", "fmb", "mb", "att")
    EXPANDS = (1.0, 4.0, 4.0, 4.0, 6.0)
    FEWER_NORM = (False, False, False, True, True)

    def __init__(self, widths: Sequence[int], depths: Sequence[int], head_dim: int = 32,
                 act: str = "gelu", dtype=torch.bfloat16):
        super().__init__()
        w, d = list(widths), list(depths)
        self.act, self.dtype = act, dtype
        stages = [OpSequential([conv_layer(3, w[0], 3, 2, act=act, dtype=dtype)] + [
            Residual(self._local("res", w[0], w[0], 1, self.EXPANDS[0], False))
            for _ in range(d[0])])]
        for s in (1, 2, 3, 4):
            kind, fewer = self.BLOCKS[s], self.FEWER_NORM[s]
            down_kind = kind if kind in ("mb", "fmb") else "mb"
            ops = [Residual(self._local(down_kind, w[s - 1], w[s], 2, self.EXPANDS[s] * 4, fewer),
                            shortcut=False)]
            for _ in range(d[s]):
                if kind == "att":
                    ops.append(EfficientViTBlock(w[s], head_dim, self.EXPANDS[s], act,
                                                 dtype=dtype))
                else:
                    ops.append(Residual(self._local(kind, w[s], w[s], 1, self.EXPANDS[s],
                                                    fewer)))
            stages.append(OpSequential(ops))
        self.stages = nn.ModuleList(stages)

    def parts(self):
        return self.stages[0], self.stages[1:]

    def _local(self, kind, in_ch, out_ch, stride, expand, fewer) -> _Convs:
        """build_local_block (``efficientvit.py:316-340``)."""
        a, dt = self.act, self.dtype
        if kind == "mb":
            return mb_conv(in_ch, out_ch, stride, expand, (None, None, "bn") if fewer else "bn",
                           (a, a, None), (True, True, False) if fewer else False, dt)
        make = {"res": res_block, "fmb": fused_mb_conv}[kind]
        return make(in_ch, out_ch, stride, expand, (None, "bn") if fewer else "bn", (a, None),
                    (True, False) if fewer else False, dt)


def _make_efficientvit(variant: str):
    def factory(dtype=torch.bfloat16, img_size: int = 512, **kwargs):
        widths, depths, head_dim = EFFICIENTVIT_SETTINGS[variant]
        return (EfficientViTBackbone(widths, depths, head_dim=head_dim, dtype=dtype, **kwargs),
                list(widths[1:]))

    return factory


def _make_efficientvit_large(variant: str):
    def factory(dtype=torch.bfloat16, img_size: int = 512, **kwargs):
        widths, depths = EFFICIENTVIT_LARGE_SETTINGS[variant]
        return (EfficientViTLargeBackbone(widths, depths, dtype=dtype, **kwargs),
                list(widths[1:]))

    return factory


for _v in EFFICIENTVIT_SETTINGS:
    register_backbone(f"efficientvit_{_v}")(_make_efficientvit(_v))
for _v in EFFICIENTVIT_LARGE_SETTINGS:
    register_backbone(f"efficientvit_{_v}")(_make_efficientvit_large(_v))
