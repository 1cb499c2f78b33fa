"""Layer helpers.

Port of ``segmentation_factory_tpu/models/layers/common.py``: ``ln_apply``
(:177-187), ``resize`` (:212-241), ``resize_like`` (:244),
``resize_align_corners`` (:248-280), ``resize_torch_bicubic`` (:282-316),
``resize_nearest_legacy`` (:319),
``drop_path_rates`` (:332-342), ``resample_weights`` (``jax.image.resize``'s
per-axis weights, bilinear and bicubic) and the drop-path of ``DropPath`` (:78-91)
with its random mask given as an input.
Feature maps are NHWC and token tensors (B, N, C), channels last as in the
JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def ln_apply(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis with flax's math: float32 statistics,
    the fast variance E[x^2] - E[x]^2 clipped at 0, scale and bias applied
    in float32. Returns float32; callers cast to their compute dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y * weight.float() + bias.float()


def container(**mods) -> torch.nn.Module:
    """A module whose children are ``mods``, named by their keywords: a
    ``state_dict`` path of the reference's (``network.0``, ``m.3``, ...)
    without a forward of its own."""
    m = torch.nn.Module()
    for k, v in mods.items():
        m.add_module(k, v)
    return m


def rounded(value: float, dtype) -> float:
    """``value`` rounded to ``dtype`` (through float32), as a Python float:
    what a weakly typed Python scalar becomes when it meets a JAX array of
    ``dtype``."""
    return float(torch.tensor(value, dtype=torch.float32, device="cpu").to(dtype))


def bilinear_taps(n_in: int, n_out: int, device=None):
    """Source indices (i0, i1) and float32 weight of i1 for each of
    ``n_out`` samples of a length-``n_in`` axis: half-pixel centres
    (align_corners=False), source coordinate clamped to the edge, no
    antialias — ``jax.image.resize``'s bilinear without antialias, for
    upsampling and downsampling alike."""
    pos = (torch.arange(n_out, device=device, dtype=torch.float32) + 0.5) * (
        n_in / n_out) - 0.5
    pos = pos.clamp_min(0.0)
    i0 = pos.floor().long().clamp_max(n_in - 1)
    i1 = (i0 + 1).clamp_max(n_in - 1)
    return i0, i1, pos - i0


def resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NHWC ``x`` to ``size`` (rows first, then
    columns). float32 and float16 inputs interpolate in float32; bfloat16
    inputs interpolate in bfloat16, as the JAX function does."""
    h, w = x.shape[1], x.shape[2]
    if (h, w) == tuple(size):
        return x
    ct = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    xc = x.to(ct)
    i0, i1, wy = bilinear_taps(h, size[0], x.device)
    wy = wy.to(ct).view(1, -1, 1, 1)
    xc = xc[:, i0] * (1 - wy) + xc[:, i1] * wy
    j0, j1, wx = bilinear_taps(w, size[1], x.device)
    wx = wx.to(ct).view(1, 1, -1, 1)
    xc = xc[:, :, j0] * (1 - wx) + xc[:, :, j1] * wx
    return xc.to(x.dtype)


def resize_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``resize`` of NHWC ``x`` to the spatial size of ``ref``."""
    return resize(x, (ref.shape[1], ref.shape[2]))


def _align_corners_taps(n_in: int, n_out: int, device=None):
    """Source indices (lo, lo + 1) and float32 weight of lo + 1 for each of
    ``n_out`` samples at i * (n_in - 1) / (n_out - 1), lo clipped to
    n_in - 2 (the JAX ``_ac_weights`` rows)."""
    pos = torch.arange(n_out, device=device, dtype=torch.float32) * (
        (n_in - 1) / max(n_out - 1, 1))
    lo = pos.floor().long().clamp(0, n_in - 2)
    return lo, lo + 1, pos - lo


def resize_align_corners(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NHWC ``x`` with ``align_corners=True``, rows then
    columns, in float32, cast back to x's dtype (the PPM's upsample). An
    axis of length 1 is broadcast."""
    h, w = x.shape[1], x.shape[2]
    if (h, w) == tuple(size):
        return x
    y = x.float()
    for axis, n_in, n_out in ((1, h, size[0]), (2, w, size[1])):
        if n_in == 1:
            y = y.expand(*[n_out if a == axis else -1 for a in range(4)])
            continue
        lo, hi, t = _align_corners_taps(n_in, n_out, x.device)
        t = t.view(*[-1 if a == axis else 1 for a in range(4)])
        y = y.index_select(axis, lo) * (1.0 - t) + y.index_select(axis, hi) * t
    return y.to(x.dtype)


def resize_torch_bicubic(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bicubic resize of NHWC ``x`` to ``size``: torch's kernel (a = -0.75),
    half-pixel centres (align_corners=False), source indices clamped at the
    borders, in float32, cast back to x's dtype (the EfficientViT-Seg
    head's upsample). ``F.interpolate`` on a float32 NCHW view is that
    function; the JAX package computes it as two matmuls."""
    h, w = x.shape[1], x.shape[2]
    if (h, w) == tuple(size):
        return x
    y = F.interpolate(x.float().permute(0, 3, 1, 2), size=tuple(size), mode="bicubic",
                      align_corners=False)
    return y.permute(0, 2, 3, 1).contiguous().to(x.dtype)


def resize_nearest_legacy(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """torch's legacy ``F.interpolate(mode='nearest')`` of NHWC ``x``: source
    index floor(dst * in / out), in integers."""
    h, w = x.shape[1], x.shape[2]
    if (h, w) == tuple(size):
        return x
    ys = (torch.arange(size[0], device=x.device) * h // size[0]).clamp_max(h - 1)
    xs = (torch.arange(size[1], device=x.device) * w // size[1]).clamp_max(w - 1)
    return x[:, ys][:, :, xs]


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic with a = -0.5 of |distance| ``x``, in jax's order of
    operations (``_fill_keys_cubic_kernel``)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


RESAMPLE_KERNELS = {"bilinear": _triangle, "bicubic": _keys_cubic}


def resample_weights(n_in: int, n_out: int, device=None, method: str = "bilinear") -> torch.Tensor:
    """(n_out, n_in) float32 weights of ``jax.image.resize`` along one axis
    (``scale_and_translate``, ``compute_weight_mat``): half-pixel centres,
    the triangle (``"bilinear"``) or Keys' cubic with a = -0.5
    (``"bicubic"``) kernel of the distance to each input sample, widened by
    n_in / n_out when it shrinks (antialiasing); taps outside the input
    dropped and each output's weights normalised to sum 1; a sample outside
    [-0.5, n_in - 0.5] takes none. torch's ``F.interpolate`` bicubic is
    another function (a = -0.75, borders clamped)."""
    f32 = dict(dtype=torch.float32, device=device)
    inv = torch.tensor(1.0 / (n_out / n_in), **f32)  # jax's inv_scale, rounded once
    width = torch.clamp(inv, min=1.0)
    sample = (torch.arange(n_out, **f32) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, **f32)[:, None]).abs() / width
    w = RESAMPLE_KERNELS[method](x)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0).T.contiguous()


def drop_path_rates(total_rate: float, depths: Sequence[int]) -> List[List[float]]:
    """Per-block stochastic-depth rates rising linearly from 0 to
    ``total_rate`` over all blocks (timm convention), grouped by stage."""
    total = sum(depths)
    if total <= 1:
        return [[0.0] * d for d in depths]
    rates = [total_rate * i / (total - 1) for i in range(total)]
    out, i = [], 0
    for d in depths:
        out.append(rates[i:i + d])
        i += d
    return out


def drop_path_factor(rate: float, batch: int, generator: torch.Generator,
                     device=None) -> torch.Tensor:
    """(batch,) float32 per-sample drop-path factor: 1 / (1 - rate) with
    probability 1 - rate, else 0; all ones when ``rate`` is 0."""
    if rate == 0.0:
        return torch.ones((batch,), device=device)
    keep = 1.0 - rate
    mask = torch.rand((batch,), generator=generator, device=device) < keep
    return mask.float() / keep


def drop_path(x: torch.Tensor, factor: Optional[torch.Tensor]) -> torch.Tensor:
    """Scale each sample of ``x`` (B, ...) by its float32 ``factor`` (B,),
    in float32, cast back to x's dtype — ``DropPath`` with the mask and
    1 / keep folded into the factor. ``None`` is the identity (eval)."""
    if factor is None:
        return x
    return (x * factor.view(-1, *([1] * (x.dim() - 1)))).to(x.dtype)
