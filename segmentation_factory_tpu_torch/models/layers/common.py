"""Layer helpers of the MiT / SegFormer path.

Port of ``segmentation_factory_tpu/models/layers/common.py``: ``ln_apply``
(:177-187), ``resize`` (:212-241), ``drop_path_rates`` (:332-342) and the
drop-path of ``DropPath`` (:78-91) with its random mask given as an input.
Feature maps are NHWC and token tensors (B, N, C), channels last as in the
JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


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
