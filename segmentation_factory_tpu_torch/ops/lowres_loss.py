"""K7: bilinear upsample fused with CE / OHEM-CE and dice, forward and backward.

Port of ``segmentation_factory_tpu/ops/pallas_loss.py``: the entry
``lowres_criterion`` (:576-617), the TPU kernels ``_forward`` (:261, body
``_fwd_kernel`` :120) and ``_backward`` (:292, body ``_bwd_kernel`` :151), the
``custom_vjp`` ``_fused_loss`` with ``_fused_fwd`` / ``_fused_bwd``
(:484-542) and the glue ``_ce_scalar_and_weights`` (:446),
``_dice_from_partials`` and ``_dice_coefs`` (:423-443). The CUDA kernels are
``csrc/lowres_loss.cu``: K7f writes the per-pixel CE loss map and the
per-image, per-class dice partials (inter, sum p, sum y) from the
low-resolution logits; K7b writes the low-resolution cotangent, each fine
pixel's softmax computed about once (its tiles, regions and weights from
``transpose_geometry.loss_bwd_geometry``, on the device once per shape).
The full-resolution logits never exist. ``lowres_loss_plain`` and
``lowres_loss_bwd_plain`` are their plain versions (resize, then the same
sums; the backward through autograd).

Dispatch follows the JAX package (:606-617): CE and OHEM take the fused
path, class weights only with CE; every other loss type is the plain
composition resize -> ``losses.criterion`` on every device. The dyadic
shape gate is not ported: the kernels take any ratio. The upsample runs in
float32 whatever the logits' dtype (the JAX composition resizes bf16 logits
in bf16; the main path's logits are float32).
"""

from __future__ import annotations

import ctypes

import torch

from segmentation_factory_tpu_torch import losses as L
from segmentation_factory_tpu_torch.models.layers.common import resize
from segmentation_factory_tpu_torch.ops import _build, transpose_geometry

_FWD_ARGTYPES = [_build.VOIDP] * 4 + [_build.INT] * 7 + [_build.INT, _build.VOIDP]
_BWD_ARGTYPES = [_build.VOIDP] * 6 + [ctypes.POINTER(ctypes.c_int)] + [_build.INT] * 7 + [
    _build.INT, _build.VOIDP]
_FUSED = ("ce", "crossentropy", "ohem", "ohemcrossentropy")


def lowres_loss_plain(lo, labels, ignore_index: int = 255):
    """(loss map (B, H, W), dice partials (B, 3, C)), float32, of the float32
    upsample of ``lo`` to the labels' size: lse minus the labelled logit
    (0 at void pixels and labels outside [0, C)), and per image and class
    sum p*y, sum p, sum y over valid pixels."""
    c = lo.shape[-1]
    hi = resize(lo.float(), tuple(labels.shape[1:3]))
    valid = labels != ignore_index
    y = L.one_hot(torch.where(valid, labels, torch.full_like(labels, -1)).long(), c)
    loss = torch.logsumexp(hi, dim=-1) - (hi * y).sum(-1)
    p = torch.softmax(hi, dim=-1) * valid[..., None].float()
    parts = torch.stack([(p * y).sum((1, 2)), p.sum((1, 2)), y.sum((1, 2))], dim=1)
    return loss, parts


def lowres_loss_bwd_plain(lo, labels, wmap, dcoef, ignore_index: int = 255):
    """The cotangent of lo for sum(wmap * loss) + sum(dcoef[:, 0] * inter)
    + sum(dcoef[:, 1] * psum), through autograd of ``lowres_loss_plain``;
    float32 (B, hl, wl, C)."""
    with torch.enable_grad():
        x = lo.detach().float().requires_grad_()
        loss, parts = lowres_loss_plain(x, labels, ignore_index)
        obj = (loss * wmap).sum() + (parts[:, :2] * dcoef).sum()
        return torch.autograd.grad(obj, x)[0]


def _check(lo, labels):
    b, hl, wl, c = lo.shape
    _build.check_cuda(lo, "lo")
    _build.check_cuda(labels, "labels", dtype=torch.int32)
    if labels.dim() != 3 or labels.shape[0] != b:
        raise ValueError(f"labels {tuple(labels.shape)} do not match lo {tuple(lo.shape)}")
    if c > 256:
        raise ValueError(f"at most 256 classes, got {c}")


def lowres_loss_fwd(lo, labels, ignore_index: int = 255):
    """K7f: ``lowres_loss_plain`` through the kernel for CUDA tensors (lo
    float32 or bfloat16, labels int32); the plain version on the CPU."""
    if lo.device.type == "cpu":
        return lowres_loss_plain(lo, labels, ignore_index)
    _check(lo, labels)
    _build.refuse_grad("lowres_loss_fwd", lo)
    b, hl, wl, c = lo.shape
    h, w = labels.shape[1], labels.shape[2]
    loss = torch.empty((b, h, w), dtype=torch.float32, device=lo.device)
    parts = torch.zeros((b, 3, c), dtype=torch.float32, device=lo.device)
    _build.launch(
        "lowres_loss", "sft_lowres_loss_fwd", _FWD_ARGTYPES,
        lo.data_ptr(), labels.data_ptr(), loss.data_ptr(), parts.data_ptr(),
        b, hl, wl, c, h, w, int(ignore_index), _build.DTYPE_CODE[lo.dtype],
        _build.stream_ptr(lo),
    )
    lowres_loss_fwd.launches += 1
    return loss, parts


def lowres_loss_bwd(lo, labels, wmap, dcoef, ignore_index: int = 255):
    """K7b: ``lowres_loss_bwd_plain`` through the kernel for CUDA tensors
    (wmap (B, H, W) and dcoef (B, 2, C) float32); the plain version on the
    CPU."""
    if lo.device.type == "cpu":
        return lowres_loss_bwd_plain(lo, labels, wmap, dcoef, ignore_index)
    _check(lo, labels)
    b, hl, wl, c = lo.shape
    h, w = labels.shape[1], labels.shape[2]
    _build.check_cuda(wmap, "wmap", (b, h, w), torch.float32)
    _build.check_cuda(dcoef, "dcoef", (b, 2, c), torch.float32)
    geo, tab = transpose_geometry.device_tables(
        "loss", (hl, wl, h, w, c, lo.element_size()), lo.device)
    dlo = torch.empty((b, hl, wl, c), dtype=torch.float32, device=lo.device)
    layout = (*geo.offsets, *geo.tile, geo.rows, geo.region_w, geo.dstride, geo.threads,
              geo.smem)
    _build.launch(
        "lowres_loss", "sft_lowres_loss_bwd", _BWD_ARGTYPES,
        lo.data_ptr(), labels.data_ptr(), wmap.data_ptr(), dcoef.data_ptr(), dlo.data_ptr(),
        tab.data_ptr(), (ctypes.c_int * len(layout))(*layout),
        b, hl, wl, c, h, w, int(ignore_index), _build.DTYPE_CODE[lo.dtype],
        _build.stream_ptr(lo),
    )
    lowres_loss_bwd.launches += 1
    return dlo


# ---------------------------------------------------------------- scalar glue


def ce_scalar_and_weights(loss_map, valid, loss_type: str, labels=None, class_weights=None,
                          thresh: float = 0.7, min_kept_ratio: float = 1.0 / 16.0):
    """CE / OHEM-CE scalar from the per-pixel loss map, and the per-pixel
    weight map w / sum(w) of its gradient, the keep-set held constant
    (pallas_loss.py:446-477). ``class_weights`` (CE only) weigh each pixel
    by its label's weight."""
    flat = loss_map.reshape(-1)
    vflat = valid.reshape(-1).float()
    if class_weights is not None:
        cw = torch.as_tensor(class_weights, dtype=torch.float32, device=flat.device)
        safe = torch.where(valid, labels, torch.zeros_like(labels)).reshape(-1).long()
        vflat = vflat * cw[safe.clamp(0, cw.numel() - 1)]
    if loss_type in ("ohem", "ohemcrossentropy"):
        w = L.ohem_keep(flat, vflat > 0, thresh, min_kept_ratio).float()
    else:
        w = vflat
    wsum = w.sum().clamp_min(1.0)
    return (flat * w).sum() / wsum, (w / wsum).reshape(loss_map.shape)


def dice_coefs(inter, psum, ysum, smooth: float = 1e-6):
    """d(dice term)/d inter and d/d psum per (image, class), the empty-set
    rule included (pallas_loss.py:431-443)."""
    b, c = inter.shape
    sets = psum + ysum
    zero = sets == 0.0
    denom = torch.where(zero, 2.0 * inter, sets) + smooth
    num = 2.0 * inter + smooth
    ddi = 2.0 / denom - num / (denom * denom) * zero.float() * 2.0
    ddp = -num / (denom * denom) * (~zero).float()
    scale = -1.0 / (b * c)
    return scale * ddi, scale * ddp


def fused_criterion_plain(lo, labels, loss_type: str, use_dice: bool, ignore_index: int = 255,
                          class_weights=None) -> torch.Tensor:
    """The fused criterion through the plain K7f version and the same glue,
    differentiable by autograd: what ``lowres_criterion`` runs on the CPU,
    and the comparison run of the kernels on the card."""
    loss_map, parts = lowres_loss_plain(lo, labels, ignore_index)
    total, _ = ce_scalar_and_weights(loss_map, labels != ignore_index, loss_type, labels,
                                     class_weights)
    if use_dice:
        total = total + L.dice_from_sums(parts[:, 0], parts[:, 1], parts[:, 2])
    return total


class _FusedLoss(torch.autograd.Function):
    """K7f forward plus the scalar glue; K7b backward (pallas_loss.py:484-542)."""

    @staticmethod
    def forward(ctx, lo, labels, loss_type, use_dice, ignore_index, class_weights):
        loss_map, parts = lowres_loss_fwd(lo, labels, ignore_index)
        total, wmap = ce_scalar_and_weights(loss_map, labels != ignore_index, loss_type,
                                            labels, class_weights)
        if use_dice:
            total = total + L.dice_from_sums(parts[:, 0], parts[:, 1], parts[:, 2])
        ctx.save_for_backward(lo, labels, wmap, parts)
        ctx.use_dice, ctx.ignore_index = use_dice, ignore_index
        return total

    @staticmethod
    def backward(ctx, g):
        lo, labels, wmap, parts = ctx.saved_tensors
        if ctx.use_dice:
            dcoef = torch.stack(dice_coefs(parts[:, 0], parts[:, 1], parts[:, 2]), dim=1)
        else:
            dcoef = torch.zeros_like(parts[:, :2])
        dlo = lowres_loss_bwd(lo, labels, wmap, dcoef.contiguous(), ctx.ignore_index)
        return (dlo * g).to(lo.dtype), None, None, None, None, None


def lowres_criterion(logits_lo, labels, ignore_index: int = 255, use_dice: bool = True,
                     loss_type: str = "ce", class_weights=None) -> torch.Tensor:
    """``losses.criterion`` over head-resolution logits (B, hl, wl, C) and
    full-resolution labels (B, H, W). CE and OHEM go through K7 on CUDA (the
    plain K7f version and autograd on the CPU); other loss types, and class
    weights with OHEM, through resize -> ``losses.criterion``."""
    key = loss_type.lower().replace("_", "")
    if key not in _FUSED or (class_weights is not None and key in ("ohem", "ohemcrossentropy")):
        hi = resize(logits_lo, tuple(labels.shape[1:3]))
        return L.criterion(hi, labels, ignore_index, use_dice=use_dice, loss_type=loss_type,
                           class_weights=class_weights)
    if logits_lo.device.type == "cpu":
        return fused_criterion_plain(logits_lo, labels, key, use_dice, ignore_index,
                                     class_weights)
    cw = None if class_weights is None else tuple(float(x) for x in class_weights)
    return _FusedLoss.apply(logits_lo, labels.to(torch.int32).contiguous(), key, use_dice,
                            ignore_index, cw)


lowres_loss_fwd.launches = 0
lowres_loss_bwd.launches = 0
