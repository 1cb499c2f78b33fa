"""K6: SegFormerHead's training tail — train-mode BatchNorm, ReLU, channel
dropout and the float32 classifier in one pass over the fuse tensor.

Port of ``segmentation_factory_tpu/ops/pallas_head_tail.py``: the entry
``head_tail_train`` (:193-207, a ``custom_vjp``), its batch statistics
``_stats`` (:185-190), the TPU kernels ``_forward`` (:161) and the two
pallas_calls of ``_bwd_rule`` (:216, the reduction at :231 and the input
cotangent at :254), and the twin ``head_tail_xla`` (:282-292), here
``head_tail_plain``. The CUDA kernels are ``csrc/head_tail.cu``: K6f, one
call of three launches (the batch statistics' partial sums, the step that
finishes mean, var and rsig on the device, and the logits, a thread's
pixels x all classes of a slice in registers); K6b's two passes, the
reduction and the input cotangent, in another (``head_tail_bwd``; on the
CPU their plain versions, ``bwd_reduce_plain`` and ``bwd_ds_plain``).

The classifier is read in ``linear_pred.weight``'s layout, (NC, E, 1, 1)
(or (NC, E)), with no transposed copy, and its gradient is returned in the
same layout. The mean and variance outputs are for the caller's
running-statistics update; their cotangents are ignored (the JAX package
does not differentiate buffer writes either). The dropout mask is data and
gets no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from segmentation_factory_tpu_torch.ops import _build

MAX_CLASSES = 256
STATS_SPLITS = 1024  # the statistics' partial sums at most (rows of (2, E) float32)
_LL = ctypes.c_longlong
_TAIL = [_build.VOIDP] * 6  # mu, rsig, gamma, beta, dmask, w
_SHAPE = [_LL, _build.INT, _build.INT, _build.INT, _build.INT, _build.VOIDP]
_FWD_ARGTYPES = [_build.VOIDP] * 7 + [_build.INT, _build.FLOAT] + [_build.VOIDP] * 4 + _SHAPE
_PLAN_ARGTYPES = [_LL] + [_build.INT] * 4 + [ctypes.POINTER(ctypes.c_int)]
_RED_ARGTYPES = [_build.VOIDP] + _TAIL + [_build.VOIDP] * 5 + _SHAPE
_DS_ARGTYPES = [_build.VOIDP] + _TAIL + [_build.VOIDP] * 4 + _SHAPE


def stats_plain(s):
    """Float32 batch mean and variance over all but the channel axis, the
    variance as E[s^2] - E[s]^2 clipped at 0 (flax ``_compute_stats``)."""
    sf = s.float()
    axes = tuple(range(s.dim() - 1))
    mean = sf.mean(axes)
    return mean, ((sf * sf).mean(axes) - mean * mean).clamp_min(0.0)


def head_tail_plain(s, gamma, beta, dmask, wcls, bcls, eps: float):
    """(logits, mean, var) of classifier(dropout(relu(BN_train(s)))): s
    (B, H, W, E) float32 or bfloat16; y1 = xhat * gamma + beta is rounded to
    s's dtype before the ReLU, the mask (B, E) multiplies in float32 and the
    classifier ``wcls`` (NC, E[, 1, 1]), ``bcls`` runs in float32. Logits
    (B, H, W, NC) float32."""
    mean, var = stats_plain(s)
    xhat = (s.float() - mean) * torch.rsqrt(var + eps)
    y1 = (xhat * gamma.float() + beta.float()).to(s.dtype)
    y3 = torch.relu(y1).float() * dmask.float()[:, None, None, :]
    w = wcls.reshape(wcls.shape[0], -1).float()
    return y3 @ w.t() + bcls.float(), mean, var


def _check(s, gamma, beta, dmask, wcls, bcls=None) -> None:
    b, _, _, e = s.shape
    nc = wcls.shape[0]
    _build.check_cuda(s, "s")
    if e % 4:
        raise ValueError(f"channels {e} must be a multiple of 4")
    if not 1 <= nc <= MAX_CLASSES:
        raise ValueError(f"classes {nc} not in [1, {MAX_CLASSES}]")
    if wcls.numel() != nc * e:
        raise ValueError(f"wcls {tuple(wcls.shape)} is not (NC, {e}[, 1, 1])")
    f32 = torch.float32
    for t, name, shape in ((gamma, "gamma", (e,)), (beta, "beta", (e,)), (dmask, "dmask", (b, e)),
                           (wcls, "wcls", tuple(wcls.shape)), (bcls, "bcls", (nc,))):
        if t is not None:
            _build.check_cuda(t, name, shape, f32)


def _dims(s, wcls):
    b, h, w, e = s.shape
    return [b * h * w, h * w, e, wcls.shape[0], _build.DTYPE_CODE[s.dtype], _build.stream_ptr(s)]


def _forward(s, gamma, beta, dmask, wcls, bcls, eps):
    """K6f: (logits, mean, var, rsig), rsig = 1 / sqrt(var + eps)."""
    e = s.shape[-1]
    f32 = {"dtype": torch.float32, "device": s.device}
    mean, var, rsig = (torch.empty((e,), **f32) for _ in range(3))
    part = torch.empty((STATS_SPLITS, 2, e), **f32)
    logits = torch.empty((*s.shape[:3], wcls.shape[0]), **f32)
    _build.launch("head_tail", "sft_head_tail_fwd", _FWD_ARGTYPES, s.data_ptr(),
                  gamma.data_ptr(), beta.data_ptr(), dmask.data_ptr(), wcls.data_ptr(),
                  bcls.data_ptr(), part.data_ptr(), STATS_SPLITS, eps, mean.data_ptr(),
                  var.data_ptr(), rsig.data_ptr(), logits.data_ptr(), *_dims(s, wcls))
    head_tail_train.launches += 1
    return logits, mean, var, rsig


def fwd_plan(shape, nc: int, dtype) -> dict:
    """K6f's launch geometry on the current CUDA card for s of ``shape``
    (B, H, W, E) and ``nc`` classes: the statistics' channel chunks and
    splits (blocks (chunks, splits)), and the logits kernel's classes a
    slice (a thread's, all of them), pixels a thread, class slices, blocks
    a slice and shared memory bytes."""
    plan = (ctypes.c_int * 7)()
    _build.launch("head_tail", "sft_head_tail_fwd_plan", _PLAN_ARGTYPES,
                  shape[0] * shape[1] * shape[2], shape[3], nc, _build.DTYPE_CODE[dtype],
                  STATS_SPLITS, plan)
    return dict(zip(("stats_chunks", "stats_splits", "classes_a_slice", "pixels_a_thread",
                     "class_slices", "logits_blocks", "logits_smem"), plan))


def _bwd_terms(s, gamma, beta, dmask, wcls, mean, rsig, g):
    """(xhat, y3, dy1, dl) of K6b in float32, (B, H*W, E) and (B, H*W, NC)."""
    b, e, nc = s.shape[0], s.shape[-1], wcls.shape[0]
    xhat = (s.float().reshape(b, -1, e) - mean) * rsig
    y1 = (xhat * gamma + beta).to(s.dtype).float()
    dm = dmask.float()[:, None, :]
    dl = g.float().reshape(b, -1, nc)
    dy1 = (dl @ wcls.reshape(nc, e).float()) * dm * (y1 > 0)
    return xhat, torch.relu(y1) * dm, dy1, dl


def bwd_reduce_plain(s, gamma, beta, dmask, wcls, mean, rsig, g):
    """K6b's first pass (the Pallas ``_bwd_red_kernel``): (dwcls in wcls's
    layout, dbcls, dgamma, dbeta), float32 sums over the pixels."""
    xhat, y3, dy1, dl = _bwd_terms(s, gamma, beta, dmask, wcls, mean, rsig, g)
    dw = torch.einsum("bpe,bpk->ke", y3, dl).reshape(wcls.shape)
    return dw, dl.sum((0, 1)), (dy1 * xhat).sum((0, 1)), dy1.sum((0, 1))


def bwd_ds_plain(s, gamma, beta, dmask, wcls, mean, rsig, g, dgm, dbm):
    """K6b's second pass (the Pallas ``_bwd_ds_kernel``): ds = gamma * rsig *
    (dy1 - dbm - xhat * dgm) in s's dtype, for dgm = dgamma / N and dbm =
    dbeta / N."""
    xhat, _, dy1, _ = _bwd_terms(s, gamma, beta, dmask, wcls, mean, rsig, g)
    return (gamma * rsig * (dy1 - dbm - xhat * dgm)).to(s.dtype).view(s.shape)


def head_tail_bwd(s, gamma, beta, dmask, wcls, mean, rsig, g):
    """K6b: (ds, dgamma, dbeta, dwcls, dbcls) for the cotangent ``g``
    (B, H, W, NC) float32 of the logits; ``mean``, ``rsig`` of the forward.
    ds in s's dtype, dwcls in wcls's layout, dgamma and dbeta raw sums over
    the pixels; float32 otherwise. CUDA tensors run the two passes' kernels
    (``launches`` counts a call once both were launched), CPU tensors their
    plain versions."""
    n = s.numel() // s.shape[-1]
    if s.device.type == "cpu":
        dw, db, dgamma, dbeta = bwd_reduce_plain(s, gamma, beta, dmask, wcls, mean, rsig, g)
        ds = bwd_ds_plain(s, gamma, beta, dmask, wcls, mean, rsig, g, dgamma / n, dbeta / n)
        return ds, dgamma, dbeta, dw, db
    _check(s, gamma, beta, dmask, wcls)
    _build.check_cuda(g, "g", (*s.shape[:3], wcls.shape[0]), torch.float32)
    e, nc = s.shape[-1], wcls.shape[0]
    dev = s.device
    dw = torch.zeros_like(wcls)
    db = torch.zeros((nc,), dtype=torch.float32, device=dev)
    dgamma = torch.zeros((e,), dtype=torch.float32, device=dev)
    dbeta = torch.zeros((e,), dtype=torch.float32, device=dev)
    tail = [mean.data_ptr(), rsig.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            dmask.data_ptr(), wcls.data_ptr()]
    _build.launch("head_tail", "sft_head_tail_bwd_reduce", _RED_ARGTYPES, s.data_ptr(), *tail,
                  g.data_ptr(), dw.data_ptr(), db.data_ptr(), dgamma.data_ptr(),
                  dbeta.data_ptr(), *_dims(s, wcls))
    dgm, dbm = dgamma / n, dbeta / n
    ds = torch.empty_like(s)
    _build.launch("head_tail", "sft_head_tail_bwd_ds", _DS_ARGTYPES, s.data_ptr(), *tail,
                  g.data_ptr(), dgm.data_ptr(), dbm.data_ptr(), ds.data_ptr(), *_dims(s, wcls))
    head_tail_bwd.launches += 1
    return ds, dgamma, dbeta, dw, db


class _HeadTail(torch.autograd.Function):
    """K6f forward, K6b backward."""

    @staticmethod
    def forward(ctx, s, gamma, beta, dmask, wcls, bcls, eps):
        logits, mean, var, rsig = _forward(s, gamma, beta, dmask, wcls, bcls, eps)
        ctx.save_for_backward(s, gamma, beta, dmask, wcls, mean, rsig)
        ctx.mark_non_differentiable(mean, var)
        return logits, mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        ds, dgamma, dbeta, dw, db = head_tail_bwd(*ctx.saved_tensors, g.contiguous())
        return ds, dgamma, dbeta, None, dw, db, None


def head_tail_train(s, gamma, beta, dmask, wcls, bcls, eps: float):
    """``head_tail_plain`` through K6f for CUDA tensors (s contiguous,
    float32 or bfloat16, channels a multiple of 4; every other input
    float32; at most ``MAX_CLASSES`` classes), with K6b as the backward when
    a gradient is needed; the plain version on the CPU."""
    if s.device.type == "cpu":
        return head_tail_plain(s, gamma, beta, dmask, wcls, bcls, eps)
    _check(s, gamma, beta, dmask, wcls, bcls)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (s, gamma, beta, wcls, bcls)):
        return _HeadTail.apply(s, gamma, beta, dmask, wcls, bcls, eps)
    return _forward(s, gamma, beta, dmask, wcls, bcls, eps)[:3]


head_tail_train.launches = 0
head_tail_bwd.launches = 0
