"""K1: spatial-reduction attention, softmax(q kᵀ · scale) v per batch·head.

Port of ``segmentation_factory_tpu/ops/pallas_attention.py``: the entry
``sra_attention`` (:245-275), its TPU kernels ``_forward`` (:77, body
``_kernel`` :60) and ``_backward`` (:164, body ``_bwd_kernel`` :120), and the
``custom_vjp`` ``_sra_fused`` (:111-231). The CUDA kernels are
``csrc/sra_attention.cu`` (K1f) and ``csrc/sra_attention_bwd.cu`` (K1b);
``sra_attention_plain`` is the plain version (the ``_reference`` einsum,
:53-57, softmax in float32) and its autograd is the plain backward.

A forward that needs a gradient runs as ``_SraAttention`` on a CUDA
tensor (K1f also writes each row's log-sum-exp, and the backward is K1b)
and as the plain version with autograd on a CPU one. Without one, the
forward is the registered op ``sft::sra_attention_fwd``
(``sra_attention_fwd``): K1f alone on the card, the plain version on the
CPU, and an empty output of q's shape under fake tensors, so that
``torch.export`` traces it into the graph. K1b's core, ``sra_attention_bwd_core``
(plain version ``sra_attention_bwd_plain``, fed by
``sra_attention_lse_plain``), is also the attention half-block backward's
(``ops/block.py``, K3b).
"""

from __future__ import annotations

import torch

from segmentation_factory_tpu_torch.ops import _build

_FWD_ARGTYPES = [_build.VOIDP] * 5 + [_build.INT] * 5 + [
    _build.FLOAT, _build.INT, _build.VOIDP]
_BWD_ARGTYPES = [_build.VOIDP] * 12 + [_build.INT] * 5 + [
    _build.FLOAT, _build.INT, _build.VOIDP]
HEAD_DIMS = (32, 64)
LOG2E = 1.4426950408889634
_ROW_TILE = 64  # K1b pads its per-row delta and lse to a multiple of this


def sra_attention_plain(q, k, v, scale: float):
    """(B, N, H, D) x (B, M, H, D) einsum attention in q's dtype, softmax
    in float32."""
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", p, v)


def _check(q, k, v) -> None:
    b, n, h, d = q.shape
    m = k.shape[1]
    _build.check_cuda(q, "q")
    _build.check_cuda(k, "k", (b, m, h, d), q.dtype)
    _build.check_cuda(v, "v", (b, m, h, d), q.dtype)
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if m < 1 or n < 1:
        raise ValueError("empty sequence")


def _forward(q, k, v, scale: float, lse=None):
    b, n, h, d = q.shape
    out = torch.empty_like(q)
    _build.launch(
        "sra_attention", "sft_sra_attention", _FWD_ARGTYPES,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        b, n, k.shape[1], h, d, float(scale), _build.DTYPE_CODE[q.dtype],
        _build.stream_ptr(q),
    )
    sra_attention.launches += 1
    return out


def sra_attention_lse_plain(q, k, scale: float):
    """The forward's per-row log-sum-exp in the log2 domain (what K1f
    writes for K1b): (B, H, N) float32 log2 sum_m 2^(s * log2 e)."""
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    return torch.logsumexp(s, dim=-1) * LOG2E


def sra_attention_bwd_plain(q, k, v, o, dout, lse, scale: float, dbq: bool = False):
    """K1b's core in float32 from the forward's output ``o``, the cotangent
    ``dout`` and the (B, H, N) log2-domain ``lse``: (dq in q's dtype, dk and
    dv float32 (B, M, H, D), delta = rowsum(dout * o) (B, H, N) float32,
    and with ``dbq`` the column sums of dq as an (H * D,) float32, else
    None). p = 2^(s * log2 e - lse) with s = q kᵀ · scale."""
    f = lambda t: t.float()  # noqa: E731
    s = torch.einsum("bnhd,bmhd->bhnm", f(q), f(k)) * (scale * LOG2E)
    p = torch.exp2(s - lse.float()[..., None])
    delta = (f(dout) * f(o)).sum(-1).transpose(1, 2)
    dp = torch.einsum("bnhd,bmhd->bhnm", f(dout), f(v))
    ds = p * (dp - delta[..., None])
    dq = (torch.einsum("bhnm,bmhd->bnhd", ds, f(k)) * scale).to(q.dtype)
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, f(q)) * scale
    dv = torch.einsum("bhnm,bnhd->bmhd", p, f(dout))
    col = dq.float().sum((0, 1)).reshape(-1) if dbq else None
    # contiguous, as the kernels write them
    return dq.contiguous(), dk.contiguous(), dv.contiguous(), delta.contiguous(), col


def sra_attention_bwd_core(q, k, v, o, dout, lse, scale: float, dbq: bool = False):
    """K1b's kernels (``csrc/sra_attention_bwd.cu``) under
    ``sra_attention_bwd_plain``'s contract. CUDA tensors launch them
    (``launches`` counts every call, K1b's and K3b's), CPU tensors take the
    plain version."""
    if q.device.type == "cpu":
        return sra_attention_bwd_plain(q, k, v, o, dout, lse, scale, dbq)
    _check(q, k, v)
    b, n, h, d = q.shape
    m = k.shape[1]
    _build.check_cuda(o, "o", q.shape, q.dtype)
    _build.check_cuda(dout, "dout", q.shape, q.dtype)
    _build.check_cuda(lse, "lse", (b, h, n), torch.float32)
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    dk, dv = torch.zeros((b, m, h, d), **f32), torch.zeros((b, m, h, d), **f32)
    # delta and the lse of every query row, padded to the kernels' 64-row tiles
    rows = torch.empty((2, b, h, -(-n // _ROW_TILE) * _ROW_TILE), **f32)
    col = torch.zeros((h * d,), **f32) if dbq else None
    _build.launch(
        "sra_attention_bwd", "sft_sra_attention_bwd", _BWD_ARGTYPES,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), rows[0].data_ptr(), rows[1].data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), None if col is None else col.data_ptr(),
        b, n, m, h, d, float(scale), _build.DTYPE_CODE[q.dtype], _build.stream_ptr(q),
    )
    sra_attention_bwd_core.launches += 1
    return dq, dk, dv, rows[0, :, :, :n], col


def sra_attention_bwd(q, k, v, out, lse, g, scale: float):
    """K1b: (dq, dk, dv) of ``sra_attention`` for the cotangent ``g`` of its
    output ``out``, from the forward's (B, H, N) float32 ``lse``, through
    ``sra_attention_bwd_core``. CUDA tensors only; dq in q's dtype, dk and
    dv accumulated in float32 and cast to k's."""
    _build.check_cuda(q, "q")
    dq, dk, dv, _, _ = sra_attention_bwd_core(q, k, v, out, g, lse, scale)
    sra_attention_bwd.launches += 1
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def _fwd_op(q, k, v, scale):
    """K1f on the card as ``sft::sra_attention_fwd`` runs it: the checks,
    then the kernel (``launches`` counts it)."""
    _check(q, k, v)
    return _forward(q, k, v, scale)


sra_attention_fwd = _build.register_op(
    "sra_attention_fwd(Tensor q, Tensor k, Tensor v, float scale) -> Tensor",
    cuda=_fwd_op, cpu=sra_attention_plain, fake=lambda q, k, v, scale: torch.empty_like(q))


class _SraAttention(torch.autograd.Function):
    """K1f with the row log-sum-exps saved, K1b as the backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        b, n, h, _ = q.shape
        lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
        out = _forward(q, k, v, scale, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = sra_attention_bwd(q, k, v, out, lse, g.contiguous(), ctx.scale)
        return dq, dk, dv, None


def sra_attention(q, k, v, scale: float):
    """Multi-head SRA attention, q (B, N, H, D), k and v (B, M, H, D),
    output (B, N, H, D) in q's dtype. CUDA tensors go through the kernels
    (float32 or bfloat16, D in ``HEAD_DIMS``), with K1b as the backward when
    a gradient is needed; CPU tensors through the plain version. Without a
    gradient, through ``sft::sra_attention_fwd`` on either device."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if q.device.type == "cpu":
            return sra_attention_plain(q, k, v, scale)
        _check(q, k, v)
        return _SraAttention.apply(q, k, v, scale)
    _build.check_device(q, "q")
    return sra_attention_fwd(q, k, v, scale)


sra_attention.launches = 0
sra_attention_bwd.launches = 0
sra_attention_bwd_core.launches = 0
