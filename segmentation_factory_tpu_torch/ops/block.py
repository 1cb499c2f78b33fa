"""K3 and K4: the fused MiT half-blocks.

Port of ``segmentation_factory_tpu/ops/pallas_block.py``:

- the attention half ``x + fac * proj(attn(LN1(x) Wq + bq, K, V))``: entry
  ``attn_block_apply`` (:388-423), TPU kernels ``_attn_forward`` (:268) and
  ``_attn_bwd_rule`` (:303), CUDA kernels ``csrc/attn_block.cu`` (K3f) and
  K3b: phases composed by ``attn_bwd`` around K1b's attention-backward core
  (``sra_attention.sra_attention_bwd_core``), with the GEMM, prep and LN
  backward kernels of the Mix-FFN backward (``csrc/mixffn_bwd.cu``);
- the FFN half ``x + fac * fc2(GELU(dw3x3(fc1(LN2(x)))))``: entry
  ``ffn_block_apply`` (:749-780), TPU kernels ``_ffn_forward`` (:641) and
  ``_ffn_bwd_rule`` (:691), CUDA kernels K4f and K4b: the Mix-FFN kernels of
  ``csrc/mixffn.cu`` with their LN prologue and residual epilogue on, and
  the phases of ``csrc/mixffn_bwd.cu`` with LN2 recomputed and the LN
  backward at the end.

``fac`` is the per-image drop-path factor (B,) float32 (mask / keep
probability, or 1 in eval); its cotangent is zero (it is data, :349-351,
:742). ``attn_block_plain`` and ``ffn_block_plain`` are the plain versions
(the XLA twins ``attn_block_xla`` :358-385 and ``ffn_block_xla`` :674-688,
rounded where the kernels round: q, the softmax weights and each head's
output to the compute type, the out projection summed over heads and the
residual added in float32, cast once); autograd through them is the plain
backward. On a CUDA tensor that needs a gradient the forward runs as an
autograd Function whose backward is K3b / K4b; without one, K3f / K4f alone.
A forward that needs no gradient is a registered op,
``sft::attn_block_fwd`` / ``sft::ffn_block_fwd`` (``attn_block_fwd``,
``ffn_block_fwd``): K3f / K4f on the card (their checks, ``ffn_geometry``'s
tile and the launch all inside the op), the plain version on the CPU, an
empty output like x under fake tensors, so that ``torch.export`` traces
it into the graph.
The JAX package's shape gates (:406, :764-771) and its XLA exit in
``_ffn_bwd_rule`` (:696-703) have no counterpart: the kernels take every
MiT stage 1-3 shape (C a multiple of 32 up to 320, head dim 32 or 64).
"""

from __future__ import annotations

import torch

from segmentation_factory_tpu_torch.models.layers.common import ln_apply
from segmentation_factory_tpu_torch.ops import _build
from segmentation_factory_tpu_torch.ops.mixffn import (
    MAX_CHANNELS_BWD, _TILE_W, ffn_bwd, ffn_bwd_prep, gemm_nn, gemm_nt, gemm_tn, ln_bwd,
    mixffn_plain, tile_rows)
from segmentation_factory_tpu_torch.ops.mixffn import _check as _check_ffn_weights
from segmentation_factory_tpu_torch.ops.sra_attention import sra_attention_bwd_core

V, I = _build.VOIDP, _build.INT
_ATTN_ARGTYPES = [V] * 13 + [I] * 5 + [_build.FLOAT, I, V]
_FFN_ARGTYPES = [V] * 11 + [I] * 7 + [I, V]
HEAD_DIMS = (32, 64)
MAX_CHANNELS = 320  # MiT stages 1-3; stage 4 (C = 512) stays per-op
SMS = 132  # the H100's SMs


# K4f (csrc/mixffn.cu namespace k4): 64 output pixels a block, whose halo
# fills at most two m64 tiles (128 rows); two blocks an SM up to C = 128
# (its __launch_bounds__), one past it
_K4_TILES = ((8, 8), (4, 16), (16, 4))


def ffn_geometry(c: int, h: int, w: int, b: int) -> tuple[int, int]:
    """K4f's tile (th, tw) for a (b, h, w, c) map: the 64-pixel tile with
    the fewest waves of blocks on the card, then the fewest blocks."""
    per_wave = SMS * (2 if c <= 128 else 1)

    def cost(tile):
        blocks = b * -(-h // tile[0]) * -(-w // tile[1])
        return -(-blocks // per_wave), blocks

    return min(_K4_TILES, key=cost)


def attn_block_plain(x, k, v, lg, lb, wq, bq, wo, bo, fac, num_heads: int, scale: float):
    """The attention half-block: x (B, H, W, C) the block input, k and v
    (B, M, C) the kv Linear's halves (head h at columns h*D ..), lg, lb
    (C,) float32, wq and wo (C, C) in nn.Linear's (out, in) layout, bq and
    bo (C,), fac (B,) float32. Output like x."""
    b, hh, w, c = x.shape
    m, d, dt = k.shape[1], c // num_heads, x.dtype
    xf = x.reshape(b, hh * w, c).float()
    ln = ln_apply(xf, lg, lb).to(dt).float()  # the TPU kernels' _ln_f32 (:83-89)
    q = (ln @ wq.float().t() + bq.float()).to(dt).float().view(b, -1, num_heads, d)
    s = torch.einsum("bnhd,bmhd->bhnm", q, k.float().view(b, m, num_heads, d)) * scale
    p = torch.softmax(s, dim=-1).to(dt).float()
    oh = torch.einsum("bhnm,bmhd->bnhd", p, v.float().view(b, m, num_heads, d)).to(dt)
    z = oh.reshape(b, -1, c).float() @ wo.float().t() + bo.float()
    return (xf + fac.float().view(b, 1, 1) * z).to(dt).view(x.shape)


def ffn_block_plain(x, lg, lb, w1, b1, dw, db, w2, b2, fac):
    """The FFN half-block: x (B, H, W, C) the half-block input, lg, lb (C,)
    float32, the Mix-FFN weights in ``mixffn_apply``'s layout, fac (B,)
    float32. Output like x: x + fac * ffn(LN2(x)), the residual in float32."""
    z = mixffn_plain(ln_apply(x, lg, lb).to(x.dtype), w1, b1, dw, db, w2, b2)
    return (x.float() + fac.float().view(-1, 1, 1, 1) * z.float()).to(x.dtype)


def _check_common(x, lg, lb, fac, max_c: int = MAX_CHANNELS) -> None:
    b, c = x.shape[0], x.shape[-1]
    _build.check_cuda(x, "x")
    _build.check_cuda(lg, "lg", (c,), torch.float32)
    _build.check_cuda(lb, "lb", (c,), torch.float32)
    # fac may be a row of the (blocks, 2, B) factors: 4-byte aligned is enough
    if (fac.device != x.device or fac.dtype != torch.float32 or tuple(fac.shape) != (b,)
            or not fac.is_contiguous()):
        raise ValueError("fac: expected a contiguous (B,) float32 tensor on x's device")
    if c % 32 or c > max_c:
        raise ValueError(f"C={c} must be a multiple of 32 up to {max_c}")


def _check_attn(x, k, v, lg, lb, wq, bq, wo, bo, fac, num_heads: int) -> None:
    """bo may be None (the backward does not take it)."""
    b, hh, w, c = x.shape
    _check_common(x, lg, lb, fac)
    dt = x.dtype
    m = k.shape[1]
    _build.check_cuda(k, "k", (b, m, c), dt)
    _build.check_cuda(v, "v", (b, m, c), dt)
    for name, t, shape in (("wq", wq, (c, c)), ("bq", bq, (c,)), ("wo", wo, (c, c)),
                           ("bo", bo, (c,))):
        if t is not None:
            _build.check_cuda(t, name, shape, dt)
    if c % num_heads or c // num_heads not in HEAD_DIMS:
        raise ValueError(f"head dim {c}/{num_heads} not in {HEAD_DIMS}")
    if m < 1:
        raise ValueError("empty K/V")


def _attn_forward(x, k, v, lg, lb, wq, bq, wo, bo, fac, num_heads, scale, o=None, lse=None):
    """K3f; with ``o`` and ``lse`` also the attention output (like x) and
    the (B, heads, N) log2-domain row log-sum-exps, for K3b."""
    b, hh, w, c = x.shape
    out = torch.empty_like(x)
    _build.launch(
        "attn_block", "sft_attn_block", _ATTN_ARGTYPES,
        x.data_ptr(), k.data_ptr(), v.data_ptr(), lg.data_ptr(), lb.data_ptr(),
        wq.data_ptr(), bq.data_ptr(), wo.data_ptr(), bo.data_ptr(), fac.data_ptr(),
        out.data_ptr(), None if o is None else o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        b, hh * w, k.shape[1], c, c // num_heads, float(scale), _build.DTYPE_CODE[x.dtype],
        _build.stream_ptr(x),
    )
    attn_block_apply.launches += 1
    return out


def attn_bwd(x, k, v, lg, lb, wq, bq, wo, fac, g, o, lse, num_heads: int, scale: float):
    """K3b's phases in turn, on the card through the kernels, on the CPU
    through their plain versions (each wrapper picks by device):
    1. ``ffn_bwd_prep``: ln = LN1(x) and dz = g * fac in x's dtype, the row
       statistics st and dbo = the column sums of dz;
    2. q = ln Wqᵀ + bq (``gemm_nt``) and doh = dz Wo (``gemm_nn``), in x's
       dtype;
    3. K1b's core on (q, k, v, o, doh, lse): dq in x's dtype, dk, dv and
       dbq (its epilogue's column sums of dq) in float32;
    4. dWq = dqᵀ ln and dWo = dzᵀ o (``gemm_tn``), dln = dq Wq (``gemm_nn``,
       float32);
    5. ``ln_bwd``: dx = g + LN1'(x)ᵀ dln, dlg and dlb.
    ln, q, dz, doh and dq are rounded to x's dtype; dln, delta and every sum
    stay float32. Returns ``attn_block_bwd``'s tuple."""
    b, hh, w, c = x.shape
    n, m, d = hh * w, k.shape[1], c // num_heads
    ln, dz, st, dbo = ffn_bwd_prep(x, g, lg, lb, fac)
    ln, dz = ln.view(b * n, c), dz.view(b * n, c)
    q = gemm_nt(ln, wq, bq, out_dtype=x.dtype)
    doh = gemm_nn(dz, wo, out_dtype=x.dtype)
    heads = lambda t, rows: t.view(b, rows, num_heads, d)  # noqa: E731
    dq, dk, dv, _, dbq = sra_attention_bwd_core(
        heads(q, n), heads(k, m), heads(v, m), heads(o, n), heads(doh, n), lse, scale, dbq=True)
    del q, doh
    dq = dq.view(b * n, c)
    f32 = dict(dtype=torch.float32, device=x.device)
    dwq = gemm_tn(dq, ln, torch.zeros((c, c), **f32))
    dwo = gemm_tn(dz, o.view(b * n, c), torch.zeros((c, c), **f32))
    dx, dlg, dlb = ln_bwd(gemm_nn(dq, wq), x, g, st, lg)
    return dx, dk.view(b, m, c), dv.view(b, m, c), dlg, dlb, dwq, dbq, dwo, dbo


def attn_block_bwd(x, k, v, lg, lb, wq, bq, wo, fac, g, o, lse, num_heads: int, scale: float):
    """K3b: (dx, dk, dv, dlg, dlb, dwq, dbq, dwo, dbo) of ``attn_block_apply``
    for the cotangent ``g`` of its output, from K3f's saved attention
    output ``o`` and (B, heads, N) log2-domain ``lse``: ``attn_bwd``'s
    phases. dx in x's dtype, the rest float32, dwq and dwo as (out, in) like
    wq and wo. CUDA tensors run the kernels (``launches`` counts a call once
    all of them were launched), CPU tensors the phases' plain versions."""
    if x.device.type == "cpu":
        return attn_bwd(x, k, v, lg, lb, wq, bq, wo, fac, g, o, lse, num_heads, scale)
    _check_attn(x, k, v, lg, lb, wq, bq, wo, None, fac, num_heads)
    b, hh, w, _ = x.shape
    _build.check_cuda(g, "g", x.shape, x.dtype)
    _build.check_cuda(o, "o", x.shape, x.dtype)
    _build.check_cuda(lse, "lse", (b, num_heads, hh * w), torch.float32)
    out = attn_bwd(x, k, v, lg, lb, wq, bq, wo, fac, g, o, lse, num_heads, scale)
    attn_block_bwd.launches += 1
    return out


def _attn_op(x, k, v, lg, lb, wq, bq, wo, bo, fac, num_heads, scale):
    """K3f on the card as ``sft::attn_block_fwd`` runs it: the checks, then
    the kernel (``launches`` counts it)."""
    _check_attn(x, k, v, lg, lb, wq, bq, wo, bo, fac, num_heads)
    return _attn_forward(x, k, v, lg, lb, wq, bq, wo, bo, fac, num_heads, scale)


attn_block_fwd = _build.register_op(
    "attn_block_fwd(Tensor x, Tensor k, Tensor v, Tensor lg, Tensor lb, Tensor wq, Tensor bq, "
    "Tensor wo, Tensor bo, Tensor fac, int num_heads, float scale) -> Tensor",
    cuda=_attn_op, cpu=attn_block_plain, fake=lambda x, *rest: torch.empty_like(x))


class _AttnBlock(torch.autograd.Function):
    """K3f saving the attention output and log-sum-exps, K3b as the backward."""

    @staticmethod
    def forward(ctx, x, k, v, lg, lb, wq, bq, wo, bo, fac, num_heads, scale):
        b, hh, w, _ = x.shape
        o = torch.empty_like(x)
        lse = torch.empty((b, num_heads, hh * w), dtype=torch.float32, device=x.device)
        out = _attn_forward(x, k, v, lg, lb, wq, bq, wo, bo, fac, num_heads, scale, o, lse)
        ctx.save_for_backward(x, k, v, lg, lb, wq, bq, wo, fac, o, lse)
        ctx.meta = (num_heads, scale, bo.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        x, k, v, lg, lb, wq, bq, wo, fac, o, lse = ctx.saved_tensors
        num_heads, scale, bo_dtype = ctx.meta
        grads = attn_block_bwd(x, k, v, lg, lb, wq, bq, wo, fac, g.contiguous(), o, lse,
                               num_heads, scale)
        dts = [x.dtype, k.dtype, v.dtype, lg.dtype, lb.dtype, wq.dtype, bq.dtype, wo.dtype,
               bo_dtype]
        # the drop-path factor is data: no gradient (a zero cotangent)
        return (*[t.to(d) for t, d in zip(grads, dts)], None, None, None)


def attn_block_apply(x, k, v, lg, lb, wq, bq, wo, bo, fac, num_heads: int, scale: float):
    """LN1 -> q -> SRA attention -> out projection -> drop-path residual, in
    ``attn_block_plain``'s layouts (all but lg, lb, fac in x's dtype). CUDA
    tensors go through K3f (float32 or bfloat16), with K3b as the backward
    when a gradient is needed; CPU tensors through the plain version.
    Without a gradient, through ``sft::attn_block_fwd`` on either device."""
    args = (x, k, v, lg, lb, wq, bq, wo, bo, fac)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        if x.device.type == "cpu":
            return attn_block_plain(*args, num_heads, scale)
        _check_attn(*args, num_heads)
        return _AttnBlock.apply(*args, num_heads, scale)
    _build.check_device(x, "x")
    return attn_block_fwd(*args, num_heads, scale)


def _check_ffn(x, lg, lb, w1, b1, dw, db, w2, b2, fac, max_c: int = MAX_CHANNELS) -> None:
    _check_common(x, lg, lb, fac, max_c)
    _check_ffn_weights(x, w1, b1, dw, db, w2, b2)


def _ffn_forward(x, lg, lb, w1, b1, dw, db, w2, b2, fac):
    """K4f: bfloat16 on ``ffn_geometry``'s tile; float32 on K2f's tile."""
    bsz, h, w, c = x.shape
    if x.dtype == torch.bfloat16:
        th, tw = ffn_geometry(c, h, w, bsz)
    else:
        th, tw = tile_rows(c, h), _TILE_W
    out = torch.empty_like(x)
    _build.launch(
        "mixffn", "sft_ffn_block", _FFN_ARGTYPES,
        x.data_ptr(), lg.data_ptr(), lb.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        dw.data_ptr(), db.data_ptr(), w2.data_ptr(), b2.data_ptr(), fac.data_ptr(),
        out.data_ptr(), bsz, h, w, c, w1.shape[-1], th, tw,
        _build.DTYPE_CODE[x.dtype], _build.stream_ptr(x),
    )
    ffn_block_apply.launches += 1
    return out


def ffn_block_bwd(x, lg, lb, w1, b1, dw, db, w2, fac, g):
    """K4b: (dx, dlg, dlb, dw1, db1, ddw, ddb, dw2, db2) of
    ``ffn_block_apply`` for the cotangent ``g`` of its output (b2 does not
    enter): ``mixffn.ffn_bwd``'s phases with LN2 and the drop-path factor,
    C a multiple of 32 up to ``MAX_CHANNELS_BWD`` (K4f's 320 bounds the
    path). dx in x's dtype, the rest float32. CUDA tensors run the kernels
    (``launches`` counts a call once all of them were launched), CPU tensors
    the phases' plain versions."""
    if x.device.type == "cpu":
        return ffn_bwd(x, w1, b1, dw, db, w2, g, lg, lb, fac)
    _check_ffn(x, lg, lb, w1, b1, dw, db, w2, None, fac, MAX_CHANNELS_BWD)
    _build.check_cuda(g, "g", x.shape, x.dtype)
    out = ffn_bwd(x, w1, b1, dw, db, w2, g, lg, lb, fac)
    ffn_block_bwd.launches += 1
    return out


def _ffn_op(x, lg, lb, w1, b1, dw, db, w2, b2, fac):
    """K4f on the card as ``sft::ffn_block_fwd`` runs it: the checks, then
    the kernel on ``ffn_geometry``'s tile (``launches`` counts it)."""
    _check_ffn(x, lg, lb, w1, b1, dw, db, w2, b2, fac)
    return _ffn_forward(x, lg, lb, w1, b1, dw, db, w2, b2, fac)


ffn_block_fwd = _build.register_op(
    "ffn_block_fwd(Tensor x, Tensor lg, Tensor lb, Tensor w1, Tensor b1, Tensor dw, Tensor db, "
    "Tensor w2, Tensor b2, Tensor fac) -> Tensor",
    cuda=_ffn_op, cpu=ffn_block_plain, fake=lambda x, *rest: torch.empty_like(x))


class _FfnBlock(torch.autograd.Function):
    """K4f forward, K4b backward."""

    @staticmethod
    def forward(ctx, x, lg, lb, w1, b1, dw, db, w2, b2, fac):
        ctx.save_for_backward(x, lg, lb, w1, b1, dw, db, w2, fac)
        ctx.b2_dtype = b2.dtype
        return _ffn_forward(x, lg, lb, w1, b1, dw, db, w2, b2, fac)

    @staticmethod
    def backward(ctx, g):
        x, lg, lb, w1, b1, dw, db, w2, fac = ctx.saved_tensors
        grads = ffn_block_bwd(x, lg, lb, w1, b1, dw, db, w2, fac, g.contiguous())
        dts = [x.dtype, lg.dtype, lb.dtype, w1.dtype, b1.dtype, dw.dtype, db.dtype, w2.dtype,
               ctx.b2_dtype]
        return (*[t.to(d) for t, d in zip(grads, dts)], None)  # fac: data, no gradient


def ffn_block_apply(x, lg, lb, w1, b1, dw, db, w2, b2, fac):
    """LN2 -> Mix-FFN -> drop-path residual, in ``ffn_block_plain``'s
    layouts. CUDA tensors go through K4f (float32 or bfloat16; C a multiple
    of 32 up to 320), with K4b as the backward when a gradient is needed;
    CPU tensors through the plain version. Without a gradient, through
    ``sft::ffn_block_fwd`` on either device."""
    args = (x, lg, lb, w1, b1, dw, db, w2, b2, fac)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        if x.device.type == "cpu":
            return ffn_block_plain(*args)
        _check_ffn(*args)
        return _FfnBlock.apply(*args)
    _build.check_device(x, "x")
    return ffn_block_fwd(*args)


attn_block_apply.launches = 0
attn_block_bwd.launches = 0
ffn_block_apply.launches = 0
ffn_block_bwd.launches = 0
