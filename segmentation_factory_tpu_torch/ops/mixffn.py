"""K2: Mix-FFN, fc1 -> 3x3 depthwise (zero SAME padding) -> exact-erf GELU -> fc2.

Port of ``segmentation_factory_tpu/ops/pallas_ffn.py``: the entry
``mixffn_apply`` (:418-458), its TPU kernels ``_forward`` (:304, body
``_fwd_kernel`` :85) and ``_bwd_rule`` (:351, body ``_bwd_kernel`` :119), and
the ``custom_vjp`` ``_ffn_fused`` (:329-406). K2f is three phases composed
by ``ffn_fwd``: fc1 and fc2 on the GEMM of ``csrc/sm90.cuh`` in its NN form
(``ffn_fc``) around the depthwise taps and GELU (``ffn_stencil``,
``csrc/mixffn.cu``). K2b is the phases composed by ``ffn_bwd``
(``csrc/mixffn_bwd.cu``, each product a GEMM on wgmma). Each phase has its
plain version beside it. ``mixffn_plain`` is the plain version of the whole
(``_xla_composition``, :338-348) and its autograd is the plain backward.
The JAX package's exit to an XLA recompute-VJP for C = 512-like shapes
(:355-360) has no counterpart: K2b takes every MiT stage. A forward that
needs no gradient is the registered op ``sft::mixffn_fwd``
(``mixffn_fwd``): K2f's three phases on the card, the plain version on
the CPU, an empty output of y's shape under fake tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from segmentation_factory_tpu_torch.ops import _build

V, I = _build.VOIDP, _build.INT
_GEMM_ARGTYPES = [V] * 5 + [I] * 6 + [V]
_STENCIL_ARGTYPES = [V] * 4 + [I] * 5 + [V]
_PREP_ARGTYPES = [V] * 9 + [I] * 5 + [V]
_TILE_ARGTYPES = [V] * 9 + [I] * 5 + [V]
_LN_ARGTYPES = [V] * 8 + [I] * 3 + [V]
_NT, _TN, _NN = 0, 1, 2  # the GEMM's forms (csrc/sm90.cuh)
LN_EPS = 1e-6  # LN2's epsilon (models/layers ln_apply)
# K4f's float32 kernel (csrc/mixffn.cu ffn_block_f32_kernel): 256 threads,
# each owning one 4-channel group of C for up to 16 pixels of a (rows x 8)
# tile, so P * C <= 16384
_THREADS = 256
_PIXELS_PER_THREAD = 16
_TILE_W = 8
MAX_CHANNELS = 4 * _THREADS
MAX_CHANNELS_BWD = 512


def mixffn_plain(y, w1, b1, dw, db, w2, b2):
    """The FFN in y's dtype; y (B, H, W, C), w1 (C, HC), dw (3, 3, 1, HC),
    w2 (HC, C) — the JAX argument layout."""
    dt = y.dtype
    hc = w1.shape[-1]
    hid = y @ w1.to(dt) + b1.to(dt)
    hid = F.conv2d(hid.permute(0, 3, 1, 2), dw.to(dt).permute(3, 2, 0, 1),
                   db.to(dt), padding=1, groups=hc).permute(0, 2, 3, 1)
    hid = F.gelu(hid)  # exact erf
    return hid @ w2.to(dt) + b2.to(dt)


def tile_rows(c: int, h: int) -> int:
    """Rows of the (rows x 8)-pixel output tile of a block of K4f's float32
    kernel: as many as the threads' accumulators cover, at most 16, and no
    more than ``h`` rounded up to even."""
    pixel_groups = _THREADS // (c // 4)
    return min(16, pixel_groups * _PIXELS_PER_THREAD // _TILE_W, h + h % 2)


def _check(y, w1, b1, dw, db, w2, b2=None) -> None:
    c, hc = y.shape[-1], w1.shape[-1]
    _build.check_cuda(y, "y")
    dt = y.dtype
    _build.check_cuda(w1, "w1", (c, hc), dt)
    _build.check_cuda(b1, "b1", (hc,), dt)
    _build.check_cuda(dw, "dw", (3, 3, 1, hc), dt)
    _build.check_cuda(db, "db", (hc,), dt)
    _build.check_cuda(w2, "w2", (hc, c), dt)
    if b2 is not None:
        _build.check_cuda(b2, "b2", (c,), dt)
    if c % 16 or hc % 32 or not 16 <= c <= MAX_CHANNELS:
        raise ValueError(f"C={c} must be a multiple of 16 in [16, {MAX_CHANNELS}]; "
                         f"HC={hc} a multiple of 32")


# ---------------------------------------------------------------- the GEMM


def _gemm(a, b, out_f, out_t, bias, m, n, k, form, trans=0):
    """One launch of ``sft_gemm`` (csrc/mixffn_bwd.cu)."""
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _build.launch("mixffn_bwd", "sft_gemm", _GEMM_ARGTYPES, a.data_ptr(), b.data_ptr(),
                  ptr(out_f), ptr(out_t), ptr(bias), m, n, k, form, trans,
                  _build.DTYPE_CODE[a.dtype], _build.stream_ptr(a))


def _gemm_stored(a, b, bias, out_dtype, form):
    """The NT or NN form of the GEMM into a new (M, N) tensor."""
    m, k = a.shape
    n = b.shape[0] if form == _NT else b.shape[1]
    _build.check_cuda(a, "a")
    _build.check_cuda(b, "b", (n, k) if form == _NT else (k, n), a.dtype)
    if bias is not None:
        _build.check_cuda(bias, "bias", (n,), a.dtype)
    if out_dtype not in (torch.float32, a.dtype):
        raise TypeError(f"out_dtype {out_dtype} is neither float32 nor {a.dtype}")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    f32 = out_dtype == torch.float32
    _gemm(a, b, out if f32 else None, None if f32 else out, bias, m, n, k, form)
    return out


def gemm_nt_plain(a, b, bias=None, out_dtype=torch.float32):
    """a (M, K) . b (N, K)^T (+ bias (N,)), float32 sums, in ``out_dtype``."""
    out = a.float() @ b.float().t()
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


def gemm_nt(a, b, bias=None, out_dtype=torch.float32):
    """The NT form of the GEMM (``csrc/sm90.cuh``; products of K2b, K4b and
    K3b): a (M, K) . b (N, K)^T (+ bias (N,) in a's dtype) in float32 or a's
    dtype, sums in float32; wgmma for bfloat16, FMAs for float32. CPU
    tensors take ``gemm_nt_plain``."""
    if a.device.type == "cpu":
        return gemm_nt_plain(a, b, bias, out_dtype)
    out = _gemm_stored(a, b, bias, out_dtype, _NT)
    gemm_nt.launches += 1
    return out


def gemm_nn_plain(a, b, bias=None, out_dtype=torch.float32):
    """a (M, K) . b (K, N) (+ bias (N,)), float32 sums, in ``out_dtype``."""
    out = a.float() @ b.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


def gemm_nn(a, b, bias=None, out_dtype=torch.float32):
    """The NN form of the GEMM in the backwards (fc1 recomputed, K3b's doh
    and dln): ``gemm_nt``'s contract with b (K, N), a weight read in its own
    layout. CPU tensors take ``gemm_nn_plain``."""
    if a.device.type == "cpu":
        return gemm_nn_plain(a, b, bias, out_dtype)
    out = _gemm_stored(a, b, bias, out_dtype, _NN)
    gemm_nn.launches += 1
    return out


def gemm_tn_plain(a, b, out, transpose=False):
    """out (M, N) += a (K, M)^T . b (K, N) in float32, or out (N, M) += its
    transpose; returns out."""
    prod = a.float().t() @ b.float()
    return out.add_(prod.t() if transpose else prod)


def gemm_tn(a, b, out, transpose=False):
    """The TN form of the GEMM: ``gemm_tn_plain``'s contract, the
    contraction (the pixels) split over the grid and every split's partial
    added to the float32 ``out`` with atomics. CPU tensors take the plain
    version."""
    if a.device.type == "cpu":
        return gemm_tn_plain(a, b, out, transpose)
    k, m = a.shape
    n = b.shape[1]
    _build.check_cuda(a, "a")
    _build.check_cuda(b, "b", (k, n), a.dtype)
    _build.check_cuda(out, "out", (n, m) if transpose else (m, n), torch.float32)
    _gemm(a, b, out, None, None, m, n, k, _TN, int(transpose))
    gemm_tn.launches += 1
    return out


# ---------------------------------------------------------------- K2f's phases


def ffn_fc_plain(x, w, bias):
    """K2f's fc1 (or fc2): x (P, K) . w (K, N) + bias, the sum in float32,
    rounded once to x's dtype."""
    return gemm_nn_plain(x, w, bias, x.dtype)


def ffn_fc(x, w, bias):
    """``ffn_fc_plain`` through the GEMM's NN form (wgmma for bfloat16, FMAs
    for float32), counted apart from the backwards' ``gemm_nn``. CPU tensors
    take the plain version."""
    if x.device.type == "cpu":
        return ffn_fc_plain(x, w, bias)
    out = _gemm_stored(x, w, bias, x.dtype, _NN)
    ffn_fc.launches += 1
    return out


def ffn_stencil_plain(h, dw, db):
    """K2f's middle phase: g = GELU(dwconv3x3(h) + db) for h (B, H, W, HC),
    zero outside the image, in float32, rounded to h's dtype."""
    hc = h.shape[-1]
    hd = F.conv2d(h.float().permute(0, 3, 1, 2), dw.float().permute(3, 2, 0, 1), db.float(),
                  padding=1, groups=hc)
    return F.gelu(hd).permute(0, 2, 3, 1).to(h.dtype).contiguous()


def ffn_stencil(h, dw, db):
    """``ffn_stencil_plain`` through ``sft_ffn_stencil`` (CPU tensors: the
    plain version)."""
    if h.device.type == "cpu":
        return ffn_stencil_plain(h, dw, db)
    bsz, hh, w, hc = h.shape
    _build.check_cuda(h, "h")
    _build.check_cuda(dw, "dw", (3, 3, 1, hc), h.dtype)
    _build.check_cuda(db, "db", (hc,), h.dtype)
    g = torch.empty_like(h)
    _build.launch("mixffn", "sft_ffn_stencil", _STENCIL_ARGTYPES, h.data_ptr(), dw.data_ptr(),
                  db.data_ptr(), g.data_ptr(), bsz, hh, w, hc, _build.DTYPE_CODE[h.dtype],
                  _build.stream_ptr(h))
    ffn_stencil.launches += 1
    return g


def ffn_fwd(y, w1, b1, dw, db, w2, b2):
    """K2f's phases in turn, on the card through the kernels, on the CPU
    through their plain versions: h = fc1(y) and out = fc2(g) (``ffn_fc``)
    around g = ``ffn_stencil``(h); h, g and out rounded to y's dtype."""
    bsz, h, w, c = y.shape
    hc, p = w1.shape[-1], bsz * h * w
    hid = ffn_fc(y.reshape(p, c), w1, b1).view(bsz, h, w, hc)
    g = ffn_stencil(hid, dw, db)
    del hid
    return ffn_fc(g.view(p, hc), w2, b2).view(y.shape)


def _forward(y, w1, b1, dw, db, w2, b2):
    out = ffn_fwd(y, w1, b1, dw, db, w2, b2)
    mixffn_apply.launches += 1
    return out


# ---------------------------------------------------------------- K2b's phases


def ffn_bwd_prep_plain(x, g, lg=None, lb=None, fac=None):
    """Phase 1 of the backward: (yhat, gs, st, db2). With a half-block's LN
    lg, lb (K4b's LN2, K3b's LN1) and the drop-path factors fac: yhat =
    LN(x) and gs = g * fac rounded to x's dtype, st (P, 2) the float32
    (mean, 1/sigma) of every pixel; without (K2b): yhat = x, gs = g, st
    None. db2 = the column sums of gs."""
    if lg is None:
        return x, g, None, g.float().sum((0, 1, 2))
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    rs = torch.rsqrt(((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0) + LN_EPS)
    yhat = ((xf - mu) * rs * lg + lb).to(x.dtype)
    gs = (g.float() * fac.float().view(-1, 1, 1, 1)).to(x.dtype)
    return yhat, gs, torch.cat([mu, rs], -1).reshape(-1, 2), gs.float().sum((0, 1, 2))


def ffn_bwd_prep(x, g, lg=None, lb=None, fac=None):
    """Phase 1 through ``sft_ffn_bwd_prep`` (CPU tensors: the plain version)."""
    if x.device.type == "cpu":
        return ffn_bwd_prep_plain(x, g, lg, lb, fac)
    c = x.shape[-1]
    p = x.numel() // c
    db2 = torch.zeros((c,), dtype=torch.float32, device=x.device)
    block = lg is not None
    if block:
        yhat, gs = torch.empty_like(x), torch.empty_like(x)
        st = torch.empty((p, 2), dtype=torch.float32, device=x.device)
    else:
        yhat, gs, st = x, g, None
    ptr = lambda t: None if t is None or not block else t.data_ptr()
    _build.launch("mixffn_bwd", "sft_ffn_bwd_prep", _PREP_ARGTYPES, x.data_ptr(), g.data_ptr(),
                  ptr(lg), ptr(lb), ptr(fac), ptr(yhat), ptr(gs), ptr(st), db2.data_ptr(),
                  p, x.shape[1] * x.shape[2], c, int(block), _build.DTYPE_CODE[x.dtype],
                  _build.stream_ptr(x))
    ffn_bwd_prep.launches += 1
    return yhat, gs, st, db2


def ffn_bwd_tile_plain(h1, dhg, dw, db):
    """Phase 3: from h1 = fc1 + b1 and dhg = gs W2^T (B, H, W, HC) float32,
    (hg, dh1, ddw, ddb, db1): hg = GELU(dwconv(h1) + db) and dh1 = the
    depthwise conv's input gradient of dhd = dhg * GELU'(hd), both in dw's
    dtype; the float32 sums ddw (3, 3, 1, HC), ddb and db1 (HC,)."""
    hc = h1.shape[-1]
    k = dw.float().permute(3, 2, 0, 1)
    h1c = h1.float().permute(0, 3, 1, 2)
    hd = F.conv2d(h1c, k, db.float(), padding=1, groups=hc)
    cdf = 0.5 * (1.0 + torch.erf(hd * 0.7071067811865476))
    pdf = torch.exp(-0.5 * hd * hd) * 0.3989422804014327
    dhd = dhg.float().permute(0, 3, 1, 2) * (cdf + hd * pdf)
    dh1 = F.conv_transpose2d(dhd, k, padding=1, groups=hc)
    ddw = torch.nn.grad.conv2d_weight(h1c, k.shape, dhd, padding=1, groups=hc)
    nhwc = lambda t: t.permute(0, 2, 3, 1).to(dw.dtype).contiguous()
    return (nhwc(hd * cdf), nhwc(dh1), ddw.permute(2, 3, 1, 0).contiguous(),
            dhd.sum((0, 2, 3)), dh1.sum((0, 2, 3)))


def ffn_bwd_tile(h1, dhg, dw, db):
    """Phase 3 through ``sft_ffn_bwd_tile`` (CPU tensors: the plain version)."""
    if h1.device.type == "cpu":
        return ffn_bwd_tile_plain(h1, dhg, dw, db)
    bsz, h, w, hc = h1.shape
    _build.check_cuda(h1, "h1", dtype=torch.float32)
    _build.check_cuda(dhg, "dhg", h1.shape, torch.float32)
    hg = torch.empty(h1.shape, dtype=dw.dtype, device=h1.device)
    dh1 = torch.empty_like(hg)
    ddw, ddb, db1 = (torch.zeros(s, dtype=torch.float32, device=h1.device)
                     for s in [(3, 3, 1, hc), (hc,), (hc,)])
    _build.launch("mixffn_bwd", "sft_ffn_bwd_tile", _TILE_ARGTYPES, h1.data_ptr(),
                  dhg.data_ptr(), dw.data_ptr(), db.data_ptr(), hg.data_ptr(), dh1.data_ptr(),
                  ddw.data_ptr(), ddb.data_ptr(), db1.data_ptr(), bsz, h, w, hc,
                  _build.DTYPE_CODE[dw.dtype], _build.stream_ptr(h1))
    ffn_bwd_tile.launches += 1
    return hg, dh1, ddw, ddb, db1


def ln_bwd_plain(dln, x, g, st, lg):
    """Phase 6 (K4b; K3b's last phase): the LN backward from dln (P, C)
    float32 and phase 1's st, plus the residual's g: (dx like x, dlg, dlb
    float32)."""
    c = x.shape[-1]
    d = dln.float().reshape(-1, c)
    xh = (x.float().reshape(-1, c) - st[:, :1]) * st[:, 1:]
    gl = d * lg
    dx = g.float().reshape(-1, c) + st[:, 1:] * (
        gl - gl.mean(-1, keepdim=True) - xh * (gl * xh).mean(-1, keepdim=True))
    return dx.to(x.dtype).view(x.shape), (d * xh).sum(0), d.sum(0)


def ln_bwd(dln, x, g, st, lg):
    """Phase 6 through ``sft_ffn_bwd_ln`` (CPU tensors: the plain version)."""
    if x.device.type == "cpu":
        return ln_bwd_plain(dln, x, g, st, lg)
    c = x.shape[-1]
    dx = torch.empty_like(x)
    dlg, dlb = (torch.zeros((c,), dtype=torch.float32, device=x.device) for _ in range(2))
    _build.launch("mixffn_bwd", "sft_ffn_bwd_ln", _LN_ARGTYPES, dln.data_ptr(), x.data_ptr(),
                  g.data_ptr(), st.data_ptr(), lg.data_ptr(), dx.data_ptr(), dlg.data_ptr(),
                  dlb.data_ptr(), x.numel() // c, c, _build.DTYPE_CODE[x.dtype],
                  _build.stream_ptr(x))
    ln_bwd.launches += 1
    return dx, dlg, dlb


def ffn_bwd(y, w1, b1, dw, db, w2, g, lg=None, lb=None, fac=None):
    """The backward's phases in turn (see ``csrc/mixffn_bwd.cu``), on the
    card through the kernels, on the CPU through their plain versions.
    Without lg (K2b): (dy, dw1, db1, ddw, ddb, dw2, db2); with LN2's lg, lb
    and the drop-path factors fac (K4b), y the half-block input x: (dx, dlg,
    dlb, dw1, db1, ddw, ddb, dw2, db2). The gradients of the parameters are
    float32."""
    bsz, h, w, c = y.shape
    hc, p = w1.shape[-1], bsz * h * w
    yhat, gs, st, db2 = ffn_bwd_prep(y, g, lg, lb, fac)
    y2, g2 = yhat.reshape(p, c), gs.reshape(p, c)
    h1 = gemm_nn(y2, w1, b1).view(bsz, h, w, hc)
    dhg = gemm_nt(g2, w2).view(bsz, h, w, hc)
    hg, dh1, ddw, ddb, db1 = ffn_bwd_tile(h1, dhg, dw, db)
    del h1, dhg
    hg, dh1 = hg.view(p, hc), dh1.view(p, hc)
    f32 = dict(dtype=torch.float32, device=y.device)
    dw1 = gemm_tn(dh1, y2, torch.zeros((c, hc), **f32), transpose=True)
    dw2 = gemm_tn(hg, g2, torch.zeros((hc, c), **f32))
    if lg is None:
        dy = gemm_nt(dh1, w1, out_dtype=y.dtype).view(y.shape)
        return dy, dw1, db1, ddw, ddb, dw2, db2
    dx, dlg, dlb = ln_bwd(gemm_nt(dh1, w1), y, g, st, lg)
    return dx, dlg, dlb, dw1, db1, ddw, ddb, dw2, db2


def mixffn_bwd(y, w1, b1, dw, db, w2, g):
    """K2b: (dy, dw1, db1, ddw, ddb, dw2, db2) of ``mixffn_apply`` for the
    cotangent ``g`` of its output (b2 does not enter: its gradient is the
    column sum of g). C a multiple of 32 up to ``MAX_CHANNELS_BWD``; dy in
    y's dtype, the parameter gradients float32. CUDA tensors run the kernels
    of ``ffn_bwd``'s phases (``launches`` counts a call once all of them were
    launched), CPU tensors their plain versions."""
    c = y.shape[-1]
    if c % 32 or c > MAX_CHANNELS_BWD:
        raise ValueError(f"C={c} must be a multiple of 32 up to {MAX_CHANNELS_BWD}")
    if y.device.type == "cpu":
        return ffn_bwd(y, w1, b1, dw, db, w2, g)
    _check(y, w1, b1, dw, db, w2)
    _build.check_cuda(g, "g", y.shape, y.dtype)
    out = ffn_bwd(y, w1, b1, dw, db, w2, g)
    mixffn_bwd.launches += 1
    return out


def _fwd_op(y, w1, b1, dw, db, w2, b2):
    """K2f on the card as ``sft::mixffn_fwd`` runs it: the checks, then its
    three phases (``launches`` counts the call, each phase its own
    launches)."""
    _check(y, w1, b1, dw, db, w2, b2)
    return _forward(y, w1, b1, dw, db, w2, b2)


mixffn_fwd = _build.register_op(
    "mixffn_fwd(Tensor y, Tensor w1, Tensor b1, Tensor dw, Tensor db, Tensor w2, "
    "Tensor b2) -> Tensor",
    cuda=_fwd_op, cpu=mixffn_plain, fake=lambda y, *weights: torch.empty_like(y))


class _MixFFN(torch.autograd.Function):
    """K2f forward, K2b backward; the parameter gradients come back in the
    parameters' dtypes."""

    @staticmethod
    def forward(ctx, y, w1, b1, dw, db, w2, b2):
        ctx.save_for_backward(y, w1, b1, dw, db, w2)
        ctx.b2_dtype = b2.dtype
        return _forward(y, w1, b1, dw, db, w2, b2)

    @staticmethod
    def backward(ctx, g):
        y, w1, b1, dw, db, w2 = ctx.saved_tensors
        dy, *grads = mixffn_bwd(y, w1, b1, dw, db, w2, g.contiguous())
        dts = [w1.dtype, b1.dtype, dw.dtype, db.dtype, w2.dtype, ctx.b2_dtype]
        return (dy, *[t.to(d) for t, d in zip(grads, dts)])


def mixffn_apply(y, w1, b1, dw, db, w2, b2):
    """Mix-FFN of the LayerNorm output y (B, H, W, C) with the JAX layout
    w1 (C, HC), b1 (HC,), dw (3, 3, 1, HC), db (HC,), w2 (HC, C), b2 (C,).
    CUDA tensors go through K2f's phases (all in y's dtype, float32 or
    bfloat16, C a multiple of 16, HC of 32; ``launches`` counts a call once
    all of them were launched), with K2b as the backward when a gradient is
    needed; CPU tensors through the plain version. Without a gradient,
    through ``sft::mixffn_fwd`` on either device."""
    args = (y, w1, b1, dw, db, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        if y.device.type == "cpu":
            return mixffn_plain(*args)
        _check(*args)
        return _MixFFN.apply(*args)
    _build.check_device(y, "y")
    return mixffn_fwd(*args)


mixffn_apply.launches = 0
mixffn_bwd.launches = 0
ffn_fc.launches = 0
ffn_stencil.launches = 0
gemm_nt.launches = 0
gemm_nn.launches = 0
gemm_tn.launches = 0
ffn_bwd_prep.launches = 0
ffn_bwd_tile.launches = 0
ln_bwd.launches = 0
