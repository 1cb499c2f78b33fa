"""K9: multi-scale deformable attention (MSDeformAttn's core), forward and backward.

Port of ``segmentation_factory_tpu/ops/msdeform.py``: the entry
``ms_deform_attn_fast`` (:181) and its custom VJP ``_msda_sf`` (:205-338).
That function reaches no ``pallas_call`` (Pallas could not gather on the
TPU, :20-26); it stands in for the reference's own CUDA extension
(``ms_deform_im2col_cuda.cuh``). The CUDA kernels are
``csrc/ms_deform_attn.cu``: K9f sums each (batch, query, head)'s L x P
bilinear samples times their weights, K9b writes d(value) as an atomic
col2im into a float32 buffer (cast to value's dtype at the end, as the
reference's CUDA does) and d(loc), d(attn) from a reduction over D. Both
are bound by bytes: the corner rows they gather (4 L P rows of D values an
item, 48 times value's size at the Mask2Former slice's shapes) come from
L2, and K9b's d(value) rows are added there by atomics. ``LANES`` is the
kernels' lane map: ``LANES[D] = (LP, CPL)`` lanes an item and channels a
lane, LP * CPL = D, so every lane is busy and every value load is 16
bytes. K9b sums each block's d(value) rows per pixel of a window of each
level before adding them into d(value), one 16-byte vector reduction a
pixel and 4 channels (``bwd_plan`` is its plain mirror,
``ms_deform_attn_bwd_planned`` d(value) summed its way). A head dim not in
``LANES`` is not ported.

Contract (the JAX function's, :28-38): ``value`` (B, S, M, D) with S the
sum of H_l * W_l, static ``spatial_shapes`` ((H_0, W_0), ...),
``sampling_locations`` (B, Q, M, L, P, 2) in x, y order, normalised to
[0, 1], ``attention_weights`` (B, Q, M, L, P); output (B, Q, M * D),
float32 for a bfloat16 ``value`` (``_result_dtype`` :361-362). Sampling is
align_corners=False (the sample at loc * size - 0.5) with zero padding: a
corner outside the map contributes nothing, so a point whose four corners
are all outside is wholly outside (the fast path's validity mask,
:144-146, is the same rule).

``ms_deform_attn_plain`` is the plain version, the corner-gather oracle
(``ms_deform_attn`` :341-358, ``_sample_level`` :58-101) with the blend in
value's dtype; autograd through it gives the custom VJP's gradients.
``ms_deform_attn_bwd_plain`` writes those gradients out as the VJP does
(:267-338): d(value) the transposed gather (``index_add_``), d(loc)
(dtx * W, dty * H) from the in-bounds corner differences, d(attn) the
blend dotted with g. The TPU's sort / prefix-sum / searchsorted d(value)
(:232-264), which exists because the TPU has no scatter, is not ported.

A call that needs a gradient runs as ``_MSDeformAttn`` on CUDA tensors
(K9f, then K9b as its backward) and as the plain version with autograd on
CPU ones. Without one it is the registered op ``sft::ms_deform_attn``: K9f
on the card, the plain version on the CPU, an empty float32 output under
fake tensors, so ``torch.export`` keeps the kernel in the graph.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from segmentation_factory_tpu_torch.ops import _build

_INTS = ctypes.POINTER(ctypes.c_int)
_FWD_ARGTYPES = [_build.VOIDP] * 4 + [_INTS] + [_build.INT] * 10 + [_build.VOIDP]
_BWD_ARGTYPES = [_build.VOIDP] * 7 + [_INTS] + [_build.INT] * 10 + [_build.VOIDP]
MAX_LEVELS = 8  # csrc/ms_deform_attn.cu MAX_LEVELS
THREADS = 256  # csrc/ms_deform_attn.cu THREADS (K9f)
BWD_THREADS = 512  # csrc/ms_deform_attn.cu BWD_THREADS (K9b)
WINDOW_PIXELS = 2048  # csrc/ms_deform_attn.cu WINDOW_PIXELS
GROUP = 4  # csrc/ms_deform_attn.cu GROUP: points unrolled together
# head dim D -> (lanes an item, channels a lane): the instantiations of
# csrc/ms_deform_attn.cu ``dispatch``, each lane's channels whole 16-byte
# words of bf16 (8) and of float32 (4)
LANES = {8: (1, 8), 16: (2, 8), 32: (4, 8), 64: (4, 16), 96: (4, 24), 128: (4, 32),
         192: (8, 24), 256: (8, 32)}

Shapes = Tuple[Tuple[int, int], ...]


def _shapes(spatial_shapes: Sequence[Sequence[int]]) -> Shapes:
    return tuple((int(h), int(w)) for h, w in spatial_shapes)


def _level_offsets(shapes: Shapes):
    offs, acc = [], 0
    for h, w in shapes:
        offs.append(acc)
        acc += h * w
    return offs, acc


def _result_dtype(value: torch.Tensor) -> torch.dtype:
    return value.dtype if value.dtype in (torch.float32, torch.float64) else torch.float32


def _corners(loc_l: torch.Tensor, h: int, w: int):
    """Integer top-left corner (x0, y0) and fractions (tx, ty) of the
    (B, Q, M, P, 2) float32 locations of one level, align_corners=False."""
    x = loc_l[..., 0] * w - 0.5
    y = loc_l[..., 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    return x0.long(), y0.long(), x - x0, y - y0


def _gather(value_l: torch.Tensor, h: int, w: int, yi: torch.Tensor, xi: torch.Tensor):
    """The corner values (B, Q, M, P, D) at integer (yi, xi), zero outside
    the map, their flat in-level index and the in-bounds mask."""
    b, _, m, d = value_l.shape
    q, p = yi.shape[1], yi.shape[3]
    inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)  # (B, Q, M, P)
    flat = idx.permute(0, 2, 1, 3).reshape(b, m, q * p)
    bi = torch.arange(b, device=idx.device).view(b, 1, 1)
    mi = torch.arange(m, device=idx.device).view(1, m, 1)
    v = value_l.permute(0, 2, 1, 3)[bi, mi, flat]  # (B, M, QP, D)
    v = v.reshape(b, m, q, p, d).permute(0, 2, 1, 3, 4)
    return v * inb[..., None].to(v.dtype), idx, inb


def ms_deform_attn_plain(value, spatial_shapes, sampling_locations, attention_weights):
    """The corner-gather oracle: per level, four masked corner gathers
    blended in value's dtype, weighted and summed over the points, added
    into a float32 (or float64) output (B, Q, M * D)."""
    shapes = _shapes(spatial_shapes)
    b, s, m, d = value.shape
    q = sampling_locations.shape[1]
    offs, total = _level_offsets(shapes)
    if total != s:
        raise ValueError(f"spatial shapes sum {total} != S {s}")
    out = torch.zeros((b, q, m, d), dtype=_result_dtype(value), device=value.device)
    dt = value.dtype
    for l, (h, w) in enumerate(shapes):
        value_l = value[:, offs[l]:offs[l] + h * w]
        x0, y0, tx, ty = _corners(sampling_locations[:, :, :, l], h, w)
        v00 = _gather(value_l, h, w, y0, x0)[0]
        v01 = _gather(value_l, h, w, y0, x0 + 1)[0]
        v10 = _gather(value_l, h, w, y0 + 1, x0)[0]
        v11 = _gather(value_l, h, w, y0 + 1, x0 + 1)[0]
        tx, ty = tx[..., None].to(dt), ty[..., None].to(dt)
        sampled = (v00 * (1 - ty) * (1 - tx) + v01 * (1 - ty) * tx
                   + v10 * ty * (1 - tx) + v11 * ty * tx)
        wgt = attention_weights[:, :, :, l].to(dt)
        out = out + (sampled * wgt[..., None]).sum(3)
    return out.reshape(b, q, m * d)


def ms_deform_attn_bwd_plain(value, spatial_shapes, sampling_locations, attention_weights, g):
    """(d value, d loc, d attn) of ``ms_deform_attn_plain`` for the
    cotangent ``g`` (B, Q, M * D), in float32 as the JAX custom VJP
    computes them (:267-338), each cast to its input's dtype: d(value) by
    ``index_add_`` of attn * bilinear weight * g rows into each in-bounds
    corner, d(loc) = attn * (dtx * W, dty * H), d(attn) = blend . g."""
    shapes = _shapes(spatial_shapes)
    b, s, m, d = value.shape
    q, p = sampling_locations.shape[1], sampling_locations.shape[4]
    offs, _ = _level_offsets(shapes)
    g = g.reshape(b, q, m, d).float()
    gq = g[:, :, :, None, :]  # (B, Q, M, 1, D)
    # d(value) rows of every (batch, head) slice: (B * M * S, D)
    dval = torch.zeros((b * m * s, d), dtype=torch.float32, device=value.device)
    base = (torch.arange(b, device=value.device).view(b, 1, 1, 1) * m
            + torch.arange(m, device=value.device).view(1, 1, m, 1)) * s
    dloc_levels, dattn_levels = [], []
    for l, (h, w) in enumerate(shapes):
        value_l = value[:, offs[l]:offs[l] + h * w].float()
        ll = sampling_locations[:, :, :, l].float()
        al = attention_weights[:, :, :, l].float()
        x0, y0, tx, ty = _corners(ll, h, w)
        vs, idxs, inbs = {}, {}, {}
        for dy in (0, 1):
            for dx in (0, 1):
                vs[dy, dx], idxs[dy, dx], inbs[dy, dx] = _gather(value_l, h, w, y0 + dy, x0 + dx)
        wy = {0: 1.0 - ty, 1: ty}
        wx = {0: 1.0 - tx, 1: tx}
        blend = sum(vs[dy, dx] * (wy[dy] * wx[dx])[..., None] for dy in (0, 1) for dx in (0, 1))
        dattn_levels.append((blend * gq).sum(-1))
        ddx = sum(wy[dy][..., None] * (vs[dy, 1] - vs[dy, 0]) for dy in (0, 1))
        ddy = sum(wx[dx][..., None] * (vs[1, dx] - vs[0, dx]) for dx in (0, 1))
        dtx = al * (ddx * gq).sum(-1)
        dty = al * (ddy * gq).sum(-1)
        dloc_levels.append(torch.stack([dtx * w, dty * h], dim=-1))
        for dy in (0, 1):
            for dx in (0, 1):
                coef = al * wy[dy] * wx[dx] * inbs[dy, dx].float()  # (B, Q, M, P)
                rows = coef[..., None] * gq  # (B, Q, M, P, D)
                dval.index_add_(0, (base + offs[l] + idxs[dy, dx]).reshape(-1),
                                rows.reshape(-1, d))
    dvalue = dval.reshape(b, m, s, d).permute(0, 2, 1, 3).to(value.dtype)
    dloc = torch.stack(dloc_levels, dim=3).to(sampling_locations.dtype)
    dattn = torch.stack(dattn_levels, dim=3).to(attention_weights.dtype)
    return dvalue.contiguous(), dloc, dattn


def window_geometry(d: int):
    """K9b's blocking at head dim ``d``: queries a block (one (b, m) and
    that many consecutive queries), a window's capacity in pixels, and the
    block's shared memory in bytes (its g rows, the window's counts and
    listed pixels, the lists of its corners)."""
    lp, _ = LANES[d]
    qt = BWD_THREADS // lp
    return qt, WINDOW_PIXELS, qt * d * 4 + WINDOW_PIXELS * 8 + qt * GROUP * 4 * 8


def _level_corners(loc_l: torch.Tensor, h: int, w: int):
    """The four corners of each point of one level as the kernels order
    them ((y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1)): x, y
    (B, Q, M, P, 4) and whether each lies inside the map."""
    x0, y0, _, _ = _corners(loc_l, h, w)
    xs = torch.stack([x0, x0 + 1, x0, x0 + 1], dim=-1)
    ys = torch.stack([y0, y0, y0 + 1, y0 + 1], dim=-1)
    return xs, ys, (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)


def bwd_plan(spatial_shapes, sampling_locations, d: int):
    """K9b's plan, the plain mirror of csrc/ms_deform_attn.cu's
    ``msda_bwd_kernel``. A block owns one (b, m) and a tile of
    ``window_geometry``'s queries. On each level it takes the box of its
    in-bounds corners; if there are at most ``GROUP`` points and the box's
    width fits the window's capacity, the window is a band of that width
    and as many of the box's rows as fit (all of them, or a band centred on
    the corners' mean row), and the corners inside the band are summed per
    window pixel (a sorted list of each pixel's corners) and added into
    d(value) once a pixel; every other in-bounds row goes straight into
    d(value). Returns ``window`` (B, M, tiles, L, 4), the band as (x_lo,
    y_lo, x_hi, y_hi); ``windowed`` (B, M, tiles, L); ``tiles``; and
    ``queries``, a block's."""
    shapes = _shapes(spatial_shapes)
    loc = sampling_locations
    b, q, m, _, p, _ = loc.shape
    qt, cap, _ = window_geometry(d)
    tiles = -(-q // qt)
    big = 2 ** 30
    windows, windowed = [], []
    for lvl, (h, w) in enumerate(shapes):
        xs, ys, inb = _level_corners(loc[:, :, :, lvl].float(), h, w)

        def per_block(t, fill, reduce):  # over each block's in-bounds corners
            t = torch.where(inb, t, torch.full_like(t, fill)).permute(0, 2, 1, 3, 4)
            t = torch.nn.functional.pad(t.reshape(b, m, q, p * 4), (0, 0, 0, tiles * qt - q),
                                        value=fill)
            return reduce(t.reshape(b, m, tiles, qt * p * 4), -1)

        x_lo, y_lo = per_block(xs, big, torch.amin), per_block(ys, big, torch.amin)
        x_hi, y_hi = -per_block(-xs, big, torch.amin), -per_block(-ys, big, torch.amin)
        count = per_block(torch.ones_like(xs), 0, torch.sum)
        ysum = per_block(ys, 0, torch.sum)
        bw, rows = x_hi - x_lo + 1, y_hi - y_lo + 1
        win = (count > 0) & (bw <= cap) & (p <= GROUP)
        bh = torch.minimum(rows, cap // bw.clamp(min=1))
        # a band centred on the mean row: floor(mean - (bh - 1) / 2 + 1 / 2)
        mid = (2 * ysum + count * (2 - bh)) // (2 * count).clamp(min=1)
        top = torch.where(bh < rows, torch.minimum(torch.maximum(mid, y_lo), y_hi - bh + 1), y_lo)
        windows.append(torch.stack([x_lo, top, x_hi, top + bh - 1], dim=-1))
        windowed.append(win)
    return {"queries": qt, "tiles": tiles, "window": torch.stack(windows, dim=3),
            "windowed": torch.stack(windowed, dim=3)}


def plan_routes(plan, spatial_shapes, sampling_locations):
    """Each corner's route under ``bwd_plan``'s ``plan``: ``(inside,
    window)`` (B, Q, M, L, P, 4) bool, whether it lies inside its map and
    whether it sums in its block's window (else, if inside, it goes
    straight into d(value)), and its (x, y) and its block's window (B, Q,
    M, L, P, 4, 4)."""
    shapes = _shapes(spatial_shapes)
    loc = sampling_locations
    b, q, m, _, p, _ = loc.shape
    dev = loc.device
    bi = torch.arange(b, device=dev).view(b, 1, 1, 1, 1).expand(b, q, m, p, 4)
    mi = torch.arange(m, device=dev).view(1, 1, m, 1, 1).expand(b, q, m, p, 4)
    ti = (torch.arange(q, device=dev) // plan["queries"]).view(1, q, 1, 1, 1).expand(b, q, m, p, 4)
    inside, window, xy, boxes = [], [], [], []
    for lvl, (h, w) in enumerate(shapes):
        xs, ys, inb = _level_corners(loc[:, :, :, lvl].float(), h, w)
        box = plan["window"][bi, mi, ti, lvl]  # (B, Q, M, P, 4, 4)
        band = (ys >= box[..., 1]) & (ys <= box[..., 3])
        inside.append(inb)
        window.append(inb & plan["windowed"][bi, mi, ti, lvl] & band)
        xy.append(torch.stack([xs, ys], dim=-1))
        boxes.append(box)
    return (torch.stack(inside, dim=3), torch.stack(window, dim=3), torch.stack(xy, dim=3),
            torch.stack(boxes, dim=3))


def ms_deform_attn_bwd_planned(value, spatial_shapes, sampling_locations, attention_weights, g):
    """d(value) of ``ms_deform_attn`` for the cotangent ``g`` summed as
    K9b's plan (``bwd_plan``) sums it, in float32: each window pixel's
    corner rows (attn * bilinear weight * g) summed, then added into
    d(value) once; every other in-bounds row straight into d(value).
    Returns (d value, adds, plan) with ``adds`` (B, Q, M, L, P, 4) the
    times each corner's row reached d(value), through its window or
    straight: 1 for a corner inside its map, 0 outside."""
    shapes = _shapes(spatial_shapes)
    loc, attn = sampling_locations, attention_weights
    b, s, m, d = value.shape
    q, p = loc.shape[1], loc.shape[4]
    dev = value.device
    offs, _ = _level_offsets(shapes)
    plan = bwd_plan(shapes, loc, d)
    qt, cap, tiles = plan["queries"], window_geometry(d)[1], plan["tiles"]
    inside, via, xy, boxes = plan_routes(plan, shapes, loc)
    g = g.reshape(b, q, m, d).float()
    flat = torch.zeros((b * s * m, d), dtype=torch.float32, device=dev)
    adds = torch.zeros(loc.shape[:5] + (4,), dtype=torch.int64, device=dev)
    bi = torch.arange(b, device=dev).view(b, 1, 1, 1, 1)
    mi = torch.arange(m, device=dev).view(1, 1, m, 1, 1)
    ti = (torch.arange(q, device=dev) // qt).view(1, q, 1, 1, 1)
    for lvl, (h, w) in enumerate(shapes):
        _, _, tx, ty = _corners(loc[:, :, :, lvl].float(), h, w)
        wy, wx = torch.stack([1 - ty, ty], -1), torch.stack([1 - tx, tx], -1)
        cw = attn[:, :, :, lvl].float()[..., None] * (wy[..., [0, 0, 1, 1]] * wx[..., [0, 1, 0, 1]])
        rows = cw[..., None] * g[:, :, :, None, None, :]  # (B, Q, M, P, 4, D)
        xs, ys = xy[:, :, :, lvl, ..., 0], xy[:, :, :, lvl, ..., 1]
        box, win, inb = boxes[:, :, :, lvl], via[:, :, :, lvl], inside[:, :, :, lvl]
        bw = box[..., 2] - box[..., 0] + 1
        # the window route: each corner into its block's window slot
        slot = ((bi * m + mi) * tiles + ti) * cap + (ys - box[..., 1]) * bw + (xs - box[..., 0])
        windows = torch.zeros((b * m * tiles * cap, d), dtype=torch.float32, device=dev)
        windows.index_add_(0, slot[win], rows[win])
        # then each window pixel of each windowed block, once
        blk = plan["windowed"][:, :, :, lvl].nonzero()  # (n, 3): b, m, tile
        bb = plan["window"][blk[:, 0], blk[:, 1], blk[:, 2], lvl]
        sw, sh = bb[:, 2] - bb[:, 0] + 1, bb[:, 3] - bb[:, 1] + 1
        px = torch.arange(cap, device=dev)
        used = px[None] < (sw * sh)[:, None]  # (n, cap)
        py, pxx = bb[:, 1, None] + px[None] // sw[:, None], bb[:, 0, None] + px[None] % sw[:, None]
        base = ((blk[:, 0] * m + blk[:, 1]) * tiles + blk[:, 2]) * cap
        dst = ((blk[:, 0, None] * s + offs[lvl] + py * w + pxx) * m + blk[:, 1, None])[used]
        flat.index_add_(0, dst, windows[(base[:, None] + px[None])[used]])
        # the straight route
        direct = inb & ~win
        dst = (bi * s + offs[lvl] + ys.clamp(0, h - 1) * w + xs.clamp(0, w - 1)) * m + mi
        flat.index_add_(0, dst[direct], rows[direct])
        adds[:, :, :, lvl] = win.long() + direct.long()
    return flat.view(b, s, m, d).to(value.dtype), adds, plan


def _levels(shapes: Shapes, s: int):
    """The (H, W, start) of each level as the kernels take them."""
    offs, total = _level_offsets(shapes)
    if total != s:
        raise ValueError(f"spatial shapes sum {total} != S {s}")
    flat = [v for (h, w), o in zip(shapes, offs) for v in (h, w, o)]
    return (ctypes.c_int * len(flat))(*flat)


def _check(value, loc, attn, shapes: Shapes) -> None:
    b, s, m, d = value.shape
    q, n_levels, p = loc.shape[1], loc.shape[3], loc.shape[4]
    _build.check_cuda(value, "value")
    _build.check_cuda(loc, "sampling_locations", (b, q, m, len(shapes), p, 2), torch.float32)
    _build.check_cuda(attn, "attention_weights", (b, q, m, n_levels, p), torch.float32)
    if d not in LANES:
        raise NotImplementedError(
            f"ms_deform_attn: head dim {d} not ported (one of {sorted(LANES)})")
    if not 1 <= len(shapes) <= MAX_LEVELS:
        raise NotImplementedError(f"ms_deform_attn: {len(shapes)} levels not ported "
                                  f"(1 to {MAX_LEVELS})")
    if min(q, p) < 1:
        raise ValueError("ms_deform_attn: no queries or no points")


def _forward(value, loc, attn, shapes: Shapes):
    b, s, m, d = value.shape
    q, p = loc.shape[1], loc.shape[4]
    out = torch.empty((b, q, m * d), dtype=torch.float32, device=value.device)
    _build.launch(
        "ms_deform_attn", "sft_ms_deform_attn_fwd", _FWD_ARGTYPES,
        value.data_ptr(), loc.data_ptr(), attn.data_ptr(), out.data_ptr(), _levels(shapes, s),
        len(shapes), b, s, q, m, d, p, *LANES[d], _build.DTYPE_CODE[value.dtype],
        _build.stream_ptr(value))
    ms_deform_attn.launches += 1
    return out


def ms_deform_attn_bwd(value, spatial_shapes, loc, attn, g):
    """K9b: (d value, d loc, d attn) of ``ms_deform_attn`` for the float32
    cotangent ``g`` (B, Q, M * D), CUDA tensors only. d(value) is summed by
    atomics into a float32 buffer, so its summation order, and its last
    bits, vary from run to run; it is cast to value's dtype at the end."""
    shapes = _shapes(spatial_shapes)
    _check(value, loc, attn, shapes)
    b, s, m, d = value.shape
    q, p = loc.shape[1], loc.shape[4]
    _build.check_cuda(g, "g", (b, q, m * d), torch.float32)
    dvalue = torch.zeros((b, s, m, d), dtype=torch.float32, device=value.device)
    dloc = torch.empty_like(loc)
    dattn = torch.empty_like(attn)
    _build.launch(
        "ms_deform_attn", "sft_ms_deform_attn_bwd", _BWD_ARGTYPES,
        value.data_ptr(), loc.data_ptr(), attn.data_ptr(), g.data_ptr(), dvalue.data_ptr(),
        dloc.data_ptr(), dattn.data_ptr(), _levels(shapes, s), len(shapes), b, s, q, m, d, p,
        *LANES[d], _build.DTYPE_CODE[value.dtype], _build.stream_ptr(value))
    ms_deform_attn_bwd.launches += 1
    return dvalue.to(value.dtype), dloc, dattn


def _fwd_op(value, loc, attn, heights, widths):
    """K9f on the card as ``sft::ms_deform_attn`` runs it: the checks, then
    the kernel (``launches`` of ``ms_deform_attn`` counts it)."""
    shapes = tuple(zip(heights, widths))
    _check(value, loc, attn, shapes)
    return _forward(value, loc, attn, shapes)


ms_deform_attn_fwd = _build.register_op(
    "ms_deform_attn(Tensor value, Tensor loc, Tensor attn, int[] heights, int[] widths) "
    "-> Tensor",
    cuda=_fwd_op,
    cpu=lambda value, loc, attn, heights, widths: ms_deform_attn_plain(
        value, tuple(zip(heights, widths)), loc, attn),
    fake=lambda value, loc, attn, heights, widths: value.new_empty(
        (value.shape[0], loc.shape[1], value.shape[2] * value.shape[3]),
        dtype=_result_dtype(value)))


class _MSDeformAttn(torch.autograd.Function):
    """K9f, with K9b as the backward."""

    @staticmethod
    def forward(ctx, value, loc, attn, shapes):
        ctx.save_for_backward(value, loc, attn)
        ctx.shapes = shapes
        return _forward(value, loc, attn, shapes)

    @staticmethod
    def backward(ctx, g):
        value, loc, attn = ctx.saved_tensors
        dvalue, dloc, dattn = ms_deform_attn_bwd(value, ctx.shapes, loc, attn,
                                                 g.float().contiguous())
        return dvalue, dloc, dattn, None


def ms_deform_attn(value, spatial_shapes, sampling_locations, attention_weights):
    """Multi-scale deformable attention under the contract above. CUDA
    tensors go through the kernels (value float32 or bfloat16, locations
    and weights float32, D in ``LANES``; anything else raises), with K9b
    as the backward when a gradient is needed; CPU tensors through the
    plain version. Without a gradient, through
    ``sft::ms_deform_attn`` on either device."""
    shapes = _shapes(spatial_shapes)
    loc, attn = sampling_locations, attention_weights
    if torch.is_grad_enabled() and (value.requires_grad or loc.requires_grad
                                    or attn.requires_grad):
        if value.device.type == "cpu":
            return ms_deform_attn_plain(value, shapes, loc, attn)
        _check(value, loc, attn, shapes)
        return _MSDeformAttn.apply(value, loc, attn, shapes)
    _build.check_device(value, "value")
    return ms_deform_attn_fwd(value, loc, attn, [h for h, _ in shapes], [w for _, w in shapes])


ms_deform_attn.launches = 0
ms_deform_attn_bwd.launches = 0
