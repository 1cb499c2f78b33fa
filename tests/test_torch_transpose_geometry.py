"""The geometry of K5f, K5b and K7b (``ops/transpose_geometry.py``) on the
CPU.

The tables' weights are held against ``resize`` and the transpose of
``resize`` taken by autograd, at dyadic and non-dyadic ratios, downsampling
and the edges. Each kernel's blocking is mirrored in numpy from the same
tables, block by block and row by row as ``csrc/resize_sum.cu``,
``csrc/resize_sum_bwd.cu`` and ``csrc/lowres_loss.cu`` walk them (K5f's
bands, spans, ring of source rows and vertically interpolated rows; bands
and rolling rows for K5b; tiles, regions, chunks of fine rows and the
separable transpose for K7b), and the mirror is held against the plain
versions (or autograd through them) and against the JAX package's Pallas
kernels in interpret mode. Tolerance: 1e-5 of the largest reference entry
(float64 mirrors against float32 references); K5f's float32 mirror rounds
each operation as the kernel does and equals the plain version bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from segmentation_factory_tpu.ops import pallas_loss as JL
from segmentation_factory_tpu.ops import pallas_resize_sum as JR
from segmentation_factory_tpu_torch.models.layers.common import resize
from segmentation_factory_tpu_torch.ops import lowres_loss, resize_sum
from segmentation_factory_tpu_torch.ops import transpose_geometry as TG

REL = 1e-5

# (n_in, n_out): the main path's levels and loss, configs #1 / #4, ratios
# that do not divide, downsampling, and one-pixel axes (all taps clamped)
AXES = [(128, 256), (64, 256), (32, 256), (256, 1024), (16, 64), (56, 224), (7, 56),
        (63, 250), (47, 190), (13, 50), (25, 50), (7, 50), (10, 7), (1, 8), (2, 3), (5, 5)]


def _jacobian(n_in, n_out):
    """d resize(x)[d] / d x[s] along one axis, (n_out, n_in), by autograd."""
    x = torch.zeros((1, n_in, 1, 1))
    return torch.autograd.functional.jacobian(
        lambda t: resize(t, (n_out, 1)).reshape(-1), x).reshape(n_out, n_in).numpy()


@pytest.mark.parametrize("n_in,n_out", AXES)
def test_footprints_are_the_transpose_of_resize(n_in, n_out):
    jac = _jacobian(n_in, n_out)
    lo, n, off, wts = TG.footprints(n_in, n_out)
    t = np.zeros((n_in, n_out), np.float32)
    for s in range(n_in):
        t[s, lo[s]:lo[s] + n[s]] = wts[off[s]:off[s] + n[s]]
    np.testing.assert_allclose(t, jac.T, rtol=1e-6, atol=1e-7)
    # every source whose column of the jacobian is nonzero has a footprint
    # covering all of it
    assert ((jac != 0).sum(0) <= n).all()


@pytest.mark.parametrize("n_in,n_out", AXES)
def test_row_weights_are_the_upsample(n_in, n_out):
    jac = _jacobian(n_in, n_out)
    i0, a, b = TG.row_weights(n_in, n_out)
    m = np.zeros((n_out, n_in), np.float32)
    for d in range(n_out):
        m[d, i0[d]] += a[d]
        if b[d]:
            m[d, i0[d] + 1] += b[d]
    np.testing.assert_allclose(m, jac, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------- K5f


@pytest.mark.parametrize("n_in,n_out", AXES)
def test_tap_quads_are_resize(n_in, n_out):
    """(i0, i1, 1 - f, f) resample a row as ``resize`` does, bit for bit."""
    x = np.random.default_rng(44).normal(size=(1, n_in, 1, 3)).astype(np.float32)
    q = TG.tap_quads(n_in, n_out)
    wa, wb = q[:, 2].copy().view(np.float32), q[:, 3].copy().view(np.float32)
    got = x[:, q[:, 0]] * wa[None, :, None, None] + x[:, q[:, 1]] * wb[None, :, None, None]
    want = resize(torch.from_numpy(x), (n_out, 1)).numpy()
    np.testing.assert_array_equal(got, want)


def _sum_fwd_mirror(full, smalls, **kw):
    """K5f's blocking in numpy float32, each product and sum rounded as the
    kernel rounds it: per block (band, span; the channel slab is an axis
    here) the ring of source rows and the ring of full-size rows, asked for
    as ``csrc/resize_sum.cu`` asks for them (cp.async groups: at the start
    two and an empty one, then per fine row one for the source rows and,
    after its barrier, one for a full-size row; each barrier waits for all
    but the last two) and checked to be in their slot and to have landed
    when read; each fine row's V rows, then each pixel's two columns per
    level. Returns the output and how often each pixel was written."""
    bsz, hh, ww, e = full[0].shape
    levels = tuple((z.shape[1], z.shape[2]) for z in smalls)
    geo = TG.sum_fwd_geometry(hh, ww, levels, e, 4, **kw)
    tab = geo.table
    out = np.zeros(full[0].shape, np.float32)
    writes = np.zeros((bsz, hh, ww), np.int64)
    lv = []
    for (h, w), (o_rows, o_cols, o_spans, wmax) in zip(levels, geo.offsets):
        rq = tab[o_rows:o_rows + 4 * hh].reshape(hh, 4)
        cq = tab[o_cols:o_cols + 4 * ww].reshape(ww, 4)
        sp = tab[o_spans:o_spans + 2 * geo.spans].reshape(-1, 2)
        assert sp[:, 1].max() == wmax
        lv.append((rq, cq, sp, wmax))
    f32 = lambda a: a.copy().view(np.float32)  # noqa: E731
    for band in range(geo.bands):
        y0, y1 = band * geo.rows, min(band * geo.rows + geo.rows, hh)
        for span in range(geo.spans):
            x0, x1 = span * geo.cols, min(span * geo.cols + geo.cols, ww)
            rings, k, kmax = [], [], []
            for z, (rq, cq, sp, wmax) in zip(smalls, lv):
                xa, nw = sp[span]
                assert cq[x0:x1, :2].min() >= xa and cq[x0:x1, :2].max() < xa + nw <= wmax + xa
                k.append(rq[y0, 0])
                kmax.append(rq[y1 - 1, 1])
                ring = {}  # slot -> (source row, group, columns)
                for r in range(k[-1], min(k[-1] + 4, kmax[-1] + 1)):
                    ring[r % TG.SUMF_RING] = (r, 0 if r < k[-1] + 2 else 1,
                                              z[:, r, xa:xa + nw].copy())
                rings.append(ring)
            fring = {0: (y0, 0)}  # slot -> (full-size row, group)
            if y0 + 1 < y1:
                fring[1 % TG.SUMF_FRING] = (y0 + 1, 1)
            done, group = 0, 2  # groups up to `done` have landed; the last committed
            for yy in range(y0, y1):
                group += 1  # the source rows asked for at this fine row
                vrows = []
                for li, (z, (rq, cq, sp, wmax)) in enumerate(zip(smalls, lv)):
                    xa, nw = sp[span]
                    i0, i1 = rq[yy, 0], rq[yy, 1]
                    if i0 != k[li]:
                        assert i0 == k[li] + 1
                        k[li] = i0
                        if i0 + 3 <= kmax[li]:
                            rings[li][(i0 + 3) % TG.SUMF_RING] = (i0 + 3, group,
                                                                  z[:, i0 + 3, xa:xa + nw].copy())
                    for r in (i0, i1):
                        row, grp, _ = rings[li][r % TG.SUMF_RING]
                        assert row == r and grp <= done, (yy, li, r, row, grp, done)
                    a, b = f32(rq[yy, 2:3])[0], f32(rq[yy, 3:4])[0]
                    vrows.append(rings[li][i0 % TG.SUMF_RING][2] * a
                                 + rings[li][i1 % TG.SUMF_RING][2] * b)
                done = group - 2  # the barrier: all but the last two groups
                group += 1  # full-size row yy + 2
                if yy + 2 < y1:
                    fring[(yy + 2 - y0) % TG.SUMF_FRING] = (yy + 2, group)
                row, grp = fring[(yy - y0) % TG.SUMF_FRING]
                assert row == yy and grp <= done, (yy, row, grp, done)
                acc = full[0][:, yy, x0:x1].copy()
                for f in full[1:]:
                    acc = acc + f[:, yy, x0:x1]
                for li, (rq, cq, sp, wmax) in enumerate(lv):
                    c = cq[x0:x1] - np.array([sp[span][0], sp[span][0], 0, 0], np.int32)
                    a, b = f32(c[:, 2]), f32(c[:, 3])
                    v = vrows[li]
                    acc = acc + (v[:, c[:, 0]] * a[None, :, None] + v[:, c[:, 1]] * b[None, :, None])
                out[:, yy, x0:x1] = acc
                writes[:, yy, x0:x1] += 1
    return out, writes, geo


# (output rows and columns, the smaller levels, the number of full-size
# levels, E, the band's rows, the span's most columns)
SUM_FWD_CASES = [
    ((32, 32), [(16, 16), (8, 8), (4, 4)], 1, 16, 8, 12),  # the main path's pyramid, cut
    ((56, 56), [(28, 28), (14, 14), (7, 7)], 1, 8, 16, None),  # config #4's head at 224^2
    ((50, 53), [(25, 26), (13, 14), (7, 8)], 1, 12, 7, 16),  # a pyramid that does not divide
    ((20, 23), [(13, 14), (7, 8), (1, 1)], 2, 20, 6, 8),  # two full-size levels, E % 8 == 4
    ((20, 23), [(13, 30)], 1, 4, 32, 5),                  # wider than the output: downsampling
    ((16, 16), [], 3, 8, 5, None),                         # only full-size levels
    ((24, 20), [(12, 10), (6, 5), (3, 3), (2, 2), (1, 1), (24, 7), (5, 20)], 1, 8, 4, 6),
]


@pytest.mark.parametrize("hw,levels,nfull,e,rows,cols", SUM_FWD_CASES)
def test_sum_fwd_mirror_matches_plain(hw, levels, nfull, e, rows, cols):
    rng = np.random.default_rng(45)
    full = [rng.normal(size=(2, *hw, e)).astype(np.float32) for _ in range(nfull)]
    smalls = [rng.normal(size=(2, h, w, e)).astype(np.float32) for h, w in levels]
    got, writes, geo = _sum_fwd_mirror(full, smalls, rows=rows, cols=cols)
    assert (writes == 1).all()
    assert e % (geo.vec * geo.groups) == 0 and geo.vec == (8 if e % 8 == 0 else 4)
    want = resize_sum.resize_sum_plain([torch.from_numpy(z) for z in full + smalls])
    np.testing.assert_array_equal(got, want.numpy())


def test_sum_fwd_mirror_matches_pallas_forward():
    rng = np.random.default_rng(46)
    full = rng.normal(size=(2, 32, 32, 128)).astype(np.float32)
    smalls = [rng.normal(size=(2, 32 // s, 32 // s, 128)).astype(np.float32) for s in (2, 4, 8)]
    with pltpu.force_tpu_interpret_mode():
        want = JR._forward(jnp.asarray(full), [jnp.asarray(z) for z in smalls], [2, 4, 8], 16)
    got, _, _ = _sum_fwd_mirror([full], smalls, rows=8, cols=12)
    _close(got, np.asarray(want))


def test_sum_fwd_geometry_main_path():
    """The main path's K5f: bands of 32 fine rows, spans of 64 fine columns,
    slabs of 64 channels (8 a thread), 768 blocks; the smaller levels read
    1.22 times (a halo row and column a band and span), shared memory for
    two blocks an SM."""
    geo = TG.sum_fwd_geometry(256, 256, ((128, 128), (64, 64), (32, 32)), 768, 2)
    assert (geo.vec, geo.groups, geo.cols, geo.rows, geo.spans, geo.bands) == (8, 8, 64, 32, 4, 8)
    assert [o[3] for o in geo.offsets] == [34, 18, 10]
    assert geo.smem == 91136 and 2 * geo.smem <= TG.SMEM_MAX
    assert geo.read_factor == pytest.approx(1.22005, abs=1e-5)


# ---------------------------------------------------------------- K5b


def _sum_bwd_mirror(g, levels, band=64):
    """K5b's blocking in numpy: per band, every fine row in order, two
    rolling rows per level, a completed row gathered by its owned columns.
    Returns the levels' cotangents and how often each element was written."""
    bsz, hh, ww, e = g.shape
    geo = TG.sum_bwd_geometry(hh, ww, tuple(levels), e, band)
    tab = geo.table
    tabf = tab.view(np.float32)
    outs = [np.zeros((bsz, h, w, e)) for h, w in levels]
    writes = [np.zeros((bsz, h, w), np.int64) for h, w in levels]
    fx = tab[geo.offsets[0]:geo.offsets[0] + 2 * geo.bands].reshape(-1, 2)
    for k in range(geo.bands):
        x0, x1 = fx[k]
        if x1 < x0:
            continue
        assert x1 - x0 + 1 <= geo.cols
        for li, (h, w) in enumerate(levels):
            rows_at, own_at, foot_at, wts_at = geo.offsets[1 + li][:4]
            rows = tab[rows_at:rows_at + 4 * hh].reshape(hh, 4)
            xa, xb = tab[own_at + 2 * k:own_at + 2 * k + 2]
            foot = tab[foot_at:foot_at + 4 * w].reshape(w, 4)
            acc0 = np.zeros((bsz, x1 - x0 + 1, e))
            acc1 = np.zeros_like(acc0)
            open_row = 0

            def flush(y, buf):
                for x in range(xa, xb):
                    xlo, n, off = foot[x, :3]
                    wt = tabf[wts_at + off:wts_at + off + n].astype(np.float64)
                    outs[li][:, y, x] = np.einsum("k,bke->be", wt, buf[:, xlo - x0:xlo - x0 + n])
                    writes[li][:, y, x] += 1

            for yy in range(hh):
                v = g[:, yy, x0:x1 + 1].astype(np.float64)
                y0, a, b = rows[yy, 0], rows[yy, 1:2].view(np.float32)[0], \
                    rows[yy, 2:3].view(np.float32)[0]
                while y0 > open_row:
                    flush(open_row, acc0)
                    acc0, acc1 = acc1, np.zeros_like(acc0)
                    open_row += 1
                acc0 += a * v
                acc1 += b * v
            while open_row < h:
                flush(open_row, acc0)
                acc0, acc1 = acc1, np.zeros_like(acc0)
                open_row += 1
    return outs, writes, geo


def _close(got, want, rel=REL):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("hw,levels,e,band", [
    ((32, 32), [(16, 16), (8, 8), (4, 4)], 8, 64),  # the main path's pyramid, cut
    ((32, 32), [(16, 16), (8, 8), (4, 4)], 8, 8),   # bands narrower than a footprint
    ((56, 56), [(28, 28), (14, 14), (7, 7)], 4, 16),  # config #4's head at 224^2
    ((50, 53), [(25, 26), (13, 14), (7, 8)], 12, 16),  # a pyramid that does not divide
    ((20, 23), [(13, 14), (7, 8), (1, 1)], 4, 8),   # non-integer ratios, a one-pixel level
    ((20, 23), [(13, 30)], 4, 8),                    # wider than the output: downsampling
])
def test_sum_bwd_mirror_matches_autograd(hw, levels, e, band):
    rng = np.random.default_rng(40)
    g = rng.normal(size=(2, *hw, e)).astype(np.float32)
    outs, writes, geo = _sum_bwd_mirror(g, levels, band)
    for w in writes:
        assert (w == 1).all()  # every output element written once
    zs = [torch.zeros((2, *hw, e), requires_grad=True)] + [
        torch.zeros((2, h, w, e), requires_grad=True) for h, w in levels]
    want = torch.autograd.grad(resize_sum.resize_sum_plain(zs), zs, torch.from_numpy(g))
    for got, ref in zip(outs, want[1:]):
        _close(got, ref.numpy())


def test_sum_bwd_mirror_matches_pallas_backward():
    rng = np.random.default_rng(41)
    g = rng.normal(size=(2, 16, 16, 128)).astype(np.float32)
    shapes = [(2, 16 // s, 16 // s, 128) for s in (2, 4, 8)]
    with pltpu.force_tpu_interpret_mode():
        want = JR._backward(jnp.asarray(g), shapes, [2, 4, 8], 8)  # two tiles: a halo fold
    outs, _, _ = _sum_bwd_mirror(g, [(s[1], s[2]) for s in shapes], band=8)
    for got, ref in zip(outs, want):
        _close(got, np.asarray(ref))


def test_sum_bwd_geometry_main_path():
    """The main path's K5b: g read once plus a halo of 4 columns a side
    between bands (72 of 64 columns inside, 68 at the edges: read factor
    280 / 256), 288 threads a block."""
    geo = TG.sum_bwd_geometry(256, 256, ((128, 128), (64, 64), (32, 32)), 768)
    assert (geo.bands, geo.cols, geo.quads, geo.threads) == (4, 72, 4, 288)
    assert geo.read_factor == pytest.approx(280 / 256)


# ---------------------------------------------------------------- K7b


def _dhi(hi, lab, wmap, dcoef, ignore):
    """The kernel's per-pixel arithmetic in float64: dhi (n, C) of n fine
    pixels' logits, as p (A + valid dP) with the label's terms after."""
    c = hi.shape[-1]
    e = np.exp(hi - hi.max(-1, keepdims=True))
    se, inner = e.sum(-1), e @ dcoef[1]
    valid = lab != ignore
    onehot = valid & (lab >= 0) & (lab < c)
    safe = np.where(onehot, lab, 0)
    p = e / se[:, None]
    pl = np.where(onehot, p[np.arange(len(lab)), safe], 0.0)
    qp = np.where(valid, inner / se + np.where(onehot, dcoef[0][safe] * pl, 0.0), 0.0)
    d = p * ((wmap - qp)[:, None] + valid[:, None] * dcoef[1][None])
    d[np.arange(len(lab)), safe] += np.where(onehot, pl * dcoef[0][safe] - wmap, 0.0)
    return d


def _loss_bwd_mirror(lo, lab, wmap, dcoef, ignore=255, tile=None, rows=None):
    """K7b's blocking in numpy: per tile, its region's fine pixels in chunks
    of ``rows`` rows, each pixel's dhi from the staged taps, then the column
    gather and the row accumulation into the tile. Returns dlo and how many
    times each fine pixel was computed."""
    bsz, hl, wl, c = lo.shape
    hh, ww = lab.shape[1:]
    geo = TG.loss_bwd_geometry(hl, wl, hh, ww, c, 4, tile, rows)
    tab = geo.table
    tabf = tab.view(np.float32)
    o_rows, o_cols, o_try, o_trx, o_foot, o_wts = geo.offsets
    ytap = tab[o_rows:o_rows + 4 * hh].reshape(hh, 4)
    xtap = tab[o_cols:o_cols + 4 * ww].reshape(ww, 4)
    fy_all, fx_all = ytap[:, 2].copy().view(np.float32), xtap[:, 2].copy().view(np.float32)
    foot = tab[o_foot:o_foot + 4 * wl].reshape(wl, 4)
    ty, tx = geo.tile
    nty, ntx = -(-hl // ty), -(-wl // tx)
    regy = tab[o_try:o_try + 2 * nty].reshape(-1, 2)
    regx = tab[o_trx:o_trx + 2 * ntx].reshape(-1, 2)
    dlo = np.zeros(lo.shape)
    computed = np.zeros((bsz, hh, ww), np.int64)
    lo64 = lo.astype(np.float64)
    for b in range(bsz):
        for i in range(nty):
            for j in range(ntx):
                ty0, tx0 = i * ty, j * tx
                tya, txa = min(ty, hl - ty0), min(tx, wl - tx0)
                (y0r, y1r), (x0r, x1r) = regy[i], regx[j]
                assert x1r - x0r + 1 <= geo.region_w
                acc = np.zeros((tya, txa, c))
                xs = np.arange(x0r, x1r + 1)
                for yc in range(y0r, y1r + 1, geo.rows):
                    ys = np.arange(yc, min(yc + geo.rows, y1r + 1))
                    yy, xx = np.meshgrid(ys, xs, indexing="ij")
                    # the taps must lie in the staged tile and its ring
                    for t, lo_, hi_ in ((ytap[yy, :2], ty0, ty0 + tya), (xtap[xx, :2], tx0,
                                                                         tx0 + txa)):
                        assert (t >= max(lo_ - 1, 0)).all() and (t <= hi_).all()
                    fy, fx = fy_all[yy][..., None], fx_all[xx][..., None]
                    a, bb = ytap[yy, 0], ytap[yy, 1]
                    cc, dd = xtap[xx, 0], xtap[xx, 1]
                    hi = ((1 - fx) * ((1 - fy) * lo64[b, a, cc] + fy * lo64[b, bb, cc])
                          + fx * ((1 - fy) * lo64[b, a, dd] + fy * lo64[b, bb, dd]))
                    computed[b, yy, xx] += 1
                    d = _dhi(hi.reshape(-1, c), lab[b, yy, xx].reshape(-1),
                             wmap[b, yy, xx].reshape(-1), dcoef[b], ignore).reshape(hi.shape)
                    # columns: each lo column gathers its footprint
                    colt = np.zeros((len(ys), txa, c))
                    for x in range(txa):
                        xlo, n, off = foot[tx0 + x, :3]
                        wt = tabf[o_wts + off:o_wts + off + n].astype(np.float64)
                        colt[:, x] = np.einsum("k,rkc->rc", wt, d[:, xlo - x0r:xlo - x0r + n])
                    # rows: into the tile's own rows
                    for r, y in enumerate(ys):
                        i0, i1, f = ytap[y, 0], ytap[y, 1], fy_all[y]
                        same = i1 == i0
                        wa = np.float32(1 - f) + (f if same else 0)
                        if 0 <= i0 - ty0 < tya:
                            acc[i0 - ty0] += wa * colt[r]
                        if not same and 0 <= i1 - ty0 < tya:
                            acc[i1 - ty0] += f * colt[r]
                dlo[b, ty0:ty0 + tya, tx0:tx0 + txa] = acc
    return dlo, computed, geo


def _loss_inputs(rng, b, hl, wl, c, hh, ww):
    lo = (rng.normal(size=(b, hl, wl, c)) * 2).astype(np.float32)
    lab = rng.integers(0, c, (b, hh, ww)).astype(np.int32)
    lab[:, : max(1, hh // 8)] = 255
    lab[0, -1, :3] = c + 2  # outside [0, C), not void: an all-zero one-hot row
    wmap = (rng.random((b, hh, ww)) / (hh * ww)).astype(np.float32)
    dcoef = (rng.normal(size=(b, 2, c)) * 0.01).astype(np.float32)
    return lo, lab, wmap, dcoef


@pytest.mark.parametrize("shape,tile,rows", [
    ((2, 8, 8, 19, 32, 32), None, None),       # s = 4, one tile an image
    ((2, 8, 8, 19, 32, 32), (2, 4), 3),       # tiles and chunks cutting the region
    ((1, 14, 14, 9, 56, 56), (4, 4), 2),      # config #4's ratio, ragged tiles
    ((2, 15, 11, 21, 60, 44), (4, 8), None),  # config #1's classes
    ((1, 9, 7, 19, 35, 27), (4, 2), 5),       # non-integer ratios
    ((1, 6, 5, 150, 24, 20), None, None),     # ADE20K's 150 classes
    ((1, 5, 7, 19, 13, 17), (2, 2), 1),       # small ratios
])
def test_loss_bwd_mirror_matches_plain(shape, tile, rows):
    rng = np.random.default_rng(42)
    lo, lab, wmap, dcoef = _loss_inputs(rng, *shape)
    lab[-1, -4:, -5:] = 255  # a void block at the image's corner
    got, computed, geo = _loss_bwd_mirror(lo, lab, wmap, dcoef, tile=tile, rows=rows)
    want = lowres_loss.lowres_loss_bwd_plain(*map(torch.from_numpy, (lo, lab, wmap, dcoef)))
    _close(got, want.numpy())
    assert computed.min() >= 1
    assert computed.sum() == pytest.approx(geo.recompute * computed.size * 1.0)


def test_loss_bwd_mirror_matches_pallas_backward():
    rng = np.random.default_rng(43)
    lo = (rng.normal(size=(1, 4, 128, 19)) * 2).astype(np.float32)
    lab = rng.integers(0, 19, (1, 16, 512)).astype(np.int32)
    lab[:, :3] = 255
    wmap = rng.random(lab.shape).astype(np.float32) * (lab != 255)
    dcoef = (rng.normal(size=(1, 2, 19)) * 0.01).astype(np.float32)
    lo_t, lab_p = JL._prep(jnp.asarray(lo), jnp.asarray(lab), 4)
    wmap_p = jnp.asarray(wmap).reshape(1, 16, 128, 4).transpose(0, 1, 3, 2)
    dc = jnp.broadcast_to(jnp.pad(jnp.asarray(dcoef), ((0, 0), (0, 0), (0, 5)))[..., None],
                          (1, 2, 24, 128))
    with pltpu.force_tpu_interpret_mode():
        dlo_t = JL._backward(lo_t, lab_p, wmap_p, dc, 4, 255, JL._pick_tile(4, 4, 24, 128))
    want = np.asarray(dlo_t)[:, :, :19, :].transpose(0, 1, 3, 2)
    got, _, _ = _loss_bwd_mirror(lo, lab, wmap, dcoef, tile=(2, 16), rows=4)
    _close(got, want)


def test_loss_bwd_geometry_main_path():
    """The main path's K7b: 16 x 16 tiles of lo, up to 68 x 68 fine pixels
    computed for each tile's 64 x 64 (66 at the image's edges: 1.12
    softmaxes a fine pixel), shared
    memory for three blocks an SM, 7 fine rows a chunk; ADE20K's 150
    classes fit a smaller tile."""
    geo = TG.loss_bwd_geometry(256, 256, 1024, 1024, 19, 4)
    assert geo.tile == (16, 16) and geo.region_w == 68
    assert geo.recompute == pytest.approx((1084 / 1024) ** 2)
    assert geo.recompute <= 1.2
    assert geo.smem <= TG.SMEM_MAX // 3 and geo.rows == 7 and geo.threads == 480
    assert geo.threads * TG.LOSS_PAIRS >= 16 * 19
    ade = TG.loss_bwd_geometry(128, 128, 512, 512, 150, 4)
    assert ade.smem <= TG.SMEM_MAX and ade.recompute <= 1.6
