"""Geometry of the bilinear upsample and its transpose: the tables and
block layouts of the head's upsample-sum forward K5f (``csrc/resize_sum.cu``)
and of the backward kernels K5b (``csrc/resize_sum_bwd.cu``) and K7b
(``csrc/lowres_loss.cu``).

Every weight comes from ``models.layers.common.bilinear_taps``, the taps
the plain versions upsample with: (dst + 0.5) * (n_in / n_out) - 0.5 in
float32, clamped at the edge (the formula of ``csrc/common.cuh``
``bilinear_tap``). So the kernels sample, or transpose, exactly the upsample
that the plain versions apply, at any ratio, dyadic or not, and no kernel
recomputes a position in its own arithmetic. Along one axis the sources a destination
samples are ``i0`` and ``i1 = min(i0 + 1, n_in - 1)``, both non-decreasing:
the destinations that sample one source form one contiguous range, its
*footprint*.

A table is a flat int32 array (float32 weights stored by their bits), its
sections 16-byte aligned, copied to the device once per shape
(``device_tables``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from segmentation_factory_tpu_torch.models.layers.common import bilinear_taps

SMEM_MAX = 232448  # bytes of shared memory a block may use on the H100


def axis_taps(n_in: int, n_out: int):
    """(i0, i1, f) of each of ``n_out`` samples: int32 source indices and
    the float32 weight of i1 (``bilinear_taps`` on the CPU)."""
    i0, i1, f = bilinear_taps(n_in, n_out)
    return (i0.numpy().astype(np.int32), i1.numpy().astype(np.int32),
            f.numpy().astype(np.float32))


def row_weights(n_in: int, n_out: int):
    """(i0, a, b) of each sample: its weight a on source i0 and b on
    i0 + 1, float32; where the edge clamps both taps onto one source,
    a = (1 - f) + f and b = 0."""
    i0, i1, f = axis_taps(n_in, n_out)
    one = np.float32(1.0)
    same = i1 == i0
    a = np.where(same, (one - f) + f, one - f).astype(np.float32)
    b = np.where(same, np.float32(0.0), f).astype(np.float32)
    return i0, a, b


def footprints(n_in: int, n_out: int):
    """The transpose of the upsample along one axis: for each source s the
    first destination ``lo[s]`` and the count ``n[s]`` of the destinations
    whose taps include it (0 if none), and their weights on s in order,
    ``wts[off[s] : off[s] + n[s]]`` ((1 - f) as i0 plus f as i1)."""
    i0, i1, f = axis_taps(n_in, n_out)
    d = np.arange(n_out)
    lo = np.full(n_in, n_out, np.int64)
    hi = np.full(n_in, -1, np.int64)
    for idx in (i0, i1):
        np.minimum.at(lo, idx, d)
        np.maximum.at(hi, idx, d)
    n = np.maximum(hi - lo + 1, 0)
    lo = np.where(n > 0, lo, 0)
    off = np.concatenate([[0], np.cumsum(n)[:-1]]).astype(np.int64)
    wts = np.zeros(int(n.sum()), np.float32)
    # i0 first, then i1: the order in which the plain version's autograd
    # adds the two taps where the edge clamps them onto one source
    np.add.at(wts, off[i0] + d - lo[i0], np.float32(1.0) - f)
    np.add.at(wts, off[i1] + d - lo[i1], f)
    hits = np.zeros(n_in, np.int64)
    np.add.at(hits, i0, 1)
    np.add.at(hits, i1, (i1 != i0).astype(np.int64))
    assert (hits == n).all(), "a footprint is not contiguous"
    return lo.astype(np.int32), n.astype(np.int32), off.astype(np.int32), wts


class _Table:
    """A flat int32 array built section by section, each 16-byte aligned."""

    def __init__(self):
        self.parts, self.size = [], 0

    def add(self, arr) -> int:
        arr = np.ascontiguousarray(arr)
        if arr.dtype == np.float32:
            arr = arr.view(np.int32)
        arr = arr.astype(np.int32, copy=False).reshape(-1)
        at = self.size
        pad = -len(arr) % 4
        self.parts.append(np.concatenate([arr, np.zeros(pad, np.int32)]))
        self.size += len(arr) + pad
        return at

    def array(self) -> np.ndarray:
        return np.concatenate(self.parts) if self.parts else np.zeros(4, np.int32)


def _quads(*cols) -> np.ndarray:
    """Rows of four int32 words from up to four columns (floats by their
    bits), zero-padded."""
    out = np.zeros((len(cols[0]), 4), np.int32)
    for j, c in enumerate(cols):
        c = np.asarray(c)
        out[:, j] = c.view(np.int32) if c.dtype == np.float32 else c
    return out


# ------------------------------------------------------------------- K5f


def tap_quads(n_in: int, n_out: int) -> np.ndarray:
    """(i0, i1, 1 - f, f) of each of ``n_out`` samples, the weights as the
    plain version multiplies them (``resize``: ``x[i0] * (1 - f) + x[i1] *
    f``, 1 - f rounded in float32)."""
    i0, i1, f = axis_taps(n_in, n_out)
    return _quads(i0, i1, (np.float32(1.0) - f).astype(np.float32), f)


SUMF_THREADS = 256  # threads a K5f block (csrc/resize_sum.cu THREADS)
SUMF_ITEMS = 2  # fine pixels a K5f thread a fine row (csrc/resize_sum.cu ITEMS)
SUMF_RING = 4  # source rows of a level a K5f block holds (csrc/resize_sum.cu RING)
SUMF_FRING = 3  # rows of the first full-size level it holds (csrc/resize_sum.cu FRING)
_SUMF_SMEM_SOFT = 100 * 1024  # two blocks an SM below this


@dataclass(frozen=True)
class SumFwdGeometry:
    """K5f's layout for the output (B, H, W, E) and its smaller levels: a
    block owns a band of ``rows`` fine rows, a span of ``cols`` fine
    columns and a slab of ``groups`` x ``vec`` channels (a thread ``vec``
    channels of a pixel) of one image. Per level the table holds each fine
    row's and each fine column's taps (``tap_quads``) and, per span, the
    level's first column and count (xa, n) that the span samples; ``wmax``
    is the most columns a span samples (a row of the level's shared
    memory). ``smem`` bytes of shared memory: per level a ring of
    ``SUMF_RING`` source rows (the input dtype) and two rows of the
    vertically interpolated level (float32); the span's column taps; a
    ring of ``SUMF_FRING`` rows of the first full-size level.
    ``read_factor``: the smaller levels' elements a block reads (its band's
    source rows, the span's columns) over their count."""

    vec: int
    groups: int
    cols: int
    rows: int
    spans: int
    bands: int
    smem: int
    read_factor: float
    table: np.ndarray
    offsets: tuple  # per level (rows, cols, spans, wmax)


def sum_fwd_smem(wmax, slab: int, cols: int, elt: int) -> int:
    """Bytes of K5f's shared memory (``SumFwdGeometry.smem``)."""
    return (sum(SUMF_RING * w * slab * elt + 2 * w * slab * 4 for w in wmax)
            + 16 * cols * len(wmax) + SUMF_FRING * cols * slab * elt)


def sum_fwd_geometry(H: int, W: int, levels, E: int, elt: int, rows: int = 32,
                     slab: int = 64, cols: int | None = None) -> SumFwdGeometry:
    """K5f's geometry for the smaller levels [(h, w), ...] (each of at most
    H rows) of an output (H, W, E) in an ``elt``-byte dtype: 8 channels a
    thread where E allows it (16-byte bf16 loads), else 4; a slab of the
    largest power of two of channel groups that divides E and stays within
    ``slab`` channels; the widest span of fine columns that the threads
    take (``SUMF_ITEMS`` pixels each, at most ``cols``) and whose shared
    memory stays under two blocks an SM, else under the card's limit."""
    if E % 4:
        raise ValueError(f"channels {E} must be a multiple of 4")
    vec = 8 if E % 8 == 0 else 4
    groups = 1
    while groups * 2 * vec <= slab and (E // vec) % (groups * 2) == 0:
        groups *= 2
    rows = max(1, min(rows, H))
    quads = []
    for h, w in levels:
        if h > H:
            raise ValueError(f"K5f: level {h}x{w} has more rows than the output's {H}")
        rq = tap_quads(h, H)
        assert (np.diff(rq[:, 0]) <= 1).all(), "a fine row advances a source row by two"
        quads.append((rq, tap_quads(w, W)))

    def spans_of(cols):
        n = -(-W // cols)
        out = []
        for _, cq in quads:
            x0 = np.arange(n) * cols
            x1 = np.minimum(x0 + cols, W) - 1
            xa = cq[x0, 0]
            out.append(np.stack([xa, cq[x1, 1] - xa + 1], 1).astype(np.int32))
        return out

    cols = max(1, min(W, SUMF_ITEMS * SUMF_THREADS // groups, cols or W))
    for lim in (_SUMF_SMEM_SOFT, SMEM_MAX):
        c = cols
        while True:
            spans = spans_of(c)
            wmax = [int(sp[:, 1].max()) for sp in spans]
            smem = sum_fwd_smem(wmax, groups * vec, c, elt)
            if smem <= lim or c == 1:
                break
            c = max(1, c // 2)
        if smem <= lim:
            break
    if smem > SMEM_MAX:
        raise ValueError(f"K5f: {smem} bytes of shared memory at one column a block")
    cols = c
    t = _Table()
    offs = tuple((t.add(rq), t.add(cq), t.add(sp), wm)
                 for (rq, cq), sp, wm in zip(quads, spans, wmax))
    bands = -(-H // rows)
    # the source rows a band reads per level: its first row's i0 to its last row's i1
    read = total = 0
    for (h, w), (rq, _), sp in zip(levels, quads, spans):
        y0 = rq[np.arange(bands) * rows, 0]
        y1 = rq[np.minimum(np.arange(bands) * rows + rows, H) - 1, 1]
        read += int((y1 - y0 + 1).sum()) * int(sp[:, 1].sum())
        total += h * w
    return SumFwdGeometry(vec, groups, cols, rows, -(-W // cols), bands, smem,
                          read / total if total else 1.0, t.array(), offs)


# ------------------------------------------------------------------- K5b


@dataclass(frozen=True)
class SumBwdGeometry:
    """K5b's layout for g (B, H, W, E) and its smaller levels: the fine
    columns cut into ``bands`` bands of ``band`` columns; a block owns one
    band, ``quads`` groups of 4 channels and one image, reads the fine
    columns its owned low-resolution columns sample (the band and a halo,
    at most ``cols`` of them) over every fine row, and writes each owned
    output element once. ``threads`` = cols * quads rounded up to a warp.
    ``read_factor`` is the fine columns read over W (the halo's cost).
    Completed low-resolution rows wait in shared memory and are gathered
    together every SUM_EVERY fine rows (a level's ``cap`` slots hold the
    most rows it completes between two gathers)."""

    bands: int
    band: int
    cols: int
    quads: int
    threads: int
    read_factor: float
    table: np.ndarray
    # (bands, then per level: rows, owned, foot, wts, own_max, wts_max, cap)
    offsets: tuple


SUM_THREADS = 384  # threads a K5b block at most (csrc/resize_sum_bwd.cu MAX_THREADS)
SUM_EVERY = 8  # fine rows between two gathers (csrc/resize_sum_bwd.cu EVERY)


def sum_bwd_geometry(H: int, W: int, levels, E: int, band: int = 64) -> SumBwdGeometry:
    """K5b's geometry for levels [(h, w), ...] (each smaller than (H, W)).

    Per level the table holds, for each fine row Y, (y0, a, b): the weights
    of the row's two low-resolution rows; for each band the owned
    low-resolution columns [xa, xb) (a column belongs to the band holding
    its centre, so every column has one owner); for each column x its
    footprint (Xlo, n, off) into the level's weights. Per band (FX0, FX1),
    the fine columns read; (0, -1) for a band that owns nothing."""
    if E % 4:
        raise ValueError(f"channels {E} must be a multiple of 4")
    while True:
        nb = -(-W // band)
        t = _Table()
        owned, foots, rows = [], [], []
        fx0 = np.full(nb, W, np.int64)
        fx1 = np.full(nb, -1, np.int64)
        for h, w in levels:
            y0, a, b = row_weights(h, H)
            rows.append(_quads(y0, a, b))
            lo, n, off, wts = footprints(w, W)
            centre = np.minimum(((np.arange(w) + 0.5) * (W / w)).astype(np.int64), W - 1)
            owner = centre // band
            xa = np.searchsorted(owner, np.arange(nb), "left")
            xb = np.searchsorted(owner, np.arange(nb), "right")
            for k in range(nb):
                xs = np.arange(xa[k], xb[k])
                xs = xs[n[xs] > 0]
                if len(xs):
                    fx0[k] = min(fx0[k], lo[xs].min())
                    fx1[k] = max(fx1[k], (lo[xs] + n[xs] - 1).max())
            owned.append(np.stack([xa, xb], 1).astype(np.int32))
            foots.append((lo, n, off, wts))
        empty = fx1 < fx0
        fx0[empty], fx1[empty] = 0, -1
        cols = int(max(1, (fx1 - fx0 + 1).max()))
        quads = next((q for q in (4, 2, 1) if (E // 4) % q == 0 and cols * q <= SUM_THREADS),
                     None)
        if quads is not None or band == 1:
            break
        band = max(1, band // 2)
    if quads is None:
        raise ValueError(f"K5b: {cols} fine columns a band exceed {SUM_THREADS} threads")
    offs = [t.add(np.stack([fx0, fx1], 1).astype(np.int32))]
    for r, o, (lo, n, off, wts) in zip(rows, owned, foots):
        # the most columns a band owns, and their most weights: the shared
        # memory a block stages them in
        own_max = int((o[:, 1] - o[:, 0]).max())
        ends = np.concatenate([off, [len(wts)]])
        wts_max = int((ends[o[:, 1]] - ends[o[:, 0]]).max())
        # rows completed before fine row Y: y0[Y] - y0[Y - 1]; the most in
        # one window of SUM_EVERY rows between two gathers
        done = np.diff(np.concatenate([[0], r[:, 0]]))
        cap = int(max(1, np.add.reduceat(done, np.arange(0, H, SUM_EVERY)).max()))
        offs.append((t.add(r), t.add(o), t.add(_quads(lo, n, off)), t.add(wts), own_max,
                     wts_max, cap))
    read = float((fx1 - fx0 + 1).clip(min=0).sum()) / W
    return SumBwdGeometry(nb, band, cols, quads, -(-cols * quads // 32) * 32, read, t.array(),
                          tuple(offs))


# ------------------------------------------------------------------- K7b

# tile candidates (rows, columns of lo), the first whose shared memory fits
_LOSS_TILES = ((16, 16), (8, 16), (8, 8), (4, 8), (4, 4), (2, 4), (2, 2), (1, 2), (1, 1))
_LOSS_SMEM_SOFT = 100 * 1024  # two blocks an SM below this
MAX_THREADS_LOSS = 1024  # csrc/lowres_loss.cu MAX_THREADS_BWD
# fine pixels a chunk aimed at: 7 rows of 68 at the main path's s = 4, 480
# threads at 64 registers, two blocks an SM (the fastest of 4-8 rows,
# tools/transpose_variants.py)
_LOSS_PIXELS = 480
LOSS_PAIRS = 2  # (lo column, class) pairs a thread owns at most (csrc/lowres_loss.cu PAIRS)



@dataclass(frozen=True)
class LossBwdGeometry:
    """K7b's layout for lo (B, hl, wl, C) and labels (B, H, W): a block owns
    a ``tile`` of lo and computes every fine pixel whose taps touch it (its
    region, at most ``region_w`` fine columns wide), ``rows`` fine rows at a
    time, one thread a pixel; each of its ``threads`` owns one or two
    (lo column, class) pairs of the tile for the transpose; ``smem`` bytes
    of shared memory. ``recompute`` is the fine pixels computed over
    H * W: those whose taps straddle two tiles are computed by each."""

    tile: tuple
    rows: int
    region_w: int
    threads: int
    smem: int
    dstride: int
    recompute: float
    table: np.ndarray
    offsets: tuple  # (row taps, col taps, tile rows, tile cols, col foot, col wts)


def _tile_regions(n_in: int, n_out: int, t: int):
    """Per tile of ``t`` sources, the first and last destination whose taps
    touch it ((0, -1) if none)."""
    lo, n, _, _ = footprints(n_in, n_out)
    out = []
    for s0 in range(0, n_in, t):
        s = np.arange(s0, min(s0 + t, n_in))
        s = s[n[s] > 0]
        out.append((int(lo[s].min()), int((lo[s] + n[s] - 1).max())) if len(s) else (0, -1))
    return np.asarray(out, np.int32)


def loss_smem(tile, rows: int, region_w: int, c: int, elt: int) -> tuple[int, int]:
    """(bytes, D's stride in floats) of K7b's shared memory: the staged lo
    tile and its ring (``elt`` bytes an element), D (each class's dhi at
    ``rows`` x ``region_w`` pixels, the stride odd), the region's column
    taps, the tile's footprints and their weights, and dcoef."""
    ty, tx = tile
    dstride = rows * region_w | 1
    floats = c * dstride + 3 * region_w + 3 * tx + 2 * (region_w + tx) + 2 * c
    lo_bytes = -(-(ty + 2) * (tx + 2) * c * elt // 16) * 16
    return lo_bytes + 4 * floats, dstride


def loss_bwd_geometry(hl: int, wl: int, H: int, W: int, C: int, elt: int,
                      tile=None, rows=None) -> LossBwdGeometry:
    """K7b's geometry: the first tile of ``_LOSS_TILES`` (or ``tile``) whose
    pairs the threads can own (one a thread where it can) and whose shared
    memory, with as many fine rows a chunk (or ``rows``) as about
    ``_LOSS_PIXELS`` threads take pixels (one each), stays under two blocks an SM, else under the card's limit. The
    table holds each fine row's and column's taps (i0, i1, f), each tile
    row's and column's region (first, last fine index), and each lo
    column's footprint (Xlo, n, off) into the column weights."""
    cands = [tuple(tile)] if tile else list(_LOSS_TILES)
    best = None
    for lim in (_LOSS_SMEM_SOFT, SMEM_MAX):
        for ty, tx in cands:
            ry, rx = _tile_regions(hl, H, ty), _tile_regions(wl, W, tx)
            region_w = int(max(1, (rx[:, 1] - rx[:, 0] + 1).max()))
            # one pair a thread where the threads can, else two
            pair_threads = -(-tx * C // 32) * 32
            if pair_threads > MAX_THREADS_LOSS:
                pair_threads = -(-tx * C // (32 * LOSS_PAIRS)) * 32
            for r in range(rows or max(1, max(pair_threads, _LOSS_PIXELS) // region_w), 0, -1):
                threads = max(-(-r * region_w // 32) * 32, pair_threads)
                smem, ds = loss_smem((ty, tx), r, region_w, C, elt)
                if threads <= MAX_THREADS_LOSS and smem <= lim:
                    best = ((ty, tx), r, region_w, threads, smem, ds, ry, rx)
                    break
            if best:
                break
        if best:
            break
    if best is None:
        raise ValueError(f"K7b: no tile fits {C} classes at {hl}x{wl} -> {H}x{W}")
    (ty, tx), r, region_w, threads, smem, ds, ry, rx = best
    t = _Table()
    offs = (t.add(_quads(*axis_taps(hl, H))), t.add(_quads(*axis_taps(wl, W))),
            t.add(ry), t.add(rx))
    lo, n, off, wts = footprints(wl, W)
    offs += (t.add(_quads(lo, n, off)), t.add(wts))
    computed = float(((ry[:, 1] - ry[:, 0] + 1).clip(min=0)).sum()
                     * ((rx[:, 1] - rx[:, 0] + 1).clip(min=0)).sum())
    return LossBwdGeometry((ty, tx), r, region_w, threads, smem, ds, computed / (H * W),
                           t.array(), offs)


_GEOMETRY = {"sum_fwd": sum_fwd_geometry, "sum": sum_bwd_geometry, "loss": loss_bwd_geometry}


@functools.lru_cache(maxsize=64)
def _cached(kind: str, key: tuple, device: str):
    geo = _GEOMETRY[kind](*key)
    return geo, torch.from_numpy(geo.table).to(device)


def device_tables(kind: str, key: tuple, device):
    """(geometry, its table on ``device``), built and copied once per
    ``kind`` ("sum_fwd": ``sum_fwd_geometry(*key)``, "sum":
    ``sum_bwd_geometry(*key)``, "loss": ``loss_bwd_geometry(*key)``) and
    shape."""
    return _cached(kind, key, str(device))
