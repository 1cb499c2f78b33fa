"""The front end that the loss forward K7f and the upsample-argmax K8 share
(``ops/transpose_geometry.py`` ``lowres_fwd_geometry``,
``ops/csrc/lowres_rows.cuh``) and K7f's reductions, on the CPU.

The geometry is checked for covering every fine pixel once, for staging
every tap a block samples, and for its shared memory. The kernels' blocking
is mirrored in numpy from the same tables, block by block and row by row as
``csrc/lowres_rows.cuh`` walks them: source rows into the ring's slots in
the order they are asked for, each checked to be in its slot and to have
landed (its cp.async group waited for) when read and never overwritten
while a row still reads it; one V row a fine row; each pixel's two
columns. Every product and sum is rounded in float32 as the kernels round
it, and the mirror's logits equal the port's ``resize`` bit for bit, so its
labels equal ``resize_argmax_plain``'s. K7f's sums are mirrored in their
order (each thread's, or each lane's above 32 classes, over the band; each
block's rows by one warp; each image's blocks by the finishing kernel) and
held against ``lowres_loss_plain`` (1e-5 of the largest entry: the mirror
takes its exponentials in float64), against K7f's plain launches
(``fwd_blocks_plain``, ``fwd_finish_plain``) and against the JAX package's
Pallas forward and argmax in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from segmentation_factory_tpu.ops import pallas_loss as JL
from segmentation_factory_tpu_torch.models.layers.common import resize
from segmentation_factory_tpu_torch.ops import lowres_loss, resize_argmax
from segmentation_factory_tpu_torch.ops import transpose_geometry as TG

from _torch_port import two_torch_threads  # noqa: F401  (autouse)

REL = 1e-5
IGNORE = 255

# (B, hl, wl, C, H, W): the main path, then chip_smoke.py's K7B_SHAPES
# (config #1, config #4, a ratio that does not divide, ADE20K's 150
# classes, edge tiles), then small and downsampling cases
MAIN = (2, 256, 256, 19, 1024, 1024)
CONFIG_SHAPES = [MAIN, (16, 128, 128, 21, 512, 512), (24, 56, 56, 9, 224, 224),
                 (2, 63, 47, 19, 250, 190), (2, 32, 32, 150, 128, 128),
                 (2, 40, 37, 19, 160, 148)]
SMALL_SHAPES = [(2, 8, 8, 19, 32, 32), (2, 5, 7, 19, 13, 17), (1, 4, 4, 40, 16, 16),
                (1, 30, 10, 19, 7, 20), (2, 1, 3, 2, 5, 9), (1, 6, 5, 150, 24, 20),
                (2, 15, 11, 21, 60, 44), (1, 14, 14, 9, 56, 56), (1, 8, 8, 19, 8, 8)]


def _tables(geo, kernel, H, W):
    tab = geo.table
    o_rows, o_cols = geo.offsets
    lay = getattr(geo, kernel)
    rq = tab[o_rows:o_rows + 4 * H].reshape(H, 4)
    cq = tab[o_cols:o_cols + 4 * W].reshape(W, 4)
    bands = tab[lay.bands_at:lay.bands_at + 4 * lay.bands].reshape(-1, 4)
    spans = tab[lay.spans_at:lay.spans_at + 2 * lay.spans].reshape(-1, 2)
    return rq, cq, bands, spans, lay


# the card's resident blocks (K7f's, K8's) for the one-wave split: the main
# path's 3 blocks an SM on 132 SMs
SLOTS = (396, 396)


@pytest.mark.parametrize("one_wave", [False, True])
@pytest.mark.parametrize("kernel", ["loss", "argmax"])
@pytest.mark.parametrize("shape", CONFIG_SHAPES + SMALL_SHAPES)
def test_geometry_covers_every_pixel_and_tap(shape, kernel, one_wave):
    b, hl, wl, c, H, W = shape
    kw = {"batch": b, "slots": SLOTS} if one_wave else {}
    geo = TG.lowres_fwd_geometry(hl, wl, H, W, c, 4, **kw)
    rq, cq, bands, spans, lay = _tables(geo, kernel, H, W)
    np.testing.assert_array_equal(rq, TG.tap_quads(hl, H))
    np.testing.assert_array_equal(cq, TG.tap_quads(wl, W))
    covered = np.zeros((H, W), np.int64)
    heights = bands[:, 1] - bands[:, 0]
    assert heights.max() == lay.rows and heights.max() - heights.min() <= 1
    if one_wave:  # every block of the batch resident at once, bands of 4 rows or more
        assert b * lay.bands * lay.spans <= SLOTS[0] or lay.bands == 1
        assert heights.min() >= min(H, TG.LOWF_MIN_ROWS)
    for k in range(lay.bands):
        y0, y1, ya, yb = bands[k]
        assert ya == rq[y0, 0] and yb == rq[y1 - 1, 1]
        assert rq[y0:y1, :2].min() >= ya and rq[y0:y1, :2].max() <= yb
        for j in range(lay.spans):
            x0, x1 = j * lay.cols, min(j * lay.cols + lay.cols, W)
            xa, xb = spans[j]
            assert cq[x0:x1, :2].min() >= xa and cq[x0:x1, :2].max() <= xb
            assert xb - xa + 1 <= lay.wmax
            covered[y0:y1, x0:x1] += 1
    assert (covered == 1).all()
    assert lay.cols == lay.threads * lay.pixels and lay.threads % 32 == 0
    assert geo.cstride % 2 == 1 and geo.cstride >= c
    # pixel pairs (2k, 2k + 1) that sample the same two columns, everywhere
    x = np.arange(0, W - 1, 2)
    assert geo.pairs == bool((cq[x, :2] == cq[x + 1, :2]).all())


@pytest.mark.parametrize("shape", CONFIG_SHAPES)
def test_geometry_shared_memory(shape):
    """Every layout fits the card; up to 32 classes two blocks an SM (the
    soft limit); ADE20K's 150 classes fit under the card's limit."""
    _, hl, wl, c, H, W = shape
    geo = TG.lowres_fwd_geometry(hl, wl, H, W, c, 4)
    for lay, kernel in ((geo.loss, "loss"), (geo.argmax, "argmax")):
        assert lay.smem == TG.lowres_fwd_smem(lay.wmax, geo.cstride, c, lay.threads, lay.pixels,
                                              kernel, geo.ring)
        assert lay.smem <= TG.SMEM_MAX
        if c <= TG.LOWF_LANE_CLASSES:
            assert 2 * (lay.smem + 1024) <= 228 * 1024
    for c32 in (2, 9, 19, 21, 32):
        geo = TG.lowres_fwd_geometry(hl, wl, H, W, c32, 4)
        assert max(geo.loss.smem, geo.argmax.smem) <= 100 * 1024


def test_geometry_main_path():
    """The main path: spans of 512 fine columns (128 threads of 4 pixels),
    129 source columns a span, K7f and K8 alike; on the card (3 blocks an
    SM on 132 SMs, batch 2) 99 bands of 10 or 11 fine rows, 396 blocks in
    one wave (at least two for each SM), the source elements staged 1.68
    times (a band's 2.6 rows and its halo); without the card's count,
    bands of 8 rows."""
    geo = TG.lowres_fwd_geometry(256, 256, 1024, 1024, 19, 4, batch=2, slots=SLOTS)
    assert (geo.cstride, geo.ring, geo.pairs) == (19, 3, True)
    for lay in (geo.loss, geo.argmax):
        assert (lay.threads, lay.pixels, lay.cols, lay.spans, lay.wmax) == (128, 4, 512, 2, 129)
        assert (lay.bands, lay.rows) == (99, 11) and 2 * lay.bands * lay.spans == 396
    assert geo.loss.smem == geo.argmax.smem == 5 * 2452 * 4
    assert geo.read_factor == pytest.approx(1.681, abs=0.001)
    cpu = TG.lowres_fwd_geometry(256, 256, 1024, 1024, 19, 4)
    assert (cpu.loss.bands, cpu.loss.rows) == (128, 8)
    ade = TG.lowres_fwd_geometry(128, 128, 512, 512, 150, 4)
    assert ade.loss.pixels == 1 and ade.loss.smem <= TG.SMEM_MAX


# ---------------------------------------------------------------- the mirror


def _f32(q):
    return q.copy().view(np.float32)


def _front_mirror(lo, H, W, kernel, **kw):
    """The front end's walk in numpy float32: yields (b, band, span, Y,
    columns [x0, x1), logits (x1 - x0, C)) for every fine row of every
    block, the ring checked as the kernel fills and reads it: rows asked for
    two fine rows ahead, one cp.async group a fine row (two before the
    first), each barrier waiting for all but the last group, a fine row's V
    row built in the phase before its pixels."""
    bsz, hl, wl, c = lo.shape
    geo = TG.lowres_fwd_geometry(hl, wl, H, W, c, 4, **kw)
    rq, cq, bands, spans, lay = _tables(geo, kernel, H, W)
    assert geo.ring == (3 if 2 * hl <= H else 4 if hl <= H else 6)
    for b in range(bsz):
        for k in range(lay.bands):
            y0, y1 = bands[k, :2]
            for j in range(lay.spans):
                x0, x1 = j * lay.cols, min(j * lay.cols + lay.cols, W)
                xa, xb = spans[j]
                ring = {}  # slot -> (source row, cp.async group, its staged columns)
                state = {"next": 0, "last": -1, "slots": [0, 0]}  # slots: prev, last

                def ask(y, group, reading):
                    """Fine row y's new rows into the next slots, in turn; its rows' slots."""
                    tap = rq[y]
                    for r in (tap[0], tap[1]):
                        if r > state["last"]:
                            slot = state["next"]
                            assert slot not in ring or ring[slot][0] not in reading, (
                                "a row still to be read is overwritten", y, r)
                            ring[slot] = (r, group, lo[b, r, xa:xb + 1].copy())
                            state["slots"] = [state["slots"][1], slot]
                            state["next"] = (slot + 1) % geo.ring
                            state["last"] = r
                    prev, last = state["slots"]
                    return (prev if tap[1] != tap[0] else last), last

                def vrow(y, slots, done):
                    tap = rq[y]
                    for slot, r in zip(slots, tap[:2]):
                        row, grp, _ = ring[slot]
                        assert row == r and grp <= done, (y, r, row, grp, done)
                    a, bw = _f32(tap[2:3])[0], _f32(tap[3:4])[0]
                    # each product and the sum rounded
                    return ring[slots[0]][2] * a + ring[slots[1]][2] * bw

                rows_of = lambda y: set(rq[y, :2]) if y < y1 else set()  # noqa: E731
                slots = {y0: ask(y0, 0, ())}
                if y0 + 1 < y1:
                    slots[y0 + 1] = ask(y0 + 1, 1, ())
                vbuf = {y0 & 1: (y0, vrow(y0, slots[y0], 0))}  # the wait leaves group 1 in flight
                group = 1
                for y in range(y0, y1):
                    group += 1
                    if y + 2 < y1:  # a slow thread may still build y's V row
                        slots[y + 2] = ask(y + 2, group, rows_of(y) | rows_of(y + 1))
                    done = group - 1  # cp.async.wait_group 1, then the barrier
                    if y + 1 < y1:  # into the V row that y - 1's pixels read
                        vbuf[(y + 1) & 1] = (y + 1, vrow(y + 1, slots[y + 1], done))
                    q = cq[x0:x1]
                    ca, cb = _f32(q[:, 2])[:, None], _f32(q[:, 3])[:, None]
                    row, vy = vbuf[y & 1]
                    assert row == y, (y, row)
                    yield b, k, j, y, x0, x1, vy[q[:, 0] - xa] * ca + vy[q[:, 1] - xa] * cb


def _mirror_logits(lo, H, W, kernel="argmax", **kw):
    out = np.zeros((lo.shape[0], H, W, lo.shape[-1]), np.float32)
    writes = np.zeros(out.shape[:3], np.int64)
    for b, _, _, y, x0, x1, hi in _front_mirror(lo, H, W, kernel, **kw):
        out[b, y, x0:x1] = hi
        writes[b, y, x0:x1] += 1
    return out, writes


def _lo(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    lo = (rng.normal(size=shape[:4]) * 2).astype(np.float32)
    if dtype == "bf16":  # bf16-valued logits, staged as float32 as the kernels stage them
        lo = torch.from_numpy(lo).to(torch.bfloat16).float().numpy()
    return lo


@pytest.mark.parametrize("one_wave", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
@pytest.mark.parametrize("shape", SMALL_SHAPES + [(2, 63, 47, 19, 250, 190),
                                                  (2, 40, 37, 19, 160, 148)])
def test_front_mirror_equals_resize_and_argmax(shape, dtype, one_wave):
    lo = _lo(shape, 50, dtype)
    kw = {"batch": shape[0], "slots": SLOTS} if one_wave else {}
    got, writes = _mirror_logits(lo, *shape[4:], **kw)
    assert (writes == 1).all()
    want = resize(torch.from_numpy(lo), shape[4:]).numpy()
    np.testing.assert_array_equal(got, want)
    labels = got.argmax(-1).astype(np.int32)  # numpy's argmax: the first index on ties
    np.testing.assert_array_equal(
        labels, resize_argmax.resize_argmax_plain(torch.from_numpy(lo), shape[4:]).numpy())


def test_front_mirror_at_the_main_path_ratio():
    """The main path's geometry (spans of 512 columns, bands of 10 or 11
    rows) at its ratio, on 64 fine rows of one image."""
    lo = _lo((1, 16, 256, 19), 51)
    got, writes = _mirror_logits(lo, 64, 1024, batch=2, slots=(24, 24))
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, resize(torch.from_numpy(lo), (64, 1024)).numpy())


def test_front_mirror_matches_pallas_argmax():
    lo = _lo((1, 8, 128, 19), 52)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JL.resize_argmax_to(jnp.asarray(lo), (32, 512), use_pallas=True))
    got, _ = _mirror_logits(lo, 32, 512)
    up = np.sort(got, -1)
    clear = (up[..., -1] - up[..., -2]) > 1e-5  # the TPU kernel sums in another order
    np.testing.assert_array_equal(got.argmax(-1)[clear], want[clear])
    assert clear.mean() > 0.99


# ------------------------------------------------------------- K7f's sums


def _tree(v):
    """A warp's xor-shuffle sum (common.cuh warp_sum): lane 0's value of
    the last axis' 32 lanes, float32."""
    v = v.astype(np.float32)
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ o]
    return v[..., 0]


def _lanes(entries):
    """``block_rows`` / the finishing kernel's sum of K entries (last
    axis): lane l sums entries l, l + 32, ... in order, then the tree."""
    k = entries.shape[-1]
    acc = np.zeros(entries.shape[:-1] + (32,), np.float32)
    for i in range(0, k, 32):
        part = entries[..., i:i + 32].astype(np.float32)
        acc[..., :part.shape[-1]] += part
    return _tree(acc)


def _loss_mirror(lo, lab, ignore=IGNORE, **kw):
    """K7f in numpy: the loss map and the (B, 3 C, blocks) partials, each
    block's sums in the kernel's order, then the finish's."""
    bsz, hl, wl, c = lo.shape
    H, W = lab.shape[1:]
    geo = TG.lowres_fwd_geometry(hl, wl, H, W, c, 4, **kw)
    lay = geo.loss
    lanes = lay.pixels == 1
    nw = lay.threads // 32
    nblk = lay.bands * lay.spans
    loss = np.zeros((bsz, H, W), np.float32)
    partial = np.zeros((bsz, 3 * c, nblk), np.float32)
    # per block: each thread's sums (thread mode: classes x threads) or
    # each warp's (lane mode: classes x warps), in the order of its pixels
    acc = {}
    for b, k, j, y, x0, x1, hi in _front_mirror(lo, H, W, "loss", **kw):
        h64 = hi.astype(np.float64)
        m = h64.max(-1, keepdims=True)
        e = np.exp(h64 - m)
        se = e.sum(-1)
        labs = lab[b, y, x0:x1]
        valid = labs != ignore
        onehot = valid & (labs >= 0) & (labs < c)
        safe = np.where(onehot, labs, 0)
        vl = np.where(onehot, h64[np.arange(len(labs)), safe], 0.0)
        loss[b, y, x0:x1] = m[:, 0] + np.log(se) - vl
        p = (e / se[:, None] * valid[:, None]).astype(np.float32)
        y1h = np.zeros_like(p)
        y1h[np.arange(len(labs))[onehot], labs[onehot]] = 1
        terms = np.concatenate([p * y1h, p, y1h], -1)  # (pixels, 3 C)
        key = (b, k, j)
        if key not in acc:
            acc[key] = np.zeros((3 * c, nw if lanes else lay.threads), np.float32)
        idx = np.arange(x1 - x0)
        if lanes:  # warp w, pixel after pixel; its lanes over the classes
            for i in idx:
                acc[key][:, i // 32] += terms[i]
        else:  # thread t owns pixels 4 t .. 4 t + 3 of the row, in order
            for q in range(lay.pixels):
                sel = idx[idx % lay.pixels == q]
                acc[key][:, sel // lay.pixels] += terms[sel].T
    for (b, k, j), s in acc.items():
        partial[b, :, k * lay.spans + j] = _lanes(s)
    parts = _lanes(partial).reshape(bsz, 3, c)
    return loss, partial, parts


def _labels(shape, seed):
    b, _, _, c, H, W = shape
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, c, (b, H, W)).astype(np.int32)
    lab[:, :max(1, H // 8)] = IGNORE
    lab[-1, -(H // 4):, -(W // 3):] = IGNORE  # an all-void corner
    lab[0, -1, :3] = c + 2  # outside [0, C), not void: an all-zero one-hot row
    return lab


def _close(got, want, rel=REL):
    want = np.asarray(want)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("shape", SMALL_SHAPES + [(2, 63, 47, 19, 250, 190),
                                                  (1, 32, 32, 150, 128, 128),
                                                  (2, 40, 37, 19, 160, 148)])
def test_loss_mirror_matches_plain(shape):
    lo, lab = _lo(shape, 53), _labels(shape, 54)
    t_lo, t_lab = torch.from_numpy(lo), torch.from_numpy(lab)
    want_loss, want_parts = lowres_loss.lowres_loss_plain(t_lo, t_lab)
    # one wave's bands, as on the card
    loss, _, parts = _loss_mirror(lo, lab, batch=shape[0], slots=SLOTS)
    _close(loss, want_loss.numpy())
    _close(parts, want_parts.numpy())
    # the CPU's bands, those of the plain launches
    loss, partial, parts = _loss_mirror(lo, lab)
    _close(loss, want_loss.numpy())
    _close(parts, want_parts.numpy())
    # K7f's two launches, plain: the same blocks' partials, then their sum
    blocks_loss, blocks = lowres_loss.fwd_blocks(t_lo, t_lab)
    np.testing.assert_array_equal(blocks_loss.numpy(), want_loss.numpy())
    _close(partial, blocks.numpy())
    _close(lowres_loss.fwd_finish(blocks).numpy(), want_parts.numpy())
    assert lowres_loss.lowres_loss_fwd(t_lo, t_lab)[1].shape == (shape[0], 3, shape[3])


def test_loss_mirror_matches_pallas_forward():
    lo = _lo((1, 4, 128, 19), 55)
    lab = _labels((1, 4, 128, 19, 16, 512), 56)
    lo_t, lab_p = JL._prep(jnp.asarray(lo), jnp.asarray(lab), 4)
    with pltpu.force_tpu_interpret_mode():
        loss_map, parts = JL._forward(lo_t, lab_p, 4, IGNORE, JL._pick_tile(4, 4, 24, 128))
    loss_map = np.asarray(loss_map).transpose(0, 1, 3, 2).reshape(lab.shape)
    want_parts = np.asarray(parts)[:, :, :19].sum(-1)
    loss, _, got_parts = _loss_mirror(lo, lab)
    # the TPU kernel picks class 0's logit at void pixels and a padded
    # channel's -1e30 at a label outside [0, C)
    valid = (lab != IGNORE) & (lab < 19)
    _close(loss[valid], loss_map[valid])
    _close(got_parts, want_parts)
