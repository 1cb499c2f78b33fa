"""K9b's blocking (``ops/msdeform.py`` ``bwd_plan``) on the CPU.

The plan is the plain mirror of ``csrc/ms_deform_attn.cu``'s backward: a
block owns one (batch, head) and a tile of consecutive queries, and level
by level sums its in-bounds corners' d(value) rows in a shared-memory
window of their box when the box fits, else adds them straight into
d(value). ``ms_deform_attn_bwd_planned`` sums d(value) the plan's way;
it is held in float32 to ``ms_deform_attn_bwd_plain`` (1e-5 of the largest
entry: the same float32 rows added in another order), and every corner
inside its map must reach d(value) exactly once, through one route, and
none outside. d(loc), d(attn) and K9f's output do not depend on the plan
(K9f has no windows); ``test_torch_msdeform.py`` holds them.

Cases: scaled-down and ragged levels with offsets of up to 4 pixels (the
pixel decoder's at init) and up to 40 (boxes that outgrow the window),
head dims 8 to 256, a map taller than a window (a band of its rows), one
wider than a window and eight points (the straight route), and the chip
check's edge and far-outside points (``k9_inputs``).
"""

import numpy as np
import pytest
import torch

from segmentation_factory_tpu_torch.models.layers.msdeformattn import reference_point_grid
from segmentation_factory_tpu_torch.ops import msdeform

from _torch_port import two_torch_threads  # noqa: F401  (autouse)

REL = 1e-5

# (levels, batch, heads, head dim, points, offsets' reach in pixels); the
# queries are every pixel of every level, as the pixel decoder's
CASES = {
    "scaled_4px": (((4, 4), (8, 8), (16, 16)), 1, 2, 96, 4, 4),
    "ragged_4px": (((5, 7), (9, 11), (17, 19)), 2, 1, 32, 4, 4),
    "ragged_40px": (((7, 9), (13, 17), (25, 33)), 1, 1, 96, 4, 40),
    "d256_4px": (((4, 4), (8, 8), (16, 16)), 1, 1, 256, 4, 4),
    "scaled_40px_p3": (((4, 4), (8, 8), (16, 16)), 1, 1, 32, 3, 40),
    "band_40px": (((10, 10), (80, 80)), 1, 1, 32, 4, 40),
    "wide_map": (((1, 4200), (1, 600)), 1, 1, 8, 2, 4),
    "p8": (((4, 4), (8, 8)), 1, 2, 16, 8, 4),
}


def _inputs(levels, b, m, d, p, px, seed):
    """value, locations at every pixel centre plus offsets of up to ``px``
    pixels of each level, softmaxed weights, a cotangent; some queries on
    the maps' edges (0, 1) and some far outside (-2.5, 3.5)."""
    rng = np.random.default_rng(seed)
    s, n = sum(h * w for h, w in levels), len(levels)
    ref = reference_point_grid(levels).numpy()  # (S, L, 2)
    wh = np.array([[w, h] for h, w in levels], dtype=np.float32)
    off = rng.uniform(-px, px, size=(b, s, m, n, p, 2)).astype(np.float32) / wh[:, None]
    loc = (ref[None, :, None, :, None, :] + off).astype(np.float32)
    loc[:, ::29, :, :, 0] = 0.0
    loc[:, 1::29, :, :, 1] = 1.0
    loc[:, 2::61] = -2.5
    loc[:, 3::61] = 3.5
    logits = rng.normal(size=(b, s, m, n * p))
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    value = rng.normal(size=(b, s, m, d)).astype(np.float32)
    g = rng.normal(size=(b, s, m * d)).astype(np.float32)
    return [torch.from_numpy(a) for a in (value, loc, attn.reshape(b, s, m, n, p)
                                          .astype(np.float32), g)]


@pytest.fixture(scope="module")
def planned():
    out = {}
    for name, (levels, b, m, d, p, px) in CASES.items():
        value, loc, attn, g = _inputs(levels, b, m, d, p, px, seed=len(out) + 40)
        got, adds, plan = msdeform.ms_deform_attn_bwd_planned(value, levels, loc, attn, g)
        want = msdeform.ms_deform_attn_bwd_plain(value, levels, loc, attn, g)[0]
        out[name] = dict(levels=levels, loc=loc, d=d, got=got, want=want, adds=adds, plan=plan)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_planned_dvalue_matches_plain(planned, case):
    r = planned[case]
    want = r["want"].numpy()
    np.testing.assert_allclose(r["got"].numpy(), want, rtol=0, atol=REL * np.abs(want).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_inside_corner_reaches_dvalue_once(planned, case):
    """``adds`` is 1 for each corner inside its level's map and 0 outside;
    a corner that takes its block's window lies inside the window (its band
    of rows, its box's columns), and every window fits the capacity."""
    r = planned[case]
    loc, plan = r["loc"], r["plan"]
    qt, cap, _ = msdeform.window_geometry(r["d"])
    assert plan["queries"] == qt
    inside, via, xy, box = msdeform.plan_routes(plan, r["levels"], loc)
    assert torch.equal(r["adds"], inside.long())
    assert not bool((via & ~inside).any())
    x, y = xy[..., 0], xy[..., 1]
    within = (x >= box[..., 0]) & (x <= box[..., 2]) & (y >= box[..., 1]) & (y <= box[..., 3])
    assert bool((within | ~via).all())
    win, band = plan["windowed"], plan["window"]
    area = (band[..., 2] - band[..., 0] + 1) * (band[..., 3] - band[..., 1] + 1)
    assert bool(((area <= cap) & (area > 0) | ~win).all())


def test_cases_take_both_routes(planned):
    """Across the cases corners take both routes: at 4 pixels every row
    sums in a window; a map taller than a window at 40 pixels sums only a
    band of each block's rows there; a map wider than a window, or more
    than four points, sends every row of that level straight."""
    def share(name, lvl):
        r = planned[name]
        inside, via, _, _ = msdeform.plan_routes(r["plan"], r["levels"], r["loc"])
        return (via[:, :, :, lvl].sum() / inside[:, :, :, lvl].sum()).item()

    assert min(share("scaled_4px", lvl) for lvl in range(3)) == 1
    assert share("band_40px", 0) == 1 and 0 < share("band_40px", 1) < 1
    assert share("wide_map", 0) == 0 and share("wide_map", 1) == 1
    assert share("p8", 0) == share("p8", 1) == 0


def test_window_geometry_fits_shared_memory():
    """At every head dim the kernels take, a block has BWD_THREADS
    threads, whole queries of LANES' lanes, and its shared memory (g rows,
    window counts and listed pixels, corner lists) fits a block's 227 KB;
    a window lists fewer than 2^16 corners (the scan packs their count and
    the listed pixels' in one int)."""
    for d, (lp, _) in msdeform.LANES.items():
        qt, cap, smem = msdeform.window_geometry(d)
        assert qt * lp == msdeform.BWD_THREADS and cap == msdeform.WINDOW_PIXELS
        assert smem <= 227 * 1024 and qt * msdeform.GROUP * 4 < 2 ** 16
