"""Palettes and class-name labels for label maps: the port's copy of
``segmentation_factory_tpu/data/visualize.py`` ``random_palette`` (:17-19)
and ``draw_class_names`` (:63-86).

``draw_class_names`` keeps the JAX function's rule (each class of at least
``min_area`` pixels named at the integer centroid of its pixels, a black
copy one pixel down and right, then the white text) and draws without PIL,
with a 5 x 7 bitmap font carried here (the HD44780 character ROM's
glyphs: lower case, digits and ``-_.,/()'&:``; upper case is drawn in lower
case, other characters as blanks). The glyphs differ from PIL's default
font, so the stamped pixels do too.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def random_palette(num_classes: int, seed: int = 0) -> np.ndarray:
    """(num_classes, 3) uint8 colours drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, (num_classes, 3)).astype(np.uint8)


# each glyph's 7 rows of 5 pixels, a hex byte a row, the leftmost pixel bit 4
_GLYPHS = {
    "0": "0e11131519110e", "1": "040c040404040e", "2": "0e11010204081f", "3": "1f02040201110e",
    "4": "02060a121f0202", "5": "1f101e0101110e", "6": "0608101e11110e", "7": "1f010204080808",
    "8": "0e11110e11110e", "9": "0e11110f01020c", "a": "00000e010f110f", "b": "1010161911111e",
    "c": "00000e1010110e", "d": "01010d1311110f", "e": "00000e111f100e", "f": "0609081c080808",
    "g": "000f11110f010e", "h": "10101619111111", "i": "04000c0404040e", "j": "0200060202120c",
    "k": "10101214181412", "l": "0c04040404040e", "m": "00001a15151111", "n": "00001619111111",
    "o": "00000e1111110e", "p": "00001e111e1010", "q": "00000d130f0101", "r": "00001619101010",
    "s": "00000e100e011e", "t": "08081c08080906", "u": "0000111111130d", "v": "00001111110a04",
    "w": "0000111115150a", "x": "0000110a040a11", "y": "000011110f010e", "z": "00001f0204081f",
    "-": "0000001f000000", "_": "0000000000001f", ".": "00000000000c0c", ",": "000000000c0408",
    "/": "00010204081000", "(": "02040808080402", ")": "08040202020408", "'": "0c040800000000",
    "&": "0c12140815120d", ":": "000c0c000c0c00",
}
GLYPH_H, GLYPH_W = 7, 5
ADVANCE = GLYPH_W + 1  # a blank column between characters


def text_mask(text: str) -> np.ndarray:
    """(7, 6 * len(text) - 1) bool pixels of ``text`` in the bitmap font."""
    out = np.zeros((GLYPH_H, max(ADVANCE * len(text) - 1, 0)), bool)
    for i, ch in enumerate(text.lower()):
        rows = _GLYPHS.get(ch)
        if rows is None:
            continue
        bits = np.array([int(rows[2 * r:2 * r + 2], 16) for r in range(GLYPH_H)])
        out[:, i * ADVANCE:i * ADVANCE + GLYPH_W] = (bits[:, None] >> np.arange(4, -1, -1)) & 1
    return out


def _stamp(img: np.ndarray, mask: np.ndarray, y: int, x: int, value: int) -> None:
    """Set ``img``'s pixels under ``mask`` placed at (y, x) to ``value``,
    clipped to the image."""
    h, w = img.shape[:2]
    y0, x0 = max(y, 0), max(x, 0)
    y1, x1 = min(y + mask.shape[0], h), min(x + mask.shape[1], w)
    if y1 <= y0 or x1 <= x0:
        return
    img[y0:y1, x0:x1][mask[y0 - y:y1 - y, x0 - x:x1 - x]] = value


def draw_class_names(overlay_rgb: np.ndarray, seg: np.ndarray, class_names: Sequence[str],
                     min_area: int = 400) -> np.ndarray:
    """A copy of ``overlay_rgb`` (H, W, 3) uint8 with the name of every
    class of ``seg`` (H, W) that covers at least ``min_area`` pixels at the
    integer centroid of its pixels (the text's top left), in white over a
    black copy one pixel down and right."""
    img = np.array(overlay_rgb, np.uint8, copy=True)
    for cls in np.unique(seg):
        if cls < 0 or cls >= len(class_names):
            continue
        ys, xs = np.nonzero(seg == cls)
        if len(ys) < min_area:
            continue
        cy, cx = int(ys.mean()), int(xs.mean())
        mask = text_mask(class_names[int(cls)])
        _stamp(img, mask, cy + 1, cx + 1, 0)
        _stamp(img, mask, cy, cx, 255)
    return img
