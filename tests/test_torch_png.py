"""The port's data helpers that stand in for PIL and for the JAX package's
tables, on the CPU: the PNG codec (``data/png.py``) against PIL, the
class-name stamping (``data/visualize.py``) by its rule, and every
dataset's class names and palette against the JAX package's. All exact.
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from segmentation_factory_tpu.data import class_names as jax_class_names
from segmentation_factory_tpu.data import datasets as jax_datasets
from segmentation_factory_tpu.data.visualize import random_palette as jax_random_palette
from segmentation_factory_tpu_torch.data import png
from segmentation_factory_tpu_torch.data.datasets import DATASETS
from segmentation_factory_tpu_torch.data.visualize import ADVANCE, draw_class_names, text_mask


def _photo(h=37, w=53, seed=0):
    """Smooth gradients plus noise: PIL's adaptive filtering picks several
    row filters for it."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([3 * xx, 5 * yy, 2 * (xx + yy)], -1)
    img = img + np.random.default_rng(seed).integers(0, 12, (h, w, 3))
    return (img % 256).astype(np.uint8)


def _filters(path):
    """The row filter types of an 8-bit PNG."""
    data = open(path, "rb").read()
    w, h, _, ctype = struct.unpack(">IIBB", data[16:26])
    idat, pos = b"", 8
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(h, -1)[:, 0].tolist())


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "P"])
def test_read_png_written_by_pil(mode, tmp_path):
    img = Image.fromarray(_photo())
    img = img.quantize(60) if mode == "P" else img.convert(mode)
    path = tmp_path / f"{mode}.png"
    img.save(path, optimize=True)
    ref = Image.open(path)
    np.testing.assert_array_equal(png.read_png(str(path)), np.asarray(ref))
    np.testing.assert_array_equal(png.read_rgb(str(path)), np.asarray(ref.convert("RGB")))
    if mode == "RGB":
        assert len(_filters(path)) >= 3


def test_read_png_undoes_every_filter(tmp_path):
    """Rows filtered in turn by None, Sub, Up, Average and Paeth (the
    format's definitions, written out here) decode to the image."""
    img = _photo(23, 19, seed=1).astype(np.int32)
    h, w, bpp = img.shape
    left = np.concatenate([np.zeros((h, 1, bpp), np.int32), img[:, :-1]], axis=1)
    up = np.concatenate([np.zeros((1, w, bpp), np.int32), img[:-1]], axis=0)
    upleft = np.concatenate([np.zeros((h, 1, bpp), np.int32), up[:, :-1]], axis=1)
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = [np.zeros_like(img), left, up, (left + up) // 2, paeth]
    rows = [np.concatenate([[r % 5], ((img[r] - preds[r % 5][r]) % 256).ravel()])
            for r in range(h)]
    raw = np.stack(rows).astype(np.uint8).tobytes()
    path = tmp_path / "filters.png"
    chunk = lambda k, b: struct.pack(">I", len(b)) + k + b + struct.pack(  # noqa: E731
        ">I", zlib.crc32(k + b))
    path.write_bytes(png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    np.testing.assert_array_equal(png.read_png(str(path)), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


@pytest.mark.parametrize("channels", [1, 3])
def test_write_png_round_trips_through_pil(channels, tmp_path):
    img = _photo(31, 45, seed=2)
    img = img[..., 0] if channels == 1 else img
    path = tmp_path / "out.png"
    png.write_png(str(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(png.read_png(str(path)), img)


def _interlaced(tmp_path):
    path = tmp_path / "adam7.png"
    png.write_png(str(path), _photo())
    data = bytearray(path.read_bytes())
    data[28] = 1  # IHDR's interlace method, then the chunk's CRC again
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    path.write_bytes(bytes(data))
    return path


def _sixteen_bit(tmp_path):
    path = tmp_path / "deep.png"
    Image.fromarray((_photo()[..., 0].astype(np.uint16) * 257)).save(path)
    return path


def _jpeg(tmp_path):
    path = tmp_path / "photo.jpg"
    Image.fromarray(_photo()).save(path)
    return path


@pytest.mark.parametrize("make", [_interlaced, _sixteen_bit, _jpeg],
                         ids=["interlaced", "16-bit", "jpeg"])
def test_unported_files_raise(make, tmp_path):
    with pytest.raises(NotImplementedError, match="not ported"):
        png.read_png(str(make(tmp_path)))


def test_draw_class_names_stamps_only_at_large_regions():
    seg = np.zeros((80, 200), np.int32)
    seg[10:40, 10:60] = 1    # 1500 pixels: named
    seg[50:60, 80:90] = 2    # 100 pixels: too small
    seg[70:80, 0:5] = 7      # no such class
    base = np.full((80, 200, 3), 128, np.uint8)
    names = ["background", "road", "car"]
    out = draw_class_names(base, seg, names, min_area=400)
    changed = np.argwhere((out != base).any(-1))
    boxes = []
    for cls in (0, 1):
        ys, xs = np.nonzero(seg == cls)
        cy, cx = int(ys.mean()), int(xs.mean())
        mask = text_mask(names[cls])
        boxes.append((cy, cx, cy + mask.shape[0] + 1, cx + mask.shape[1] + 1))
        np.testing.assert_array_equal(out[cy:cy + 7, cx:cx + mask.shape[1]][mask], 255)
    inside = np.zeros(len(changed), bool)
    for y0, x0, y1, x1 in boxes:
        inside |= ((changed[:, 0] >= y0) & (changed[:, 0] < y1) & (changed[:, 1] >= x0)
                   & (changed[:, 1] < x1))
    assert inside.all()
    assert set(np.unique(out[tuple(changed.T)])) <= {0, 255}
    assert text_mask("car").shape == (7, 3 * ADVANCE - 1)
    np.testing.assert_array_equal(base, 128)  # the input is not changed


JAX_META = {
    "cityscapes": (jax_datasets.Cityscapes.CLASSES, jax_datasets.Cityscapes.PALETTE),
    "voc": (jax_datasets.VOCSegmentation.CLASSES, jax_datasets.VOCSegmentation.PALETTE),
    "ade20k": (jax_class_names.ADE20K_CLASSES, jax_class_names.ADE20K_PALETTE),
    "cocostuff": (jax_class_names.COCOSTUFF_CLASSES, jax_class_names.COCOSTUFF_PALETTE),
    "kvasir": (jax_datasets.KvasirClinicDB.CLASSES, jax_datasets.KvasirClinicDB.PALETTE),
    # SynapseCT sets its palette in __init__ (datasets.py:420)
    "synapse": (jax_datasets.SynapseCT.CLASSES, jax_random_palette(9, seed=2)),
}


@pytest.mark.parametrize("name", sorted(JAX_META))
def test_class_names_and_palettes_match_jax(name):
    cls, n = DATASETS[name]
    classes, palette = JAX_META[name]
    assert tuple(cls.CLASSES) == tuple(classes) and len(classes) == n
    np.testing.assert_array_equal(cls.PALETTE, palette)
    assert cls.PALETTE.dtype == np.uint8 and cls.PALETTE.shape == (n, 3)
