"""The port's JPEG decoder (``data/jpeg.py``, the host engine's
``csrc/jpeg_decode.cpp``) and its copy of PIL's ``BILINEAR`` resize
(``native.resize_image``) against PIL, byte for byte (tolerance 0).

Every JPEG is written by PIL into ``tmp_path`` from a numpy seed: modes L
and RGB; subsampling 4:4:4, 4:2:2 and 4:2:0; quality 1, 50, 75, 95 and 100;
baseline, progressive, ``optimize``, ``restart_marker_blocks`` and
``restart_marker_rows``; sizes 1 x 1, 7 x 13, 16 x 16, 17 x 33 and 375 x
500; files with EXIF and ICC segments and Adobe's RGB marker; 4:4:0
(1x2 chroma) by patching a 4:2:2 file's frame header. What the decoder
does not port (a CMYK file, which PIL writes; 4:1:1) and broken files
(truncated, corrupt, a Huffman table with too many short codes) raise.
"""

import io

import numpy as np
import pytest
from PIL import Image

from segmentation_factory_tpu_torch.data import jpeg, native

SIZES = [(1, 1), (7, 13), (16, 16), (17, 33), (375, 500)]
QUALITIES = [1, 50, 75, 95, 100]
KINDS = {"L": ("L", None), "444": ("RGB", 0), "422": ("RGB", 1), "420": ("RGB", 2)}
ENCODINGS = {"baseline": {}, "progressive": {"progressive": True}, "optimize": {"optimize": True},
             "progressive_optimize": {"progressive": True, "optimize": True},
             "restart_blocks": {"restart_marker_blocks": 3},
             "restart_rows": {"restart_marker_rows": 1}}


def _photo(h, w, seed):
    """(h, w, 3) uint8: smooth colour fields, discs with edges, mild noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(xx / 9 + seed) * np.cos(yy / 13),
                    128 + 80 * np.cos(yy / 7 - seed), (3 * xx + 2 * yy) % 256], -1)
    for _ in range(3):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(2, 40)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.uniform(0, 255, 3)
    return np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)


def _write(path, img, mode="RGB", **opts):
    Image.fromarray(img if mode == "RGB" else img[..., 0]).save(path, "JPEG", **opts)
    return str(path)


def _equal_pil(path):
    want = np.asarray(Image.open(path))
    got = jpeg.read_jpeg(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    want_rgb = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(jpeg.read_rgb(path), want_rgb)


@pytest.mark.parametrize("encoding", sorted(ENCODINGS))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_decode_equals_pil(kind, encoding, tmp_path):
    """Every quality and size of one mode / subsampling and one encoding."""
    mode, subsampling = KINDS[kind]
    opts = dict(ENCODINGS[encoding])
    if subsampling is not None:
        opts["subsampling"] = subsampling
    for q in QUALITIES:
        for h, w in SIZES:
            path = _write(tmp_path / f"q{q}_{h}x{w}.jpg", _photo(h, w, q + h), mode,
                          quality=q, **opts)
            if "restart" in encoding:
                with open(path, "rb") as f:
                    assert b"\xff\xdd" in f.read()  # a DRI segment
            _equal_pil(path)


def test_exif_icc_comment_and_adobe_rgb(tmp_path):
    """EXIF (an orientation PIL's ``Image.open`` does not apply), an ICC
    profile over several APP2 segments and a comment are skipped; an Adobe
    marker with transform 0 (``keep_rgb``) means RGB samples."""
    img = _photo(120, 90, 7)
    exif = Image.Exif()
    exif[0x0112] = 6
    _equal_pil(_write(tmp_path / "exif.jpg", img, exif=exif.tobytes(),
                      icc_profile=bytes(range(256)) * 300, comment=b"fixture"))
    path = _write(tmp_path / "rgb.jpg", img, keep_rgb=True)
    with open(path, "rb") as f:
        assert b"Adobe" in f.read()
    _equal_pil(path)


def test_h1v2_equals_pil():
    """Chroma sampled 1x2 (4:4:0, which PIL cannot write): a 4:2:2 file
    with its luma factors patched from 2x1 to 1x2 and its sides swapped
    holds the same number of MCUs, so its entropy-coded data stays whole;
    libjpeg decodes it with h1v2_fancy_upsample."""
    for (h, w), quality in (((64, 48), 50), ((17, 33), 95), ((7, 13), 75), ((1, 1), 75),
                            ((375, 500), 90)):
        buf = io.BytesIO()
        Image.fromarray(_photo(h, w, 3)).save(buf, "JPEG", subsampling=1, quality=quality)
        data = bytearray(buf.getvalue())
        sof = data.index(b"\xff\xc0")
        assert data[sof + 11] == 0x21
        data[sof + 5:sof + 9] = data[sof + 7:sof + 9] + data[sof + 5:sof + 7]
        data[sof + 11] = 0x12
        want = np.asarray(Image.open(io.BytesIO(bytes(data))))
        assert want.shape == (w, h, 3)
        np.testing.assert_array_equal(jpeg.decode(bytes(data)), want)


def test_unported_and_broken_files_raise(tmp_path):
    img = _photo(64, 48, 1)
    cmyk = tmp_path / "cmyk.jpg"
    Image.fromarray(img).convert("CMYK").save(cmyk, "JPEG")
    assert Image.open(cmyk).mode == "CMYK"
    with pytest.raises(NotImplementedError, match="CMYK"):
        jpeg.read_jpeg(str(cmyk))
    _write(tmp_path / "good.jpg", img, quality=90)
    _write(tmp_path / "prog.jpg", img, progressive=True)
    good, prog = (tmp_path / "good.jpg").read_bytes(), (tmp_path / "prog.jpg").read_bytes()
    for name, data in (("half", good[:len(good) // 2]), ("no_eoi", good[:-2]),
                       ("header_only", good[:200]), ("progressive_half", prog[:len(prog) // 2])):
        path = tmp_path / f"{name}.jpg"
        path.write_bytes(data)
        with pytest.raises(OSError):  # PIL's refusal of the same file
            Image.open(path).load()
        with pytest.raises(ValueError, match="truncated"):
            jpeg.read_jpeg(str(path))
    # the entropy-coded data cut short by EOI: PIL warns and pads, the port raises
    sos = good.index(b"\xff\xda")
    short = good[:sos + 400] + b"\xff\xd9"
    (tmp_path / "short.jpg").write_bytes(short)
    with pytest.raises(ValueError, match="premature end"):
        jpeg.read_jpeg(str(tmp_path / "short.jpg"))
    # a progressive file that ends (EOI) before its refinement scans: PIL
    # decodes it with libjpeg's block smoothing, which the port refuses
    scans = [i for i in range(len(prog) - 1) if prog[i:i + 2] == b"\xff\xda"]
    (tmp_path / "partial.jpg").write_bytes(prog[:scans[5]] + b"\xff\xd9")
    Image.open(tmp_path / "partial.jpg").load()
    with pytest.raises(NotImplementedError, match="block smoothing"):
        jpeg.read_jpeg(str(tmp_path / "partial.jpg"))
    (tmp_path / "png.jpg").write_bytes(b"\x89PNG\r\n\x1a\n" + good)
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.read_jpeg(str(tmp_path / "png.jpg"))
    # a Huffman table with three codes of one bit (its count and the
    # segment's length unchanged): libjpeg's JERR_BAD_HUFF_TABLE
    dht = good.index(b"\xff\xc4") + 5  # the first table's 16 counts
    bits = list(good[dht:dht + 16])
    moved, i = 3 - bits[0], 15
    bits[0] = 3
    while moved:
        take = min(moved, bits[i])
        bits[i], moved, i = bits[i] - take, moved - take, i - 1
    (tmp_path / "huffman.jpg").write_bytes(good[:dht] + bytes(bits) + good[dht + 16:])
    with pytest.raises(OSError):
        Image.open(tmp_path / "huffman.jpg").load()
    with pytest.raises(ValueError, match="bad Huffman table"):
        jpeg.read_jpeg(str(tmp_path / "huffman.jpg"))
    # luma sampled 4x1 (4:1:1), which PIL cannot write: the SOF's first
    # component's factors patched
    sof = good.index(b"\xff\xc0") + 11
    (tmp_path / "411.jpg").write_bytes(good[:sof] + b"\x41" + good[sof + 1:])
    with pytest.raises(NotImplementedError, match="sampling ratio 4/1 x 1/1"):
        jpeg.read_jpeg(str(tmp_path / "411.jpg"))


# (source, destination) heights and widths: odd sizes, shrinking by 0.37-0.75
# (the eval loader's shrink of ADE20K-sized images to 512²) and enlarging
BILINEAR_SIZES = [((61, 47), (23, 31)), ((61, 47), (97, 130)), ((17, 33), (17, 8)),
                  ((512, 683), (383, 512)), ((1024, 768), (512, 384)), ((375, 500), (544, 736)),
                  ((1, 5), (3, 2)), ((40, 40), (40, 40))]


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("src,dst", BILINEAR_SIZES, ids=lambda s: "x".join(map(str, s)))
def test_bilinear_equals_pil(src, dst, channels):
    img = _photo(*src, seed=src[0] + dst[1])[..., :channels]
    pil = Image.fromarray(img[..., 0] if channels == 1 else img)
    want = np.asarray(pil.resize(dst[::-1], Image.BILINEAR)).reshape(*dst, channels)
    np.testing.assert_array_equal(native.resize_image(img, dst), want)


def test_resize_pair_is_the_jax_eval_shrink():
    """``native.resize_pair`` is JAX ``transforms.resize_pair``: PIL's
    bilinear image and nearest label."""
    from segmentation_factory_tpu.data.transforms import resize_pair as jax_resize_pair

    img = _photo(90, 121, 3)
    lbl = np.random.default_rng(3).integers(0, 151, (90, 121)).astype(np.int32)
    for hw in ((67, 90), (45, 60), (120, 161)):
        for got, want in zip(native.resize_pair(img, lbl, hw), jax_resize_pair(img, lbl, hw)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_decode_in_memory_matches_file(tmp_path):
    """``decode`` of a file's bytes is ``read_jpeg`` of the file."""
    path = _write(tmp_path / "a.jpg", _photo(30, 40, 2), progressive=True)
    with open(path, "rb") as f:
        np.testing.assert_array_equal(jpeg.decode(f.read()), jpeg.read_jpeg(path))
