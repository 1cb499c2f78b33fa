"""PNG files without PIL: a decoder and an encoder on ``zlib`` and numpy.

The port's counterpart of the JAX package's PIL calls on image files
(``Image.open(path)``, ``.convert("RGB")``, ``Image.fromarray(a).save(path)``;
JAX ``predict.py``, ``data/datasets.py``). The machine with the card has no
PIL. Cityscapes' ``leftImg8bit`` images and every dataset's label maps are
PNG, so PNG covers config #5's inputs.

- ``read_png`` decodes 8-bit, non-interlaced files of colour types 0 (grey),
  2 (RGB), 3 (palette: the indices, as PIL's mode "P" gives them) and 6
  (RGBA), with every row filter of the format. The filters chain each pixel
  to its left, upper and upper-left neighbours, so the decoder undoes them
  one anti-diagonal of pixels at a time, every row's filter applied to its
  own pixels on the diagonal.
- ``read_rgb`` is ``read_png`` followed by PIL's ``convert("RGB")``: grey
  repeated, the palette looked up, alpha dropped.
- ``write_png`` encodes (H, W) grey or (H, W, 3) RGB uint8, rows unfiltered.

Anything else (16-bit or sub-byte samples, interlacing, grey + alpha, JPEG,
BMP) raises ``NotImplementedError``: the JPEG decoder is the next slice
of the host engine (ROADMAP Queue 1 item 4b).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 6: 4}
_UNPORTED = "is not ported (the file-backed datasets' decoders, ROADMAP Queue 1 item 4b)"


def _chunks(data: bytes) -> Dict[str, List[bytes]]:
    if not data.startswith(SIGNATURE):
        raise NotImplementedError(f"a file that is not a PNG {_UNPORTED}")
    out: Dict[str, List[bytes]] = {}
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        out.setdefault(kind.decode("latin-1"), []).append(body)
        pos += 12 + length
        if kind == b"IEND":
            break
    return out


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the row filters of ``raw`` (h rows of a filter byte and w * bpp
    filtered bytes): the reconstructed (h, w, bpp) uint8 samples. Pixel
    (r, x) needs (r, x - 1), (r - 1, x) and (r - 1, x - 1), all on earlier
    anti-diagonals r + x, so each diagonal is one vector step."""
    rows = raw.reshape(h, 1 + w * bpp)
    kinds = rows[:, 0].astype(np.int64)
    if kinds.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {int(kinds.max())} is not one of the format's five")
    filt = rows[:, 1:].reshape(h, w, bpp).astype(np.int32)
    out = np.zeros((h + 1, w + 1, bpp), np.int32)  # a zero row and column in front
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - r
        a, b, c = out[r + 1, x], out[r, x + 1], out[r, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.stack([np.zeros_like(a), a, b, (a + b) >> 1, paeth])
        kind = kinds[r][None, :, None]
        out[r + 1, x + 1] = (filt[r, x] + np.take_along_axis(pred, kind, 0)[0]) & 255
    return out[1:, 1:].astype(np.uint8)


def _decode(path: str):
    """(samples (H, W, channels) uint8, colour type, chunks) of the PNG at
    ``path``."""
    with open(path, "rb") as f:
        chunks = _chunks(f.read())
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", chunks["IHDR"][0])
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise NotImplementedError(
            f"{path}: a PNG of bit depth {depth}, colour type {ctype}"
            f"{', interlaced' if interlace else ''} {_UNPORTED}; 8-bit, non-interlaced "
            "grey, RGB, palette and RGBA files are read")
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(chunks["IDAT"])), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected {h * (1 + w * bpp)}")
    return _unfilter(raw, h, w, bpp), ctype, chunks


def read_png(path: str) -> np.ndarray:
    """The samples of the PNG at ``path``, as ``np.asarray(Image.open(path))``
    gives them: (H, W) uint8 for grey and for palette indices, (H, W, 3)
    for RGB, (H, W, 4) for RGBA."""
    img = _decode(path)[0]
    return img[..., 0] if img.shape[2] == 1 else img


def read_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of the PNG at ``path``, as PIL's
    ``Image.open(path).convert("RGB")`` gives it: grey repeated, the
    palette looked up (black past its last entry), alpha dropped."""
    img, ctype, chunks = _decode(path)
    if ctype == 3:
        entries = np.frombuffer(chunks["PLTE"][0], np.uint8).reshape(-1, 3)
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(entries)] = entries
        return lut[img[..., 0]]
    if ctype == 0:
        return np.repeat(img, 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(path: str, image: np.ndarray) -> None:
    """Write (H, W) grey or (H, W, 3) RGB uint8 ``image`` as an 8-bit PNG."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or not (image.ndim == 2 or (image.ndim == 3
                                                          and image.shape[2] == 3)):
        raise ValueError(f"expected (H, W) or (H, W, 3) uint8, got {image.shape} {image.dtype}")
    h, w = image.shape[:2]
    ctype = 0 if image.ndim == 2 else 2
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, -1)], axis=1)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))
