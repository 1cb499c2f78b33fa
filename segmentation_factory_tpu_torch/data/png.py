"""PNG files without PIL: a decoder and an encoder on ``zlib``, numpy and the
host engine.

The port's counterpart of the JAX package's PIL calls on image files
(``Image.open(path)``, ``.convert("RGB")``, ``Image.fromarray(a).save(path)``;
JAX ``predict.py``, ``data/datasets.py``). The machine with the card has no
PIL. Cityscapes' ``leftImg8bit`` images and every dataset's label maps are
PNG, so PNG covers config #5's inputs.

- ``read_png`` decodes 8-bit, non-interlaced files of colour types 0 (grey),
  2 (RGB), 3 (palette: the indices, as PIL's mode "P" gives them) and 6
  (RGBA), with every row filter of the format. zlib inflates the stream;
  the filters, which chain each pixel to its left, upper and upper-left
  neighbours, are undone row by row in the host engine
  (``csrc/png_unfilter.cpp``), outside the interpreter's lock, so a
  Loader's threads read labels in parallel.
- ``read_rgb`` is ``read_png`` followed by PIL's ``convert("RGB")``: grey
  repeated, the palette looked up, alpha dropped.
- ``write_png`` encodes (H, W) grey or (H, W, 3) RGB uint8, rows unfiltered.

Anything else (16-bit or sub-byte samples, interlacing, grey + alpha, a
file that is not a PNG) raises ``NotImplementedError``; JPEG files are
``data/jpeg.py``'s, and ``data/datasets.py`` picks the reader by a file's
first bytes.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Dict, List

import numpy as np

from segmentation_factory_tpu_torch.data import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 6: 4}
_UNPORTED = "is not ported by the PNG reader"


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
    filtered bytes): the reconstructed (h, w, bpp) uint8 samples, by the
    host engine (``csrc/png_unfilter.cpp``)."""
    raw = np.ascontiguousarray(raw, np.uint8)
    out = np.empty((h, w, bpp), np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    bad = native.lib().sft_png_unfilter(raw.ctypes.data_as(u8), h, w, bpp, out.ctypes.data_as(u8))
    if bad:
        row = raw.reshape(h, 1 + w * bpp)[bad - 1, 0]
        raise ValueError(f"PNG row filter {int(row)} is not one of the format's five")
    return out


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
