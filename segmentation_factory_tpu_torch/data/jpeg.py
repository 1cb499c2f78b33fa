"""JPEG files without PIL: the host engine's decoder (``csrc/jpeg_decode.cpp``).

The port's counterpart of the JAX package's PIL calls on JPEG files
(``Image.open(path)``, ``.convert("RGB")``; JAX ``data/datasets.py``,
``predict.py``). VOC's, ADE20K's, COCO-Stuff's and Kvasir-SEG's images and
Kvasir-SEG's masks are JPEG. PIL decodes them with libjpeg-turbo at
libjpeg's defaults, and the decoder gives the same bytes: baseline,
extended and progressive Huffman files, restart intervals, the accurate
integer IDCT, fancy upsampling of chroma and libjpeg's YCbCr -> RGB. EXIF
orientation and ICC profiles are ignored, as ``Image.open`` ignores them.

- ``read_jpeg`` gives the samples as ``np.asarray(Image.open(path))`` does:
  (H, W) uint8 for a one-component file, (H, W, 3) for a three-component
  one.
- ``read_rgb`` gives them as ``Image.open(path).convert("RGB")`` does: grey
  repeated.

4-component (CMYK / YCCK), arithmetic-coded, 12-bit, lossless and
hierarchical files, DNL, sampling ratios other than 1x1, 2x1, 1x2 and 2x2
and progressive files
that would need libjpeg's block smoothing raise ``NotImplementedError``
naming the feature; a truncated or corrupt file raises ``ValueError``, and
no partial image is returned.
"""

from __future__ import annotations

import ctypes

import numpy as np

from segmentation_factory_tpu_torch.data import native

SIGNATURE = b"\xff\xd8\xff"
_ERRORS = {1: NotImplementedError, 2: ValueError}


def _raise(status: int, err, where: str) -> None:
    if status:
        raise _ERRORS[status](f"{where}: {err.value.decode('utf-8', 'replace')}")


def decode(data: bytes, where: str = "JPEG data") -> np.ndarray:
    """The (H, W, components) uint8 samples of the JPEG file ``data``;
    ``where`` names it in an error."""
    eng = native.lib()
    err = ctypes.create_string_buffer(256)
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _raise(eng.sft_jpeg_header(data, len(data), h, w, c, err, len(err)), err, where)
    out = np.empty((h.value, w.value, c.value), np.uint8)
    u8 = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    _raise(eng.sft_jpeg_decode(data, len(data), u8, err, len(err)), err, where)
    return out


def read_jpeg(path: str) -> np.ndarray:
    """The samples of the JPEG at ``path``, as ``np.asarray(Image.open(path))``
    gives them: (H, W) uint8 for a one-component file, (H, W, 3) for a
    three-component one."""
    with open(path, "rb") as f:
        img = decode(f.read(), path)
    return img[..., 0] if img.shape[2] == 1 else img


def read_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of the JPEG at ``path``, as PIL's
    ``Image.open(path).convert("RGB")`` gives it: grey repeated."""
    with open(path, "rb") as f:
        img = decode(f.read(), path)
    return np.repeat(img, 3, axis=-1) if img.shape[2] == 1 else img
