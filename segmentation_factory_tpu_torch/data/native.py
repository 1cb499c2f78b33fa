"""The host engine (``csrc/transform_engine.cpp``, ``csrc/jpeg_decode.cpp``
and ``csrc/png_unfilter.cpp``), built by g++ at first use into one library
and loaded with ctypes: the Loader's scale-crop, the Synapse recipe's
rotation, PIL's bilinear, bicubic and nearest resizes, the JPEG decoder
(``data/jpeg.py``) and PNG's row filters (``data/png.py``).

The library goes to ``build/host_engine/libsft_transform-<hash>.so`` at the
root of the checkout; the hash covers every source and the flags, so an
edited source is rebuilt. The flags are the JAX package's own
(``segmentation_factory_tpu/native/__init__.py``), so both engines compute
the same bytes on one host. A failed build raises: the port has no PIL path
to fall back to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCES = tuple(Path(__file__).resolve().parent / "csrc" / name
                for name in ("transform_engine.cpp", "jpeg_decode.cpp", "png_unfilter.cpp"))
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host_engine"
FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-pthread")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
_U8 = ctypes.POINTER(ctypes.c_uint8)
_I32 = ctypes.POINTER(ctypes.c_int32)
_F32 = ctypes.POINTER(ctypes.c_float)
_INT = ctypes.c_int
_INTP = ctypes.POINTER(ctypes.c_int)


def _target() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsft_transform-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        res = subprocess.run(["g++", *FLAGS, *map(str, SOURCES), "-o", str(tmp)],
                             capture_output=True, text=True, timeout=300)
    except FileNotFoundError as exc:
        raise RuntimeError("g++ not found: the host transform engine cannot be built") from exc
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed for the host engine (exit {res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, out)


def lib() -> ctypes.CDLL:
    """The engine, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            out = _target()
            if not out.exists():
                _build(out)
            handle = ctypes.CDLL(str(out))
            handle.sft_batch_scale_crop.argtypes = [
                _U8, _I32, _INT, _INT, _INT, _F32, _I32, _I32, _INT, _INT, _U8, _I32, _INT]
            handle.sft_rotate_pair.argtypes = [_U8, _I32, _INT, _INT, ctypes.c_float, _INT, _INT,
                                               _INT, _U8, _I32]
            handle.sft_resize_bicubic_u8.argtypes = [_U8, _INT, _INT, _INT, _U8, _INT, _INT]
            handle.sft_resize_bilinear_pil_u8.argtypes = [_U8, _INT, _INT, _INT, _U8, _INT,
                                                          _INT]
            handle.sft_resize_nearest_pil_i32.argtypes = [_I32, _INT, _INT, _I32, _INT, _INT]
            for fn in (handle.sft_batch_scale_crop, handle.sft_rotate_pair,
                       handle.sft_resize_bicubic_u8, handle.sft_resize_bilinear_pil_u8,
                       handle.sft_resize_nearest_pil_i32):
                fn.restype = None
            handle.sft_jpeg_header.argtypes = [ctypes.c_char_p, ctypes.c_size_t, _INTP, _INTP,
                                               _INTP, ctypes.c_char_p, _INT]
            handle.sft_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, _U8,
                                               ctypes.c_char_p, _INT]
            handle.sft_jpeg_header.restype = handle.sft_jpeg_decode.restype = _INT
            handle.sft_png_unfilter.argtypes = [_U8, _INT, _INT, _INT, _U8]
            handle.sft_png_unfilter.restype = _INT
            _lib = handle
    return _lib


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def resize_image(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """(H, W, C) uint8 image resized to ``hw`` as PIL's ``Image.BILINEAR``
    resizes it, byte for byte (the triangle filter, antialiased when
    shrinking)."""
    return _resample(img, hw, "sft_resize_bilinear_pil_u8")


def resize_pair(img: np.ndarray, lbl: np.ndarray, hw: Tuple[int, int]):
    """(H, W, 3) uint8 image and (H, W) int32 label resized to ``hw`` as the
    JAX package's ``transforms.resize_pair`` resizes them with PIL: the
    image by ``Image.BILINEAR`` (``resize_image``), the label by
    ``Image.NEAREST`` (``resize_nearest_pil_i32``)."""
    if img.ndim != 3 or img.shape[:2] != lbl.shape:
        raise ValueError(f"image {img.shape} and label {lbl.shape} do not pair")
    return resize_image(img, hw), resize_nearest_pil_i32(lbl, hw)


def batch_scale_crop(imgs: np.ndarray, lbls: np.ndarray, scales: np.ndarray, tops: np.ndarray,
                     lefts: np.ndarray, crop: int, ignore_index: int = 255,
                     num_threads: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Each pair of (N, H, W, 3) uint8 ``imgs`` and (N, H, W) int32 ``lbls``
    scaled by ``scales[i]`` (bilinear image, nearest label), cropped to
    ``crop`` x ``crop`` at (``tops[i]``, ``lefts[i]``) of the scaled canvas
    and padded with 0 / ``ignore_index`` where the canvas is smaller."""
    imgs = np.ascontiguousarray(imgs, np.uint8)
    lbls = np.ascontiguousarray(lbls, np.int32)
    if imgs.ndim != 4 or imgs.shape[-1] != 3 or lbls.shape != imgs.shape[:3]:
        raise ValueError(f"images {imgs.shape} and labels {lbls.shape} do not pair")
    n, h, w, _ = imgs.shape
    scales = np.ascontiguousarray(scales, np.float32)
    tops = np.ascontiguousarray(tops, np.int32)
    lefts = np.ascontiguousarray(lefts, np.int32)
    if not scales.shape == tops.shape == lefts.shape == (n,):
        raise ValueError("one scale, top and left per sample")
    out_i = np.empty((n, crop, crop, 3), np.uint8)
    out_l = np.empty((n, crop, crop), np.int32)
    lib().sft_batch_scale_crop(_ptr(imgs, _U8), _ptr(lbls, _I32), n, h, w, _ptr(scales, _F32),
                               _ptr(tops, _I32), _ptr(lefts, _I32), crop, ignore_index,
                               _ptr(out_i, _U8), _ptr(out_l, _I32), num_threads)
    return out_i, out_l


def rotate_pair(img: np.ndarray, lbl: np.ndarray, angle_deg: float, nearest_img: bool = False,
                img_fill: int = 0, lbl_fill: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(H, W, 3) uint8 image and (H, W) int32 label rotated by
    ``angle_deg`` counter-clockwise about the centre, at the same size (PIL's
    ``rotate(expand=False)``): the label by nearest neighbour, the image
    bilinearly or, with ``nearest_img``, by nearest neighbour; pixels from
    outside take ``img_fill`` / ``lbl_fill``. The whole of the JAX engine's
    entry; the Synapse recipe uses it with ``nearest_img`` and zero fills."""
    img = np.ascontiguousarray(img, np.uint8)
    lbl = np.ascontiguousarray(lbl, np.int32)
    if img.ndim != 3 or img.shape[-1] != 3 or img.shape[:2] != lbl.shape:
        raise ValueError(f"image {img.shape} and label {lbl.shape} do not pair")
    h, w = lbl.shape
    out_i, out_l = np.empty_like(img), np.empty_like(lbl)
    lib().sft_rotate_pair(_ptr(img, _U8), _ptr(lbl, _I32), h, w, float(angle_deg),
                          int(nearest_img), int(img_fill), int(lbl_fill), _ptr(out_i, _U8),
                          _ptr(out_l, _I32))
    return out_i, out_l


def _resample(img: np.ndarray, hw: Tuple[int, int], entry: str) -> np.ndarray:
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3:
        raise ValueError(f"expected an (H, W, C) image, got {img.shape}")
    h, w, c = img.shape
    out = np.empty((hw[0], hw[1], c), np.uint8)
    getattr(lib(), entry)(_ptr(img, _U8), h, w, c, _ptr(out, _U8), hw[0], hw[1])
    return out


def resize_bicubic_u8(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """(H, W, C) uint8 image resized to ``hw`` as PIL's ``Image.BICUBIC``
    resizes it, byte for byte."""
    return _resample(img, hw, "sft_resize_bicubic_u8")


def resize_nearest_pil_i32(lbl: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """(H, W) int32 map resized to ``hw`` as PIL's ``Image.NEAREST`` resizes
    it (source index: the truncation of a position accumulated in double),
    which is not the train scale-crop's rule (``batch_scale_crop``)."""
    lbl = np.ascontiguousarray(lbl, np.int32)
    if lbl.ndim != 2:
        raise ValueError(f"expected an (H, W) map, got {lbl.shape}")
    out = np.empty(hw, np.int32)
    lib().sft_resize_nearest_pil_i32(_ptr(lbl, _I32), *lbl.shape, _ptr(out, _I32), *hw)
    return out
