#!/usr/bin/env python3
"""Write the port's file fixtures, ``tests/torch_fixtures/``, with PIL and h5py.

    python tools/torch_fixtures.py [--out tests/torch_fixtures]

Run on a machine with PIL and h5py (the machine with the card has neither).
Everything is made from numpy seeds; nothing is downloaded. It writes:

- seven JPEGs shaped like the pinned configs' files: a VOC-like 500 x 375
  4:2:0 q75 baseline, a 500 x 333 progressive + optimized file, an
  ADE20K-like 683 x 512 4:4:4 q90, a portrait 768 x 1024 4:2:2 with a
  restart marker every MCU row, a 640 x 480 greyscale (as some COCO images
  are), a Kvasir-like 622 x 529 image and its 3-component near-binary mask;
- ``case0001.npy.h5``, a small Synapse case ("image" float32 and "label"
  float32, (D, H, W)), as h5py writes it by default;
- ``manifest.json``: each JPEG's mode, shape and the sha256 of
  ``np.asarray(Image.open(path))``; the same for PIL's ``BILINEAR`` shrink of
  two of them (``Image.open(path).convert("RGB").resize``) to the sizes the
  eval loader shrinks them to on a 512² canvas; the same for h5py's read of
  each dataset of the case. The decoders of the port are held to these
  hashes (``tests/test_torch_fixtures.py`` here, ``chip_smoke.py`` phase
  ``files`` on the card).
"""

from __future__ import annotations

import argparse
import hashlib
import json
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

# name -> (height, width, PIL save options, mode)
JPEGS = {
    "voc_500x375_q75_420.jpg": (375, 500, {"quality": 75, "subsampling": 2}, "RGB"),
    "voc_500x333_progressive.jpg": (333, 500, {"quality": 80, "progressive": True,
                                               "optimize": True}, "RGB"),
    "ade_683x512_q90_444.jpg": (512, 683, {"quality": 90, "subsampling": 0}, "RGB"),
    "portrait_768x1024_422_restart.jpg": (1024, 768, {"quality": 75, "subsampling": 1,
                                                      "restart_marker_rows": 1}, "RGB"),
    "coco_640x480_grey.jpg": (480, 640, {"quality": 75}, "L"),
    "kvasir_622x529.jpg": (529, 622, {"quality": 75}, "RGB"),
    "kvasir_622x529_mask.jpg": (529, 622, {"quality": 75}, "mask"),
}
# the eval loader's shrink of the images larger than a 512² canvas
BILINEAR = {"ade_683x512_q90_444.jpg": (383, 512),
            "portrait_768x1024_422_restart.jpg": (512, 384)}
SYNAPSE_CASE = "case0001.npy.h5"
SYNAPSE_SHAPE = (3, 96, 96)


def sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def texture(h: int, w: int, seed: int) -> np.ndarray:
    """(h, w, 3) uint8: smooth colour fields, a few discs with edges and
    mild noise, so the files carry DC and AC content at a photo's size."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        fy, fx, ph = rng.uniform(0.005, 0.03, 2).tolist() + [rng.uniform(0, 6.3)]
        img[..., c] = 128 + 70 * np.sin(fy * yy + ph) * np.cos(fx * xx - ph)
    for _ in range(6):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(0.05, 0.2) * min(h, w)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.uniform(20, 235, 3)
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def mask(h: int, w: int, seed: int) -> np.ndarray:
    """(h, w, 3) uint8 polyp-like mask: 255 inside an ellipse, 0 outside."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
    ry, rx = rng.uniform(0.15, 0.3) * h, rng.uniform(0.15, 0.3) * w
    inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
    return np.repeat((inside * 255).astype(np.uint8)[..., None], 3, axis=-1)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=str(ROOT / "tests" / "torch_fixtures"))
    args = p.parse_args(argv)
    import h5py
    import PIL
    from PIL import Image, features

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    manifest = {"written_by": "tools/torch_fixtures.py", "pil": PIL.__version__,
                "libjpeg_turbo": features.version("libjpeg_turbo"), "h5py": h5py.__version__,
                "jpeg": [], "bilinear": [], "hdf5": []}
    for seed, (name, (h, w, opts, mode)) in enumerate(JPEGS.items()):
        if mode == "mask":
            Image.fromarray(mask(h, w, seed)).save(out / name, "JPEG", **opts)
        else:
            img = texture(h, w, seed)
            Image.fromarray(img if mode == "RGB" else img[..., 1]).save(out / name, "JPEG", **opts)
        with Image.open(out / name) as im:
            arr = np.asarray(im)
            manifest["jpeg"].append({"file": name, "mode": im.mode, "shape": list(arr.shape),
                                     "saved_with": opts, "sha256": sha256(arr)})
        if name in BILINEAR:
            hw = BILINEAR[name]
            with Image.open(out / name) as im:
                small = np.asarray(im.convert("RGB").resize(hw[::-1], Image.BILINEAR))
            manifest["bilinear"].append({"file": name, "size": list(hw),
                                         "shape": list(small.shape), "sha256": sha256(small)})
    rng = np.random.default_rng(100)
    d, h, w = SYNAPSE_SHAPE
    yy, xx = np.mgrid[0:h, 0:w]
    label = np.zeros(SYNAPSE_SHAPE, np.float32)
    for k in range(1, 9):
        cy, cx, r = rng.uniform(10, h - 10), rng.uniform(10, w - 10), rng.uniform(6, 16)
        label[:, (yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = k
    image = np.clip(label / 9 + rng.normal(0, 0.05, SYNAPSE_SHAPE), 0, 1).astype(np.float32)
    with h5py.File(out / SYNAPSE_CASE, "w") as f:
        f.create_dataset("image", data=image)
        f.create_dataset("label", data=label)
    with h5py.File(out / SYNAPSE_CASE, "r") as f:
        manifest["hdf5"].append({"file": SYNAPSE_CASE, "datasets": {
            k: {"dtype": str(f[k].dtype), "shape": list(f[k].shape), "sha256": sha256(f[k][()])}
            for k in ("image", "label")}})
    (out / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    total = sum(f.stat().st_size for f in out.iterdir())
    print(f"wrote {len(list(out.iterdir()))} files, {total} bytes, to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
