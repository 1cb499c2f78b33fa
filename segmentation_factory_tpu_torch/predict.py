"""Inference CLI of the port: ``python -m segmentation_factory_tpu_torch.predict``.

The JAX package's root ``predict.py`` with the port's readers in place of
PIL: each PNG or JPEG of ``--input`` (a file or a directory; read by its
first bytes, ``data/datasets.py`` ``imread``) -> ``SemSeg.predict``
(``--tta``: multi-scale + flip) -> the palette overlay, with the class names
stamped when ``--draw-names`` and a ``--dataset`` are given -> a PNG under
``--output`` (``data/png.py``): of the input's own name for a ``.png``
input, of its name with ``.png`` added for any other (``a.jpg`` ->
``a.jpg.png``, where the JAX CLI writes a JPEG ``a.jpg``: the port has no
JPEG encoder), so ``a.jpg`` and ``a.png`` in one directory do not collide. Plus ``--device`` (default ``cuda``); it computes in
bfloat16 (``DTYPE``). BMP inputs raise: their decoder is not ported
(ROADMAP Queue 1).

    python -m segmentation_factory_tpu_torch.predict --backbone mit_b2 \\
        --nb-classes 19 --dataset cityscapes --ckpt output/ckpt --input img.png \\
        --output predict_out --img-size 1024 --tta --draw-names
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np
import torch

DTYPE = torch.bfloat16  # the compute dtype of the pinned configs

IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png", ".bmp")


def parse_args(argv=None):
    p = argparse.ArgumentParser("segmentation_factory_tpu_torch inference")
    p.add_argument("--backbone", default="mit_b0")
    p.add_argument("--seg-head", "--head", dest="head", default="segformerhead")
    p.add_argument("--nb-classes", type=int, required=True)
    p.add_argument("--dataset", default=None, help="use this dataset's palette/classes")
    p.add_argument("--ckpt", default=None, help="checkpoint dir (output/ckpt)")
    p.add_argument("--input", required=True, help="image file or directory")
    p.add_argument("--output", default="./predict_out")
    p.add_argument("--img-size", type=int, default=512)
    p.add_argument("--tta", action="store_true", help="multi-scale + flip")
    p.add_argument("--draw-names", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> Dict[str, np.ndarray]:
    """Predict every image of ``--input``; returns {input path: label map}."""
    args = parse_args(argv)
    from segmentation_factory_tpu_torch.data.datasets import DATASETS, imread
    from segmentation_factory_tpu_torch.data.png import write_png
    from segmentation_factory_tpu_torch.data.visualize import draw_class_names
    from segmentation_factory_tpu_torch.infer import SemSeg

    palette = class_names = None
    if args.dataset:
        cls, _ = DATASETS[args.dataset.lower()]
        palette, class_names = cls.PALETTE, cls.CLASSES
    seg = SemSeg(args.backbone, args.head, args.nb_classes, img_size=args.img_size,
                 palette=None if palette is None else np.asarray(palette),
                 dtype=DTYPE, device=args.device, ckpt_dir=args.ckpt)
    paths = ([os.path.join(args.input, f) for f in sorted(os.listdir(args.input))]
             if os.path.isdir(args.input) else [args.input])
    os.makedirs(args.output, exist_ok=True)
    maps = {}
    for path in paths:
        if not path.lower().endswith(IMAGE_SUFFIXES):
            continue
        img = imread(path)
        seg_map, blended = seg.predict(img, tta=args.tta)
        if args.draw_names and class_names:
            blended = draw_class_names(blended, seg_map, class_names)
        name = os.path.basename(path)
        out = os.path.join(args.output, name if name.lower().endswith(".png") else name + ".png")
        write_png(out, blended)
        maps[path] = seg_map
        print(f"{path} -> {out} (classes present: {sorted(set(seg_map.ravel().tolist()))[:10]})")
    return maps


if __name__ == "__main__":
    main()
