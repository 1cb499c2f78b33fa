"""Export CLI of the port: ``python -m segmentation_factory_tpu_torch.export_model``.

The JAX package's root ``export_model.py`` with a ``torch.export`` program
in a ``.pt2`` (``export.export_model``) in place of StableHLO: the model
with seeded weights or the best (else the latest) checkpoint of ``--ckpt``,
exported at a dynamic batch (``--static-batch N`` fixes it), then held
against the live model (``export.validate_export``; ``--skip-validate``
skips it). Exits 1 when the check fails. Plus ``--device`` (default
``cuda``: the program then runs the kernels); the model computes in
bfloat16 (``DTYPE``). ``--format savedmodel`` (a TensorFlow SavedModel
through jax2tf, the JAX route to ONNX) is not ported. Loading the ``.pt2`` needs
``segmentation_factory_tpu_torch`` importable (``export.load_exported``).

    python -m segmentation_factory_tpu_torch.export_model --backbone mit_b2 \\
        --nb-classes 19 --img-size 1024 --ckpt output/ckpt --out model.pt2
"""

from __future__ import annotations

import argparse
import sys

import torch

DTYPE = torch.bfloat16  # the compute dtype of the pinned configs


def parse_args(argv=None):
    p = argparse.ArgumentParser("segmentation_factory_tpu_torch export")
    p.add_argument("--backbone", default="mit_b0")
    p.add_argument("--seg-head", "--head", dest="head", default="segformerhead")
    p.add_argument("--nb-classes", type=int, required=True)
    p.add_argument("--img-size", type=int, default=512)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--out", default="model.pt2")
    p.add_argument("--static-batch", type=int, default=None,
                   help="fix the batch dim instead of exporting it dynamic")
    p.add_argument("--format", default="pt2", choices=["pt2", "savedmodel"],
                   help="pt2 (torch.export); savedmodel is not ported")
    p.add_argument("--skip-validate", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    """Export (and check) the model; returns the exit code."""
    args = parse_args(argv)
    if args.format == "savedmodel":
        raise NotImplementedError(
            "--format savedmodel is not ported: it needs TensorFlow (jax2tf); "
            "export a .pt2 with --format pt2")
    from segmentation_factory_tpu_torch.export import export_model, validate_export
    from segmentation_factory_tpu_torch.infer import SemSeg

    model = SemSeg(args.backbone, args.head, args.nb_classes, img_size=args.img_size,
                   dtype=DTYPE, device=args.device, ckpt_dir=args.ckpt).model
    export_model(model, args.img_size, args.out, dynamic_batch=args.static_batch is None,
                 batch=args.static_batch or 1)
    print(f"exported -> {args.out}")
    if not args.skip_validate:
        ok, diff = validate_export(model, args.out, args.img_size,
                                   batch=args.static_batch or 2)
        print(f"parity check: {'OK' if ok else 'FAIL'} (max abs diff {diff:.2e})")
        if not ok:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
