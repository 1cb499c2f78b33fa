"""Validation CLI of the port: ``python -m segmentation_factory_tpu_torch.validate``.

The flags and flow of the JAX package's root ``validate.py``, plus
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions),
computing in bfloat16 as every pinned config does (``DTYPE``): a checkpoint
directory (the best step, else the latest) -> the val split
through the eval ``Loader`` -> whole-image, sliding-window (``--slide``) or
multi-scale + flip (``--tta``) logits -> the confusion matrix -> mIoU and a
per-class IoU / F1 table. ``--dataset synapse`` runs the per-case
volumetric protocol instead (``infer.evaluate_volumes``, slid at ``--crop``
or ``--img-size``) and prints its dice without the per-case entries.
``--export-artifact`` validates a ``.pt2`` from ``export_model`` in place of
the live model; it serves one spatial size, so it refuses ``--tta``,
``--slide`` and Synapse, as the JAX CLI does.

    python -m segmentation_factory_tpu_torch.validate --dataset synthetic \\
        --backbone mit_b0 --nb-classes 8 --img-size 64 --ckpt output/ckpt --device cpu
"""

from __future__ import annotations

import argparse
from typing import Dict

import torch

DTYPE = torch.bfloat16  # the compute dtype of the pinned configs


def parse_args(argv=None):
    p = argparse.ArgumentParser("segmentation_factory_tpu_torch validation")
    p.add_argument("--backbone", default="mit_b0")
    p.add_argument("--seg-head", "--head", dest="head", default="segformerhead")
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--data-root", default="./data")
    p.add_argument("--nb-classes", type=int, default=None)
    p.add_argument("--img-size", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--tta", action="store_true")
    p.add_argument("--slide", action="store_true")
    p.add_argument("--crop", type=int, default=None, help="sliding-window crop")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--export-artifact", default=None,
                   help="validate a .pt2 from export_model instead of the live model")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> Dict:
    """Run the validation; returns ``metrics.compute_metrics``' dict with
    the (C, C) int64 confusion matrix under ``"hist"`` (for Synapse,
    ``infer.evaluate_volumes``' dict)."""
    args = parse_args(argv)
    from segmentation_factory_tpu_torch.data.datasets import DATASETS, build_dataset
    from segmentation_factory_tpu_torch.data.pipeline import Loader, prefetch_to_device
    from segmentation_factory_tpu_torch.data.transforms import preprocess_eval
    from segmentation_factory_tpu_torch.infer import (
        SemSeg,
        evaluate_volumes,
        multi_scale_flip_inference,
        slide_inference,
    )
    from segmentation_factory_tpu_torch.metrics import compute_metrics, update_confusion_matrix

    key = args.dataset.lower()
    if args.export_artifact and (args.tta or args.slide or key == "synapse"):
        raise SystemExit(
            "--export-artifact serves a fixed-spatial-shape graph (only the batch dim is "
            "dynamic); --tta/--slide/synapse feed it other resolutions. Re-validate the live "
            "model, or export at each needed size.")
    nc = args.nb_classes or DATASETS[key][1]
    seg = SemSeg(args.backbone, args.head, nc, img_size=args.img_size,
                 dtype=DTYPE, device=args.device, ckpt_dir=args.ckpt)
    if key == "synapse":
        ds = build_dataset("synapse", args.data_root, "val")
        m = evaluate_volumes(seg.forward, ds.volumes(), nc, crop=args.crop or args.img_size,
                             device=seg.device)
        print({k: v for k, v in m.items() if k != "per_case"})
        return m
    forward = seg.forward
    if args.export_artifact:
        # the deployed program becomes the forward: the metrics are then an
        # end-to-end check of the exported graph
        from segmentation_factory_tpu_torch.export import load_exported

        forward = load_exported(args.export_artifact).module()

    kwargs = {"num_classes": nc} if key == "synthetic" else {}
    ds = build_dataset(args.dataset, args.data_root, "val", **kwargs)
    loader = Loader(ds, args.batch_size, args.img_size, train=False,
                    eval_hw=(args.img_size, args.img_size), num_workers=args.workers)
    hist = torch.zeros((nc, nc), dtype=torch.int64, device=seg.device)
    with torch.inference_mode():
        for batch in prefetch_to_device(iter(loader), seg.device):
            x = preprocess_eval(batch["image"])
            if args.tta:
                logits = multi_scale_flip_inference(forward, x, nc, crop=args.crop)
            elif args.slide:
                # --slide without --crop takes the train crop (img-size)
                logits = slide_inference(forward, x, nc, args.crop or args.img_size)
            else:
                logits = forward(x)
            hist = update_confusion_matrix(hist, logits, batch["label"], ds.ignore_index)
    m = compute_metrics(hist)
    print({k: round(v, 2) for k, v in m.items() if not isinstance(v, list)})
    names = list(getattr(ds, "CLASSES", [])) or [f"class_{i}" for i in range(nc)]
    width = max(len(n) for n in names)
    print(f"{'class':<{width}}  IoU    F1")
    for n, iou, f1 in zip(names, m["ious"], m["f1s"]):
        print(f"{n:<{width}}  {iou:5.1f}  {f1:5.1f}")
    m["hist"] = hist.cpu().numpy()
    return m


if __name__ == "__main__":
    main()
