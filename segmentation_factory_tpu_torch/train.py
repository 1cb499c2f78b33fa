"""Training CLI of the port: ``python -m segmentation_factory_tpu_torch.train``.

The flags and ``--config`` semantics of the JAX package's ``train.py``, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch versions of
the kernels). One process, one device.

    python -m segmentation_factory_tpu_torch.train --dataset synthetic \\
        --backbone mit_b0 --img-size 64 --batch-size 8 --epochs 2 --device cpu
    python -m segmentation_factory_tpu_torch.train \\
        --config configs/cityscapes_mit_b2_segformer_1024.json
"""

from __future__ import annotations

import argparse
import os

from segmentation_factory_tpu_torch.config import (
    DataConfig,
    EvalConfig,
    ModelConfig,
    OptimConfig,
    TrainConfig,
)
from segmentation_factory_tpu_torch.data.datasets import DATASETS


def parse_args(argv=None):
    p = argparse.ArgumentParser("segmentation_factory_tpu_torch trainer")
    p.add_argument("--backbone", default="mit_b0")
    p.add_argument("--seg-head", "--head", dest="head", default="segformerhead")
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--data-root", default="./data")
    p.add_argument("--nb-classes", type=int, default=None)
    p.add_argument("--img-size", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--opt", default="adamw")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--min-lr", type=float, default=1e-5)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--sched", default="cosine")
    p.add_argument("--warmup-steps", type=int, default=1500)
    p.add_argument("--opt-eps", type=float, default=None)
    p.add_argument("--opt-betas", type=float, nargs=2, default=None)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--lr-cycle-mul", type=float, default=None)
    p.add_argument("--lr-cycle-decay", type=float, default=None)
    p.add_argument("--lr-cycle-limit", type=int, default=None)
    p.add_argument("--lr-k-decay", type=float, default=None)
    p.add_argument("--lr-noise", type=float, nargs=2, default=None,
                   help="noise window in optimizer steps (not ported: raises)")
    p.add_argument("--lr-noise-pct", type=float, default=None)
    p.add_argument("--lr-noise-std", type=float, default=None)
    p.add_argument("--decay-rate", type=float, default=None)
    p.add_argument("--decay-milestones", type=int, nargs="+", default=None)
    p.add_argument("--patience-epochs", type=int, default=None)
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--clip-grad", type=float, default=0.02)
    p.add_argument("--clip-mode", default="agc")
    p.add_argument("--loss", default="ce", help="ce|ohem|focal|dicebce")
    p.add_argument("--no-dice", action="store_true")
    p.add_argument("--pretrained-backbone", default=None)
    p.add_argument("--finetune", default=None)
    p.add_argument("--freeze-layers", action="store_true")
    p.add_argument("--vflip", action="store_true")
    p.add_argument("--color-jitter", type=float, default=0.5)
    p.add_argument("--embed-dim", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output-dir", default="./output")
    p.add_argument("--eval", action="store_true", help="evaluate only")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--print-freq", type=int, default=50)
    p.add_argument("--mesh", default=None, help="dp,tp (not ported: raises)")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--eval-protocol", default="whole", choices=["whole", "slide", "ms_flip"])
    p.add_argument("--eval-size", type=int, default=None)
    p.add_argument("--eval-crop", type=int, default=None)
    p.add_argument("--eval-stride", type=int, default=None)
    p.add_argument("--config", default=None,
                   help="TrainConfig JSON (configs/*.json); when set, the other flags "
                        "but --eval and --device are ignored")
    p.add_argument("--remat", action="store_true", help="not ported: raises")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def config_from_args(args) -> TrainConfig:
    """The TrainConfig the flags describe (without ``--config``)."""
    nc = args.nb_classes or DATASETS[args.dataset.lower()][1]
    sched_kwargs = {
        "cycle_mul": args.lr_cycle_mul,
        "cycle_decay": args.lr_cycle_decay,
        "cycle_limit": args.lr_cycle_limit,
        "k_decay": args.lr_k_decay,
        "noise_range": tuple(args.lr_noise) if args.lr_noise else None,
        "noise_pct": args.lr_noise_pct,
        "noise_std": args.lr_noise_std,
        "decay_rate": args.decay_rate,
        "milestones": args.decay_milestones,
        "patience": args.patience_epochs,
    }
    return TrainConfig(
        model=ModelConfig(backbone=args.backbone, head=args.head, num_classes=nc,
                          embed_dim=args.embed_dim, pretrained_backbone=args.pretrained_backbone,
                          finetune=args.finetune, freeze=args.freeze_layers, remat=args.remat),
        data=DataConfig(dataset=args.dataset, data_root=args.data_root, img_size=args.img_size,
                        batch_size=args.batch_size, num_workers=args.workers, vflip=args.vflip,
                        color_jitter=args.color_jitter),
        optim=OptimConfig(opt=args.opt, lr=args.lr, min_lr=args.min_lr,
                          weight_decay=args.weight_decay, momentum=args.momentum,
                          opt_eps=args.opt_eps,
                          opt_betas=tuple(args.opt_betas) if args.opt_betas else None,
                          sched=args.sched, warmup_steps=args.warmup_steps,
                          clip_grad=args.clip_grad, clip_mode=args.clip_mode, epochs=args.epochs,
                          grad_accum=args.grad_accum,
                          sched_kwargs={k: v for k, v in sched_kwargs.items() if v is not None}),
        eval=EvalConfig(protocol=args.eval_protocol, size=args.eval_size, crop=args.eval_crop,
                        stride=args.eval_stride),
        loss_type=args.loss,
        use_dice=not args.no_dice,
        seed=args.seed,
        output_dir=args.output_dir,
        resume=not args.no_resume,
        print_freq=args.print_freq,
        mesh_shape=tuple(int(v) for v in args.mesh.split(",")) if args.mesh else None,
    )


def main(argv=None):
    args = parse_args(argv)
    from segmentation_factory_tpu_torch.engine.loop import Trainer

    if args.config:
        with open(args.config) as f:
            cfg = TrainConfig.from_json(f.read())
        trainer = Trainer(cfg, device=args.device)
        if args.eval:
            print(trainer.evaluate())
        else:
            trainer.fit()
        return
    cfg = config_from_args(args)
    os.makedirs(cfg.output_dir, exist_ok=True)
    with open(os.path.join(cfg.output_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    trainer = Trainer(cfg, device=args.device)
    if args.eval:
        m = trainer.evaluate()
        print({k: round(v, 2) for k, v in m.items() if not isinstance(v, list)})
        return
    trainer.fit()


if __name__ == "__main__":
    main()
