"""Trainer: the train / eval / checkpoint loop.

The port's counterpart of ``segmentation_factory_tpu/engine/loop.py``
``Trainer`` (:44-525): config -> datasets, loaders, schedule, model and
optimizer -> epochs of device-side augmentation and ``train_step`` -> eval
under the config's protocol (``whole``, ``slide`` or ``ms_flip``; the
per-case volumetric dice for a val split with ``volumes()``, Synapse's) ->
best-mIoU checkpoints with auto-resume and one ``results.jsonl`` line per
epoch. Batches cross to the device as uint8 through ``prefetch_to_device``.

Randomness: the augmentation draws and the model's drop-path / dropout
noise of step ``t`` come from one generator seeded from (seed + 1, t), the
counterpart of ``fold_in(PRNGKey(seed + 1), step)``, so a resumed run
repeats the uninterrupted one step for step. ``step`` counts train steps
(micro-steps under ``grad_accum``), skipped ones included (the JAX
``state.step``); the optimizer counts the updates it applied.

The Trainer's options, as ``loop.py`` wires them: every optimizer, clip
mode and schedule of ``engine.state`` / ``schedule`` (the schedule indexed
in optimizer updates: ``total_steps`` is the micro-steps over
``grad_accum``, and the logged rate is read at ``step // grad_accum``);
``grad_accum`` (``optax.MultiSteps``); ``model.remat`` (the backbone's
training forward checkpointed); ``model.pretrained_backbone`` (a reference
``.pth``); ``model.finetune`` (a ``.pth`` or a checkpoint directory) with
``model.freeze`` (only the classifier trains); the plateau schedule, stepped
on each eval's mIoU. A device mesh other than one device is not ported and
raises ``NotImplementedError``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from segmentation_factory_tpu_torch.checkpoint import (
    CheckpointManager,
    is_classifier,
    load_for_finetune,
    load_pretrained_backbone,
)
from segmentation_factory_tpu_torch.config import TrainConfig
from segmentation_factory_tpu_torch.data.datasets import build_dataset
from segmentation_factory_tpu_torch.data.pipeline import Loader, prefetch_to_device
from segmentation_factory_tpu_torch.data.transforms import (
    augment_batch,
    draw_augment,
    preprocess_eval,
)
from segmentation_factory_tpu_torch.device import resolve_device
from segmentation_factory_tpu_torch.engine.state import create_optimizer
from segmentation_factory_tpu_torch.engine.steps import eval_step, train_step
from segmentation_factory_tpu_torch.infer import (
    evaluate_volumes,
    multi_scale_flip_inference,
    slide_inference,
)
from segmentation_factory_tpu_torch.metrics import compute_metrics, update_confusion_matrix
from segmentation_factory_tpu_torch.models.build import build_model
from segmentation_factory_tpu_torch.schedule import PlateauSchedule, create_schedule
from segmentation_factory_tpu_torch.utils import MetricLogger, ScalarWriter, get_model_size


def _refuse_unported(cfg: TrainConfig) -> None:
    if cfg.mesh_shape is not None and tuple(cfg.mesh_shape) != (1, 1):
        raise NotImplementedError(f"mesh_shape {tuple(cfg.mesh_shape)} (a mesh of more than "
                                  "one device) is not ported to the PyTorch trainer")


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of train step ``step``: seeded from (seed, step)."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


class Trainer:
    def __init__(self, cfg: TrainConfig, train_ds=None, val_ds=None, device="cuda"):
        _refuse_unported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        os.makedirs(cfg.output_dir, exist_ok=True)

        d = cfg.data
        self.train_ds = train_ds or build_dataset(d.dataset, d.data_root, "train")
        self.val_ds = val_ds or build_dataset(d.dataset, d.data_root, "val")
        self.train_loader = Loader(self.train_ds, d.batch_size, d.img_size, train=True,
                                   scale_range=tuple(d.scale_range), seed=cfg.seed,
                                   num_workers=d.num_workers)
        eval_size = cfg.eval.size or d.img_size
        self.val_loader = Loader(self.val_ds, max(d.val_batch_size, 1), d.img_size, train=False,
                                 eval_hw=(eval_size, eval_size), num_workers=d.num_workers)
        # a val split of whole volumes (Synapse's) is scored per case
        self.volumetric = callable(getattr(self.val_ds, "volumes", None))

        # the schedule counts optimizer updates: one every grad_accum micro-steps
        k = max(cfg.optim.grad_accum, 1)
        total_steps = max(max(len(self.train_loader), 1) * cfg.optim.epochs // k, 1)
        warmup = min(cfg.optim.warmup_steps, total_steps // 10)
        if warmup < cfg.optim.warmup_steps:
            print(f"warning: warmup_steps {cfg.optim.warmup_steps} exceeds 10% of the run "
                  f"({total_steps} updates); capped to {warmup}")
        self.schedule = create_schedule(
            cfg.optim.sched, cfg.optim.lr, total_steps=total_steps, warmup_steps=warmup,
            warmup_lr_init=cfg.optim.warmup_lr, min_lr=cfg.optim.min_lr,
            **(cfg.optim.sched_kwargs or {}))
        self._plateau = self.schedule if isinstance(self.schedule, PlateauSchedule) else None
        # the rate of micro-step t's update (the plateau's current one)
        if self._plateau is not None:
            self.lr_for_logging = lambda t: torch.tensor(self._plateau.current_lr(t // k))
        else:
            self.lr_for_logging = lambda t: self.schedule(t // k)

        dtype = torch.bfloat16 if cfg.model.compute_dtype == "bfloat16" else torch.float32
        self.model = build_model(cfg.model.backbone, cfg.model.head, cfg.model.num_classes,
                                 embed_dim=cfg.model.embed_dim, dtype=dtype, device=self.device,
                                 seed=cfg.seed, remat=cfg.model.remat, img_size=d.img_size)
        if cfg.model.pretrained_backbone:
            loaded, skipped = load_pretrained_backbone(self.model, cfg.model.pretrained_backbone)
            print(f"pretrained backbone {cfg.model.pretrained_backbone}: {len(loaded)} tensors "
                  f"loaded, {len(skipped)} skipped")
            if skipped:
                print("  e.g. skipped:", skipped[:3])
        trainable = None
        if cfg.model.finetune:
            load_for_finetune(self.model, cfg.model.finetune)
            if cfg.model.freeze:
                trainable = [is_classifier(n) for n, _ in self.model.named_parameters()]
            print(f"finetune init from {cfg.model.finetune} (freeze={cfg.model.freeze})")
        self.optimizer = create_optimizer(
            cfg.optim.opt, self.schedule, weight_decay=cfg.optim.weight_decay,
            momentum=cfg.optim.momentum, clip_grad=cfg.optim.clip_grad,
            clip_mode=cfg.optim.clip_mode, params=self.model.named_parameters(),
            eps=cfg.optim.opt_eps, betas=cfg.optim.opt_betas, grad_accum=k, trainable=trainable)
        self.step = 0

        self.ckpt = CheckpointManager(os.path.join(cfg.output_dir, "ckpt"))
        self.best = {"mIoU": 0.0, "mF1": 0.0, "aAcc": 0.0}
        if cfg.resume:
            step, meta = self.ckpt.restore(self.model, self.optimizer)
            if step is not None:
                self.step = step
                self.best.update(meta)
                print(f"resumed from step {step}: {meta}")
        self.results_path = os.path.join(cfg.output_dir, "results.jsonl")
        self.writer = ScalarWriter(os.path.join(cfg.output_dir, "logs"))
        size = get_model_size(self.model)
        with open(os.path.join(cfg.output_dir, "model.txt"), "w") as f:
            f.write(f"{cfg.model.backbone} + {cfg.model.head}\n"
                    f"params: {size['params_M']:.2f}M  size: {size['size_MB']:.1f}MB\n")

    # ------------------------------------------------------------------

    def train_step(self, batch: dict) -> dict:
        """One step on a loader batch {'image': uint8, 'label': int32} (on
        the device or not): augmentation, forward, backward, update (under
        ``grad_accum`` a micro-step). Returns the step's device metrics
        (``engine.steps.train_step``), ``lr`` from ``lr_for_logging``."""
        cfg, d = self.cfg, self.cfg.data
        gen = step_generator(cfg.seed + 1, self.step, self.device)
        images = torch.as_tensor(batch["image"]).to(self.device)
        labels = torch.as_tensor(batch["label"]).to(self.device)
        draws = draw_augment(gen, images.shape[0], hflip=d.hflip, vflip=d.vflip,
                             color_jitter=d.color_jitter)
        images, labels = augment_batch(images, labels, draws)
        metrics = train_step(self.model, self.optimizer, {"image": images, "label": labels},
                             generator=gen, ignore_index=d.ignore_index,
                             loss_type=cfg.loss_type, use_dice=cfg.use_dice)
        metrics["lr"] = self.lr_for_logging(self.step)
        self.step += 1
        return metrics

    def train_one_epoch(self, epoch: int) -> dict:
        """One pass over the train loader. The loss is read on the host
        only every ``print_freq`` steps and at the last one. Returns the mean
        of the read losses, the steps, the seconds, images/s (the loader
        included) and ``data_wait_s``: the mean seconds a step waited for
        its batch."""
        cfg = self.cfg
        self.train_loader.set_epoch(epoch)
        logger = MetricLogger(print_freq=cfg.print_freq, header=f"Epoch [{epoch}] ")
        n = len(self.train_loader)
        skipped = torch.zeros((), dtype=torch.int32, device=self.device)
        t0 = time.perf_counter()
        it = prefetch_to_device(iter(self.train_loader), self.device)
        for i, batch in logger.log_every(it, total=n):
            metrics = self.train_step(batch)
            skipped += metrics["skipped_nonfinite"]
            if i % cfg.print_freq == 0 or i == n - 1:
                loss, lr = float(metrics["loss"]), float(metrics["lr"])
                logger.update(loss=loss, lr=lr)
                self.writer.add_scalar("train_loss", loss, self.step)
                self.writer.add_scalar("train_lr", lr, self.step)
        seconds = time.perf_counter() - t0
        if int(skipped):
            print(f"warning: {int(skipped)} steps skipped a non-finite loss")
        loss_meter = logger.meters.get("loss")
        return {"train_loss": loss_meter.global_avg if loss_meter is not None else float("nan"),
                "steps": n, "seconds": seconds,
                "images_per_s": n * self.train_loader.batch / seconds if n else 0.0,
                "data_wait_s": logger.data_time.global_avg}

    @torch.inference_mode()
    def evaluate(self) -> dict:
        """Metrics of the val loader under ``cfg.eval.protocol``: 'whole'
        (``eval_step``), 'slide' (window + overlap average) or 'ms_flip'
        (multi-scale + horizontal-flip softmax average). A volumetric val
        split (Synapse's) goes case by case through ``evaluate_volumes``."""
        cfg = self.cfg
        nc, ign = cfg.model.num_classes, cfg.data.ignore_index
        if self.volumetric:
            return self._evaluate_volumes()
        protocol = cfg.eval.protocol
        if protocol not in ("whole", "slide", "ms_flip"):
            raise KeyError(f"unknown eval protocol {protocol!r}")
        crop = cfg.eval.crop or cfg.data.img_size
        self.model.eval()
        hist = torch.zeros((nc, nc), dtype=torch.int64, device=self.device)
        for batch in prefetch_to_device(iter(self.val_loader), self.device):
            images = preprocess_eval(batch["image"])
            if protocol == "whole":
                hist = eval_step(self.model, {"image": images, "label": batch["label"]}, hist,
                                 ignore_index=ign)
                continue
            if protocol == "slide":
                logits = slide_inference(self.model, images, nc, crop, cfg.eval.stride)
            else:
                logits = multi_scale_flip_inference(self.model, images, nc,
                                                    scales=cfg.eval.scales, flip=cfg.eval.flip,
                                                    crop=crop)
            hist = update_confusion_matrix(hist, logits, batch["label"], ign)
        return compute_metrics(hist)

    def _evaluate_volumes(self) -> dict:
        """Synapse's per-case dice: each slice group slid in windows of the
        eval crop (``forward`` windows itself, so ``evaluate_volumes``'s own
        slide is off). The foreground dice stands in for mIoU, mF1, mAcc and
        aAcc and the per-class dice for the IoUs and F1s, so the best
        checkpoint and ``results.jsonl`` keep their keys."""
        cfg = self.cfg
        nc, crop = cfg.model.num_classes, cfg.eval.crop or cfg.data.img_size
        self.model.eval()
        m = evaluate_volumes(lambda x: slide_inference(self.model, x, nc, crop),
                             self.val_ds.volumes(), nc, crop=1 << 30, device=self.device)
        m.pop("per_case")
        dice = m["mean_dice_fg"]
        m.update(mIoU=dice, mF1=dice, mAcc=dice, aAcc=dice, ious=m["per_class_dice"],
                 f1s=m["per_class_dice"])
        return m

    def fit(self, epochs: Optional[int] = None) -> dict:
        """Train from the current step's epoch to ``epochs`` (default the
        config's), evaluating every ``eval_interval`` epochs and at the last;
        a plateau schedule takes each eval's mIoU; saves a checkpoint when
        the mIoU does not fall below the best. Returns the best metrics."""
        cfg = self.cfg
        epochs = epochs or cfg.optim.epochs
        start_epoch = self.step // max(len(self.train_loader), 1)
        t0 = time.perf_counter()
        for epoch in range(start_epoch, epochs):
            stats = {"epoch": epoch, **self.train_one_epoch(epoch)}
            if (epoch + 1) % cfg.eval_interval == 0 or epoch == epochs - 1:
                t_eval = time.perf_counter()
                m = self.evaluate()
                stats.update({k: m[k] for k in ("mIoU", "mF1", "mAcc", "aAcc")})
                stats["eval_seconds"] = time.perf_counter() - t_eval
                if self._plateau is not None:
                    old_lr = self._plateau.lr
                    new_lr = self._plateau.step(m["mIoU"])
                    if new_lr != old_lr:
                        print(f"plateau: lr {old_lr:.3g} -> {new_lr:.3g}")
                    self.optimizer.set_plateau_lr(new_lr)
                    stats["lr"] = new_lr
                print(f"epoch {epoch}: mIoU {m['mIoU']:.2f} mF1 {m['mF1']:.2f} "
                      f"aAcc {m['aAcc']:.2f}")
                for k in ("mIoU", "mF1", "aAcc"):
                    self.writer.add_scalar(f"val_{k}", m[k], epoch)
                if m["mIoU"] >= self.best["mIoU"]:
                    self.best = {"mIoU": m["mIoU"], "mF1": m["mF1"], "aAcc": m["aAcc"],
                                 "epoch": epoch}
                    self.ckpt.save(self.step, self.model, self.optimizer, self.best)
            with open(self.results_path, "a") as f:
                f.write(json.dumps(stats) + "\n")
        print(f"training done in {time.perf_counter() - t0:.0f}s; best: {self.best}")
        return self.best
