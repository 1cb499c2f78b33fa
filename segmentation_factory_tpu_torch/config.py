"""Typed training configuration: flat dataclasses, JSON-serialisable.

The port's own copy of ``segmentation_factory_tpu/config.py`` (:13-113),
field for field, so the ``configs/*.json`` files read the same on both
sides. ``engine.loop.Trainer`` runs every option but a ``mesh_shape`` of
more than one device, on which it raises.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass
class ModelConfig:
    backbone: str = "mit_b0"
    head: str = "segformerhead"
    num_classes: int = 21
    embed_dim: Optional[int] = None  # None -> default_embed_dim rule
    compute_dtype: str = "bfloat16"
    pretrained_backbone: Optional[str] = None
    finetune: Optional[str] = None  # ckpt dir or reference .pth (converted)
    freeze: bool = False  # train only classifier keys (ref train_gpu.py:252-257)
    remat: bool = False  # gradient-checkpoint the backbone (1024^2+ batches)


@dataclass
class DataConfig:
    dataset: str = "voc"
    data_root: str = "./data"
    img_size: int = 512
    batch_size: int = 4  # per-host batch (global = batch * hosts)
    val_batch_size: int = 1
    num_workers: int = 4
    ignore_index: int = 255
    # augmentation knobs (ref build_datasets.py:14-29)
    color_jitter: float = 0.5
    scale_range: Tuple[float, float] = (0.5, 2.0)
    hflip: bool = True
    vflip: bool = False  # polyp/medical pipelines (ref kvasir.py:13-54)


@dataclass
class OptimConfig:
    opt: str = "adamw"
    lr: float = 1e-3
    weight_decay: float = 1e-4
    momentum: float = 0.9
    opt_eps: Optional[float] = None  # ref --opt-eps
    opt_betas: Optional[Tuple[float, float]] = None  # ref --opt-betas
    sched: str = "cosine"
    warmup_steps: int = 1500
    warmup_lr: float = 1e-6
    min_lr: float = 1e-5
    clip_grad: Optional[float] = 0.02
    clip_mode: str = "agc"  # 'agc' | 'norm' | 'value' (ref engine.py:50-53)
    epochs: int = 100
    grad_accum: int = 1  # micro-batch accumulation; the effective batch is
    # data.batch_size * grad_accum * hosts
    # extra scheduler knobs passed straight into create_schedule: the ref's
    # --lr-cycle-mul/-decay/-limit, --lr-k-decay, --lr-noise(-pct/-std),
    # --decay-rate, --decay-milestones live here (schedule.py supports all)
    sched_kwargs: dict = field(default_factory=dict)


@dataclass
class EvalConfig:
    """Eval protocol inside the Trainer: whole image, sliding window, or
    multi-scale + flip (pinned config #5's, at 1024^2)."""

    protocol: str = "whole"  # 'whole' | 'slide' | 'ms_flip'
    size: Optional[int] = None  # eval canvas (None -> img_size)
    crop: Optional[int] = None  # slide window / ms-flip crop (None -> img_size)
    stride: Optional[int] = None  # slide stride (None -> 2/3 crop)
    scales: Tuple[float, ...] = (0.5, 0.75, 1.0, 1.25, 1.5, 1.75)
    flip: bool = True


@dataclass
class TrainConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    loss_type: str = "ce"
    use_dice: bool = True  # ref engine.py:10-15 composite
    seed: int = 0
    output_dir: str = "./output"
    resume: bool = True
    eval_interval: int = 1
    print_freq: int = 50
    mesh_shape: Optional[Tuple[int, int]] = None  # (dp, tp); None -> all-data

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "TrainConfig":
        d = json.loads(s)
        return TrainConfig(
            model=ModelConfig(**d.get("model", {})),
            data=DataConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.get("data", {}).items()}),
            optim=OptimConfig(**{
                k: tuple(v) if k == "opt_betas" and isinstance(v, list) else v
                for k, v in d.get("optim", {}).items()
            }),
            eval=EvalConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.get("eval", {}).items()}),
            **{
                k: (tuple(v) if k == "mesh_shape" and v is not None else v)
                for k, v in d.items()
                if k not in ("model", "data", "optim", "eval")
            },
        )
