from segmentation_factory_tpu_torch.engine.state import AdamW, create_optimizer
from segmentation_factory_tpu_torch.engine.steps import (
    compute_loss,
    eval_step,
    predict_step,
    train_step,
)

__all__ = ["AdamW", "compute_loss", "create_optimizer", "eval_step", "predict_step",
           "train_step"]
