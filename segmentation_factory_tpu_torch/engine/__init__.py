from segmentation_factory_tpu_torch.engine.state import (
    OPTIMIZERS,
    FlatOptimizer,
    create_optimizer,
    recalibrate_bn,
)
from segmentation_factory_tpu_torch.engine.steps import (
    compute_loss,
    eval_step,
    predict_step,
    train_step,
)

__all__ = ["OPTIMIZERS", "FlatOptimizer", "compute_loss", "create_optimizer", "eval_step",
           "predict_step", "recalibrate_bn", "train_step"]
