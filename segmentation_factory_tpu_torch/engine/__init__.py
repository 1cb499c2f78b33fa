from segmentation_factory_tpu_torch.engine.steps import eval_step, predict_step

__all__ = ["eval_step", "predict_step"]
