from segmentation_factory_tpu_torch.utils.logging import MetricLogger, SmoothedValue, get_model_size
from segmentation_factory_tpu_torch.utils.tb import ScalarWriter

__all__ = ["MetricLogger", "ScalarWriter", "SmoothedValue", "get_model_size"]
