from ray_tpu_torch.train.torch.config import TorchConfig
from ray_tpu_torch.train.torch.torch_trainer import (
    TorchTrainer,
    prepare_data_loader,
    prepare_model,
)

__all__ = ["TorchConfig", "TorchTrainer", "prepare_data_loader", "prepare_model"]
