from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from ray_tpu_torch.models.gpt import (
    GPTConfig,
    forward,
    init_params,
    loss_fn,
    num_params,
    param_logical_axes,
    train_flops_per_token,
)
from ray_tpu_torch.models.llama import LlamaConfig
from ray_tpu_torch.models.resnet import ResNetConfig
from ray_tpu_torch.models.training import (
    AdamW,
    TrainState,
    create_train_state,
    default_optimizer,
    make_train_step,
    param_shardings,
    shard_batch,
)

__all__ = [
    "AdamW",
    "GPTConfig",
    "LlamaConfig",
    "ResNetConfig",
    "TrainState",
    "create_train_state",
    "default_optimizer",
    "forward",
    "init_params",
    "loss_fn",
    "make_train_step",
    "num_params",
    "param_logical_axes",
    "param_shardings",
    "params_from_numpy",
    "params_to_numpy",
    "shard_batch",
    "train_flops_per_token",
]
