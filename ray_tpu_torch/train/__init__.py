"""Distributed training on the ray_tpu_torch runtime.

Reference: `python/ray/train/` — `DataParallelTrainer`
(`data_parallel_trainer.py:56`), `BackendExecutor`
(`_internal/backend_executor.py:43`), `WorkerGroup` (`_internal/worker_group.py:92`),
and the per-framework `Backend` plugin seam (`backend.py:53`).

The flagship backend is `TorchConfig`/`TorchTrainer` (`ray_tpu_torch.train.
torch`), the counterpart of the JAX package's `JaxTrainer`: the gang of worker
actors forms one torch.distributed process group (NCCL when the workers hold
GPUs, gloo otherwise; none for a gang of one), at the seam where the reference
calls `dist.init_process_group` (`train/torch/config.py:113`).

Inference from a checkpoint: `TorchPredictor` (the JAX package's
`JaxPredictor`) scores numpy batches on the GPU; `BatchPredictor` holds a
checkpoint and a predictor class and scores a ``ray_tpu_torch.data`` Dataset
on an actor pool whose actors share the GPU (``num_gpus_per_worker``).
"""

from ray_tpu_torch.air.config import (  # re-exported for parity convenience
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.train.backend import Backend, BackendConfig
from ray_tpu_torch.train.base_trainer import BaseTrainer, TrainingFailedError
from ray_tpu_torch.train.data_parallel_trainer import DataParallelTrainer
from ray_tpu_torch.train.predictor import BatchPredictor, Predictor, TorchPredictor

__all__ = [
    "Backend",
    "BackendConfig",
    "BaseTrainer",
    "BatchPredictor",
    "Checkpoint",
    "CheckpointConfig",
    "DataParallelTrainer",
    "FailureConfig",
    "Predictor",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "TorchPredictor",
    "TrainingFailedError",
]
