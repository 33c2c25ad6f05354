"""TorchTrainer: DataParallelTrainer with the torch.distributed backend.

Reference: `python/ray/train/torch/torch_trainer.py` (`TorchTrainer`). The
train loop uses `prepare_model` to wrap its model in DDP; gradients sync over
NCCL between the gang's worker actors when they hold GPUs, else over gloo.
The counterpart of the JAX package's `JaxTrainer`: with
`ScalingConfig(num_workers=1, use_gpu=True)` the loop runs in one worker
process on the one GPU the scheduler made visible to it.

Example:

    def train_loop(config):
        model = prepare_model(Net())
        opt = torch.optim.SGD(model.parameters(), lr=1e-2)
        for epoch in range(config["epochs"]):
            for x, y in loader:
                opt.zero_grad(); loss = F.mse_loss(model(x), y)
                loss.backward(); opt.step()
            session.report({"loss": float(loss)})

    TorchTrainer(train_loop, scaling_config=ScalingConfig(num_workers=2, use_gpu=True)).fit()
"""

from __future__ import annotations

from ray_tpu_torch.train.data_parallel_trainer import DataParallelTrainer
from ray_tpu_torch.train.torch.config import TorchConfig


class TorchTrainer(DataParallelTrainer):
    _default_backend_config = TorchConfig


def prepare_model(model):
    """Wrap a torch.nn.Module for the gang (reference:
    `train/torch/train_loop_utils.py prepare_model`): moved to this worker's
    GPU when it holds one (an actor that holds none sees no device), and DDP
    when a process group is up."""
    import torch
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    device_ids = None
    if torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
        model = model.to(device)
        device_ids = [device.index]
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return DistributedDataParallel(model, device_ids=device_ids)
    return model


def prepare_data_loader(loader):
    """Give a DataLoader a DistributedSampler over the gang (reference:
    `train_loop_utils.py prepare_data_loader`)."""
    import torch.distributed as dist
    from torch.utils.data import DataLoader
    from torch.utils.data.distributed import DistributedSampler

    if not (dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1):
        return loader
    from torch.utils.data import RandomSampler

    if isinstance(loader.sampler, DistributedSampler):
        return loader
    # Preserve the loader's ordering intent: only shuffled loaders stay
    # shuffled (reference: prepare_data_loader passes
    # shuffle=isinstance(sampler, RandomSampler)).
    shuffle = isinstance(loader.sampler, RandomSampler)
    return DataLoader(
        loader.dataset,
        batch_size=loader.batch_size,
        sampler=DistributedSampler(loader.dataset, shuffle=shuffle),
        num_workers=loader.num_workers,
        collate_fn=loader.collate_fn,
        drop_last=loader.drop_last,
    )
