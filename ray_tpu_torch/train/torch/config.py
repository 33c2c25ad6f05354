"""TorchConfig/_TorchBackend: torch.distributed process-group bring-up on the
worker gang.

Reference seam: `python/ray/train/torch/config.py` — `_TorchBackend.on_start`
(`:155`) runs `_setup_torch_process_group` (`:69`) on every worker with rank
0's address as master (`:113` `dist.init_process_group`). Same shape here:
rank 0's node hosts the TCP store; every worker enters init_process_group
concurrently (all-or-nothing gang).

The backend defaults to NCCL when the gang holds GPUs (`ScalingConfig(
use_gpu=True)`) and to gloo otherwise. A 1-worker gang makes no process group
until its loop asks for the mesh. Every process group is given its address,
world size and rank explicitly (`tcp://<rank 0's node>:<free port>`).

`TorchConfig.mesh_builder` (the counterpart of `JaxConfig.mesh_builder`,
`ray_tpu/train/jax/config.py`) lays the gang's ranks out as the
`ScalingConfig.mesh` axes, a `DeviceMesh` built in the session thread, on the
GPU (it raises without one) unless `TorchConfig(device="cpu")` asks for the CPU.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.train.backend import Backend, BackendConfig


def _init_torch_process_group(
    master_addr: str, master_port: int, rank: int, world_size: int, backend: str,
    timeout_s: float,
):
    import datetime
    import os

    import torch.distributed as dist

    if dist.is_initialized():
        return True
    os.environ["MASTER_ADDR"] = master_addr
    os.environ["MASTER_PORT"] = str(master_port)
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{master_addr}:{master_port}",
        rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return dist.is_initialized()


def _free_port_fn() -> int:
    import socket

    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _shutdown_torch_process_group():
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _build_mesh(mesh_axes: Optional[Dict[str, int]], backend: str, device):
    """Session-thread mesh builder: the gang's process group -> DeviceMesh
    (pure data parallelism without ``mesh_axes``). A one-worker gang, which
    has no process group, makes a world of one first."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import MeshSpec

    if not dist.is_initialized():
        _init_torch_process_group("127.0.0.1", _free_port_fn(), 0, 1, backend, 60.0)
    world = dist.get_world_size()
    spec = MeshSpec.from_dict(mesh_axes) if mesh_axes else MeshSpec.for_data_parallel(world)
    if spec.num_devices != world:
        raise ValueError(
            f"ScalingConfig.mesh {mesh_axes} wants {spec.num_devices} devices "
            f"but the gang has {world}"
        )
    return spec.build(device)


@dataclass
class TorchConfig(BackendConfig):
    """backend: "nccl" or "gloo"; None (default) picks "nccl" when the gang
    holds GPUs, else "gloo". init_timeout_s: gang-join timeout for
    init_process_group. device: where ``session.get_mesh()`` lays the mesh;
    None (default) is the GPU, and ``"cpu"`` must be asked for."""

    backend: Optional[str] = None
    init_timeout_s: float = 120.0
    device: Optional[str] = None

    def resolve_backend(self, resources_per_worker) -> str:
        if self.backend is not None:
            return self.backend
        return "nccl" if (resources_per_worker or {}).get("GPU", 0) > 0 else "gloo"

    @property
    def backend_cls(self):
        return _TorchBackend

    def mesh_builder(self, scaling_config) -> Callable:
        """The session thread's mesh builder for a run of ``scaling_config``:
        its mesh axes over the gang, on ``self.device`` (the GPU unless the
        CPU is asked for)."""
        axes = None
        if scaling_config.mesh is not None:
            from ray_tpu_torch.parallel import AXIS_ORDER

            spec = scaling_config.mesh_spec()
            axes = {a: s for a, s in zip(AXIS_ORDER, spec.shape) if s > 1}
        backend = self.resolve_backend(scaling_config._resources)
        return functools.partial(_build_mesh, axes, backend, self.device)


class _TorchBackend(Backend):
    def on_start(self, executor, backend_config: TorchConfig):
        wg = executor.worker_group
        n = len(wg)
        if n <= 1:
            return  # single worker: torch works without a process group
        rank_of = executor.ranks
        rank0_index = rank_of.index(0)
        meta = wg._metadata or wg.fetch_metadata()
        port = wg.execute_single(rank0_index, _free_port_fn)
        addr = meta[rank0_index].node_ip
        refs = [
            w.execute.remote(
                _init_torch_process_group,
                addr,
                port,
                rank_of[i],
                n,
                backend_config.resolve_backend(executor._scaling._resources),
                backend_config.init_timeout_s,
            )
            for i, w in enumerate(wg.workers)
        ]
        oks = ray_tpu_torch.get(refs)
        if not all(oks):
            raise RuntimeError(f"torch process group failed to initialize: {oks}")

    def on_shutdown(self, executor, backend_config: TorchConfig):
        if executor.worker_group is not None:
            try:
                executor.worker_group.execute(_shutdown_torch_process_group)
            except Exception:
                pass
