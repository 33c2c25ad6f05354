"""Collective communication among actors and tasks: the counterpart of
``ray_tpu/util/collective``. ``init_collective_group(backend="nccl")`` makes a
device group over ``torch.distributed`` (``device="cpu"`` runs it on gloo);
``backend="tcp"`` a host-data group over sockets. ``rendezvous.py`` is the KV
rendezvous both use, and whose waits the Train stack reads.
"""

from ray_tpu_torch.util.collective.collective import (
    allgather,
    allgather_multidevice,
    allreduce,
    allreduce_multidevice,
    barrier,
    broadcast,
    destroy_collective_group,
    get_collective_group_size,
    get_group,
    get_rank,
    init_collective_group,
    is_group_initialized,
    recv,
    reduce,
    reducescatter,
    reducescatter_multidevice,
    send,
    sendrecv,
)
from ray_tpu_torch.util.collective.types import Backend, ReduceOp

__all__ = [
    "Backend",
    "ReduceOp",
    "allgather",
    "allgather_multidevice",
    "allreduce",
    "allreduce_multidevice",
    "barrier",
    "broadcast",
    "destroy_collective_group",
    "get_collective_group_size",
    "get_group",
    "get_rank",
    "init_collective_group",
    "is_group_initialized",
    "recv",
    "reduce",
    "reducescatter",
    "reducescatter_multidevice",
    "send",
    "sendrecv",
]
