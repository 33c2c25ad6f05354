"""Base collective group interface (reference:
`python/ray/util/collective/collective_group/base_collective_group.py`)."""

from __future__ import annotations

from abc import ABC, abstractmethod

from ray_tpu_torch.util.collective.types import ReduceOp


class BaseGroup(ABC):
    def __init__(self, world_size: int, rank: int, group_name: str):
        self.world_size = world_size
        self.rank = rank
        self.group_name = group_name

    @abstractmethod
    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM):
        ...

    @abstractmethod
    def barrier(self):
        ...

    @abstractmethod
    def reduce(self, tensor, root_rank: int = 0, op: ReduceOp = ReduceOp.SUM):
        ...

    @abstractmethod
    def broadcast(self, tensor, root_rank: int = 0):
        ...

    @abstractmethod
    def allgather(self, tensor):
        ...

    @abstractmethod
    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM):
        ...

    @abstractmethod
    def send(self, tensor, dst_rank: int):
        ...

    @abstractmethod
    def recv(self, shape, dtype, src_rank: int):
        ...

    def destroy(self):
        pass
