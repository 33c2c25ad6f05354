"""Collective types (reference: `python/ray/util/collective/types.py`:
Backend enum NCCL/GLOO/MPI, ReduceOp): the counterpart of
``ray_tpu/util/collective/types.py``.

``"nccl"`` is the device backend (``NCCLGroup`` over ``torch.distributed``).
``"xla"``, the JAX package's device backend, is accepted and resolves to
NCCL, as the JAX package accepts ``"nccl"`` and resolves it to XLA.
``"tcp"`` and ``"gloo"`` name the host-data group over sockets (``TCPGroup``).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum


class Backend(str, Enum):
    NCCL = "nccl"  # device collectives over torch.distributed (NCCLGroup)
    TCP = "tcp"  # host-data collectives over sockets (replaces pygloo)
    # Accepted for API familiarity with the JAX package and the reference.
    XLA = "xla"
    GLOO = "gloo"

    @classmethod
    def resolve(cls, name: str) -> "Backend":
        b = cls(name.lower())
        if b == cls.XLA:
            return cls.NCCL
        if b == cls.GLOO:
            return cls.TCP
        return b


class ReduceOp(str, Enum):
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"
    MEAN = "mean"


@dataclass
class AllReduceOptions:
    reduceOp: ReduceOp = ReduceOp.SUM


@dataclass
class BarrierOptions:
    pass


@dataclass
class ReduceOptions:
    reduceOp: ReduceOp = ReduceOp.SUM
    root_rank: int = 0


@dataclass
class BroadcastOptions:
    root_rank: int = 0


@dataclass
class AllGatherOptions:
    pass


@dataclass
class ReduceScatterOptions:
    reduceOp: ReduceOp = ReduceOp.SUM
