"""Unique identifiers for jobs, tasks, actors, objects, nodes and placement groups.

Design follows the reference's ID derivation scheme
(`src/ray/design_docs/id_specification.md`, `src/ray/common/id.h`):
ObjectIDs embed the TaskID of the task that created them plus a return/put index,
TaskIDs embed the ActorID (or a job-scoped driver task), and ActorIDs embed the JobID.
This keeps lineage recoverable from an ID alone, which the object-recovery path uses.

Sizes (bytes) mirror the reference: JobID=4, ActorID=16, TaskID=24, ObjectID=28.
"""

from __future__ import annotations

import os
import threading

JOB_ID_SIZE = 4
ACTOR_ID_UNIQUE_BYTES = 12
ACTOR_ID_SIZE = ACTOR_ID_UNIQUE_BYTES + JOB_ID_SIZE  # 16
TASK_ID_UNIQUE_BYTES = 8
TASK_ID_SIZE = TASK_ID_UNIQUE_BYTES + ACTOR_ID_SIZE  # 24
OBJECT_ID_INDEX_BYTES = 4
OBJECT_ID_SIZE = TASK_ID_SIZE + OBJECT_ID_INDEX_BYTES  # 28
NODE_ID_SIZE = 16
PLACEMENT_GROUP_ID_SIZE = 16
WORKER_ID_SIZE = 16

_lock = threading.Lock()
_counters: dict[str, int] = {}


_entropy_buf = b""
_entropy_off = 0


def _rand(n: int) -> bytes:
    """Batched entropy: one os.urandom syscall refills ~1k ids. ID minting is
    on the submission hot path (one task id + return ids per `.remote()`);
    a per-call urandom syscall costs more than the rest of the submit."""
    global _entropy_buf, _entropy_off
    with _lock:
        if _entropy_off + n > len(_entropy_buf):
            # max() so a request larger than the refill size still gets its
            # full n bytes rather than a silently-short slice.
            _entropy_buf = os.urandom(max(16384, n))
            _entropy_off = 0
        out = _entropy_buf[_entropy_off:_entropy_off + n]
        _entropy_off += n
        return out


if hasattr(os, "register_at_fork"):
    # A forked child must not replay the parent's entropy window.
    def _reset_entropy():
        global _entropy_buf, _entropy_off
        _entropy_buf = b""
        _entropy_off = 0

    os.register_at_fork(after_in_child=_reset_entropy)


class BaseID:
    SIZE = 0
    __slots__ = ("_binary",)

    def __init__(self, binary: bytes):
        if len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(binary)}"
            )
        self._binary = bytes(binary)

    @classmethod
    def _trusted(cls, binary: bytes):
        """Construct from internally-minted bytes, skipping length validation
        and the defensive copy. ID minting sits on the `.remote()` hot path
        (one task id + N return ids per submit); the dataclass-style checked
        __init__ costs more than the rest of the mint."""
        self = object.__new__(cls)
        self._binary = binary
        return self

    @classmethod
    def from_random(cls):
        return cls(_rand(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\xff" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._binary == b"\xff" * self.SIZE

    def binary(self) -> bytes:
        return self._binary

    def hex(self) -> str:
        return self._binary.hex()

    def __hash__(self):
        return hash(self._binary)

    def __eq__(self, other):
        return type(other) is type(self) and other._binary == self._binary

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._binary,))


class JobID(BaseID):
    SIZE = JOB_ID_SIZE

    @classmethod
    def from_int(cls, value: int):
        return cls(value.to_bytes(cls.SIZE, "little"))


class NodeID(BaseID):
    SIZE = NODE_ID_SIZE


class WorkerID(BaseID):
    SIZE = WORKER_ID_SIZE


class PlacementGroupID(BaseID):
    SIZE = PLACEMENT_GROUP_ID_SIZE


class ActorID(BaseID):
    SIZE = ACTOR_ID_SIZE

    @classmethod
    def of(cls, job_id: JobID):
        return cls(_rand(ACTOR_ID_UNIQUE_BYTES) + job_id.binary())

    @property
    def job_id(self) -> JobID:
        return JobID(self._binary[ACTOR_ID_UNIQUE_BYTES:])


class TaskID(BaseID):
    SIZE = TASK_ID_SIZE

    @classmethod
    def for_task(cls, actor_id: ActorID):
        """Derive a TaskID scoped to an actor (or the job driver pseudo-actor)."""
        return cls._trusted(_rand(TASK_ID_UNIQUE_BYTES) + actor_id._binary)

    @classmethod
    def for_driver(cls, job_id: JobID):
        driver_actor = ActorID(b"\x00" * ACTOR_ID_UNIQUE_BYTES + job_id.binary())
        return cls.for_task(driver_actor)

    @property
    def actor_id(self) -> ActorID:
        return ActorID._trusted(self._binary[TASK_ID_UNIQUE_BYTES:])


class ObjectID(BaseID):
    SIZE = OBJECT_ID_SIZE

    @classmethod
    def for_return(cls, task_id: TaskID, index: int):
        """Return object `index` of `task_id` (index >= 1, as in the reference)."""
        return cls._trusted(
            task_id._binary + index.to_bytes(OBJECT_ID_INDEX_BYTES, "little")
        )

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int):
        # Put objects use the high bit of the index to disambiguate from returns.
        idx = put_index | 0x8000_0000
        return cls._trusted(
            task_id._binary + idx.to_bytes(OBJECT_ID_INDEX_BYTES, "little")
        )

    @property
    def task_id(self) -> TaskID:
        return TaskID._trusted(self._binary[:TASK_ID_SIZE])

    @property
    def is_put(self) -> bool:
        idx = int.from_bytes(self._binary[TASK_ID_SIZE:], "little")
        return bool(idx & 0x8000_0000)
