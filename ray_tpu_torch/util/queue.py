"""Distributed FIFO queue backed by an actor.

Reference: `python/ray/util/queue.py` (`Queue` fronting a `_QueueActor`).
The queue state lives in one actor; every client handle (driver, tasks,
other actors — the handle pickles) talks to the same actor, so puts and gets
compose across the cluster. Blocking calls park in the actor's threaded call
pool rather than busy-polling.
"""

from __future__ import annotations

import queue as _stdlib_queue
from typing import Any, Dict, Iterable, List, Optional

import ray_tpu_torch


class Empty(_stdlib_queue.Empty):
    """Raised by non-blocking/timed get on an empty queue."""


class Full(_stdlib_queue.Full):
    """Raised by non-blocking/timed put on a full queue."""


class _QueueActor:
    """Holds the actual queue. Threaded (max_concurrency) so a parked
    blocking get doesn't stall concurrent puts."""

    def __init__(self, maxsize: int = 0):
        self._q: "_stdlib_queue.Queue" = _stdlib_queue.Queue(maxsize)

    def qsize(self) -> int:
        return self._q.qsize()

    def empty(self) -> bool:
        return self._q.empty()

    def full(self) -> bool:
        return self._q.full()

    def put(self, item: Any, timeout: Optional[float] = None) -> None:
        try:
            self._q.put(item, block=timeout != 0, timeout=timeout or None)
        except _stdlib_queue.Full:
            raise Full from None

    def get(self, timeout: Optional[float] = None) -> Any:
        try:
            return self._q.get(block=timeout != 0, timeout=timeout or None)
        except _stdlib_queue.Empty:
            raise Empty from None

    def put_nowait(self, item: Any) -> None:
        try:
            self._q.put_nowait(item)
        except _stdlib_queue.Full:
            raise Full from None

    def put_nowait_batch(self, items: List[Any]) -> None:
        # All-or-nothing, like the reference: partial batch puts are
        # impossible to reason about for the caller.
        if self._q.maxsize and self._q.qsize() + len(items) > self._q.maxsize:
            raise Full(
                f"batch of {len(items)} does not fit in queue "
                f"(size {self._q.qsize()}/{self._q.maxsize})"
            )
        for item in items:
            self._q.put_nowait(item)

    def get_nowait(self) -> Any:
        try:
            return self._q.get_nowait()
        except _stdlib_queue.Empty:
            raise Empty from None

    def get_nowait_batch(self, num_items: int) -> List[Any]:
        if self._q.qsize() < num_items:
            raise Empty(
                f"requested {num_items} items, queue has {self._q.qsize()}"
            )
        return [self._q.get_nowait() for _ in range(num_items)]


class Queue:
    def __init__(self, maxsize: int = 0, actor_options: Optional[Dict] = None):
        opts = dict(actor_options or {})
        opts.setdefault("num_cpus", 0.1)
        # Parked blocking calls each hold one call-pool slot.
        opts.setdefault("max_concurrency", 64)
        self.maxsize = maxsize
        self.actor = ray_tpu_torch.remote(_QueueActor).options(**opts).remote(maxsize)

    def __len__(self) -> int:
        return self.size()

    def size(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def qsize(self) -> int:
        return self.size()

    def empty(self) -> bool:
        return ray_tpu_torch.get(self.actor.empty.remote())

    def full(self) -> bool:
        return ray_tpu_torch.get(self.actor.full.remote())

    def put(self, item: Any, block: bool = True, timeout: Optional[float] = None) -> None:
        if not block:
            ray_tpu_torch.get(self.actor.put_nowait.remote(item))
        else:
            if timeout is not None and timeout < 0:
                raise ValueError("'timeout' must be a non-negative number")
            ray_tpu_torch.get(self.actor.put.remote(item, timeout))

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        if not block:
            return ray_tpu_torch.get(self.actor.get_nowait.remote())
        if timeout is not None and timeout < 0:
            raise ValueError("'timeout' must be a non-negative number")
        return ray_tpu_torch.get(self.actor.get.remote(timeout))

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def put_nowait_batch(self, items: Iterable) -> None:
        ray_tpu_torch.get(self.actor.put_nowait_batch.remote(list(items)))

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def get_nowait_batch(self, num_items: int) -> List[Any]:
        return ray_tpu_torch.get(self.actor.get_nowait_batch.remote(num_items))

    def shutdown(self, force: bool = False, grace_period_s: float = 5.0) -> None:
        """Kill the backing actor; pending queue contents are lost."""
        if self.actor is not None:
            if force:
                ray_tpu_torch.kill(self.actor)
            else:
                # Let in-flight calls drain briefly, then kill.
                try:
                    ray_tpu_torch.get(
                        self.actor.qsize.remote(), timeout=grace_period_s
                    )
                except Exception:
                    pass
                ray_tpu_torch.kill(self.actor)
            self.actor = None
