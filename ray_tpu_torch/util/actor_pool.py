"""Operate on a fixed pool of actors with a work-stealing submit/collect loop.

Reference: `python/ray/util/actor_pool.py` (`ActorPool`). `fn(actor, value)`
submits one call on a free actor and the pool hands results back either in
submission order (`map`/`get_next`) or completion order (`map_unordered`/
`get_next_unordered`).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Iterator, List, Optional, TypeVar

import ray_tpu_torch

V = TypeVar("V")
R = TypeVar("R")


class ActorPool:
    def __init__(self, actors: list):
        self._idle: List[Any] = list(actors)
        # future -> (submission index, actor)
        self._inflight = {}
        # (fn, value, submission index) waiting for a free actor; indexed at
        # submit time so ordered results stay aligned when the pool saturates.
        self._pending = []
        self._next_index = 0
        self._next_return = 0  # next index get_next() must hand back
        self._ready = {}  # index -> future, completed (possibly out of order)

    # ------------------------------------------------------------------- map
    def map(self, fn: Callable[[Any, V], Any], values: List[V]) -> Iterator[R]:
        """Results in submission order (head-of-line blocking on stragglers)."""
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable[[Any, V], Any], values: List[V]) -> Iterator[R]:
        """Results in completion order."""
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    # ---------------------------------------------------------------- submit
    def submit(self, fn: Callable[[Any, V], Any], value: V) -> None:
        if self._idle:
            actor = self._idle.pop()
            future = fn(actor, value)
            self._inflight[future] = (self._next_index, actor)
        else:
            self._pending.append((fn, value, self._next_index))
        self._next_index += 1

    def _drain_pending(self) -> None:
        while self._pending and self._idle:
            fn, value, idx = self._pending.pop(0)
            actor = self._idle.pop()
            future = fn(actor, value)
            self._inflight[future] = (idx, actor)

    def has_next(self) -> bool:
        return bool(self._inflight or self._pending or self._ready)

    # ----------------------------------------------------------------- fetch
    def get_next(self, timeout: Optional[float] = None,
                 ignore_if_timedout: bool = False) -> Any:
        """Next result in submission order."""
        if not self.has_next():
            raise StopIteration("No more results to get")
        idx = self._next_return
        deadline = None if timeout is None else time.monotonic() + timeout
        while idx not in self._ready:
            remaining = (
                None if deadline is None
                else max(0.0, deadline - time.monotonic())
            )
            self._wait_one(remaining)
            if (
                idx not in self._ready
                and deadline is not None
                and time.monotonic() >= deadline
            ):
                if ignore_if_timedout:
                    return None
                raise TimeoutError(f"Timed out waiting for result {idx}")
        future = self._ready.pop(idx)
        self._next_return += 1
        return ray_tpu_torch.get(future)

    def get_next_unordered(self, timeout: Optional[float] = None,
                           ignore_if_timedout: bool = False) -> Any:
        """Next result in completion order."""
        if not self.has_next():
            raise StopIteration("No more results to get")
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._ready:
            remaining = (
                None if deadline is None
                else max(0.0, deadline - time.monotonic())
            )
            self._wait_one(remaining)
            if (
                not self._ready
                and deadline is not None
                and time.monotonic() >= deadline
            ):
                if ignore_if_timedout:
                    return None
                raise TimeoutError("Timed out waiting for any result")
        idx = min(self._ready)  # any completed index; min keeps it stable
        future = self._ready.pop(idx)
        if idx == self._next_return:
            self._next_return += 1
        return ray_tpu_torch.get(future)

    def _wait_one(self, timeout: Optional[float]) -> None:
        self._drain_pending()
        if not self._inflight:
            return
        done, _ = ray_tpu_torch.wait(
            list(self._inflight), num_returns=1, timeout=timeout
        )
        for future in done:
            idx, actor = self._inflight.pop(future)
            self._ready[idx] = future
            self._return_actor(actor)

    # ------------------------------------------------------------ pool admin
    def _return_actor(self, actor) -> None:
        self._idle.append(actor)
        self._drain_pending()

    def has_free(self) -> bool:
        return bool(self._idle) and not self._pending

    def pop_idle(self) -> Optional[Any]:
        """Remove and return an idle actor (None if all are busy)."""
        if self.has_free():
            return self._idle.pop()
        return None

    def push(self, actor) -> None:
        """Add an actor to the pool."""
        busy = {a for _, a in self._inflight.values()}
        if actor in self._idle or actor in busy:
            raise ValueError("Actor already belongs to current ActorPool")
        self._return_actor(actor)
