"""Dynamic request batching: `@serve.batch`.

Reference: `python/ray/serve/batching.py` (`@serve.batch` — concurrent
single-item calls accumulate into one vectorized call of up to
`max_batch_size` items, flushed when full or after `batch_wait_timeout_s`).

GPU rationale: a replica serving single requests leaves the tensor cores
idle — batching N requests into one forward multiplies arithmetic intensity at the
cost of `batch_wait_timeout_s` latency. Pair with the deployment option
`max_concurrent_queries > 1` (threaded replica calls share one asyncio loop,
where the queue lives); with one-at-a-time replicas there is never a second
in-flight request to batch with. A torch forward blocks the replica's event
loop until its result is copied off the device, so requests arriving during
one batch's forward form the next batch.
"""

from __future__ import annotations

import inspect
from typing import Any, List, Optional, Tuple


class _BatchQueue:
    """Accumulates (item, future, enqueue_ts) triples on the running event
    loop; one drain task flushes full or timed-out batches through the
    wrapped function.

    Shedding: with `max_queue_len` set, a submit finding the queue at
    capacity is rejected IMMEDIATELY with RequestShedded (fast 503 at the
    front door) instead of deepening the backlog; with `shed_timeout_s`
    set, members that waited past it are shed individually at flush time —
    one slow batch must not time out every queued member behind it. A
    member is settled exactly once (executed OR shed): the shed scan runs
    after the batch is popped, and both paths guard on fut.done()."""

    def __init__(self, fn, max_batch_size: int, batch_wait_timeout_s: float,
                 max_queue_len: int = 0,
                 shed_timeout_s: Optional[float] = None):
        self._fn = fn
        self.max_batch_size = int(max_batch_size)
        self.batch_wait_timeout_s = float(batch_wait_timeout_s)
        self.max_queue_len = int(max_queue_len)
        self.shed_timeout_s = shed_timeout_s
        self._items: List[Tuple[Any, Any, float]] = []
        self._loop: Optional[Any] = None
        self._full: Optional[Any] = None
        self._drainer: Optional[Any] = None
        # Observability: sizes of executed batches (surfaced in tests and
        # debugging; the reference exposes similar counters via metrics).
        self.batch_sizes: List[int] = []
        # Members shed (queue cap + stale-wait), surfaced in tests/stats.
        self.shed_count = 0

    def _bind_loop(self, loop) -> None:
        """The Event (and the drainer task) belong to ONE event loop. A queue
        reused after its loop closed (asyncio.run called twice) rebinds
        cleanly when idle; mixing live loops with pending items cannot work —
        futures resolve only on their creating loop — so fail loudly instead
        of hanging the second caller forever."""
        import asyncio

        if self._loop is loop:
            return
        if self._items:
            if self._loop is not None and self._loop.is_closed():
                # The first loop died with items still queued (e.g. a caller
                # cancelled out of submit and asyncio.run tore down): their
                # waiters are gone with that loop — drop the orphans instead
                # of bricking the queue forever.
                self._items.clear()
            else:
                raise RuntimeError(
                    "@serve.batch queue used from a second event loop while "
                    "items are pending on the first"
                )
        self._loop = loop
        self._full = asyncio.Event()
        self._drainer = None

    async def submit(self, self_obj, item):
        import asyncio
        import time

        from ray_tpu_torch.serve._private.common import RequestShedded

        loop = asyncio.get_running_loop()
        self._bind_loop(loop)
        if self.max_queue_len and len(self._items) >= self.max_queue_len:
            from ray_tpu_torch._private.config import get_config

            # Admission control at the queue door: shedding here is what
            # keeps a saturated batch deployment answering in O(1) instead
            # of timing out ALL queued members together.
            self.shed_count += 1
            raise RequestShedded(
                f"@serve.batch queue at capacity ({self.max_queue_len})",
                reason="batch_queue",
                retry_after_s=get_config().serve_retry_after_s,
            )
        fut = loop.create_future()
        self._items.append((item, fut, time.monotonic()))
        if len(self._items) >= self.max_batch_size:
            self._full.set()
        if self._drainer is None or self._drainer.done():
            self._drainer = loop.create_task(self._drain(self_obj))
        return await fut

    def _shed_stale(self, batch):
        """Split a popped batch into (live, shed) by shed_timeout_s. Runs
        AFTER the pop, so the flush timer and the shed race settle each
        future exactly once (both sides guard on fut.done())."""
        import time

        from ray_tpu_torch.serve._private.common import RequestShedded

        if self.shed_timeout_s is None:
            return batch
        from ray_tpu_torch._private.config import get_config

        retry_after = get_config().serve_retry_after_s
        now = time.monotonic()
        live = []
        for item, fut, ts in batch:
            if now - ts > self.shed_timeout_s:
                self.shed_count += 1
                if not fut.done():
                    fut.set_exception(RequestShedded(
                        f"@serve.batch member waited "
                        f"{now - ts:.3f}s > shed_timeout_s="
                        f"{self.shed_timeout_s}", reason="batch_queue",
                        retry_after_s=retry_after,
                    ))
            else:
                live.append((item, fut, ts))
        return live

    async def _drain(self, self_obj) -> None:
        import asyncio

        while self._items:
            if len(self._items) < self.max_batch_size:
                try:
                    await asyncio.wait_for(
                        self._full.wait(), self.batch_wait_timeout_s
                    )
                except asyncio.TimeoutError:
                    pass
            self._full.clear()
            batch = self._items[: self.max_batch_size]
            del self._items[: len(batch)]
            batch = self._shed_stale(batch)
            if not batch:
                continue
            items = [it for it, _, _ in batch]
            try:
                if self_obj is not None:
                    results = await self._fn(self_obj, items)
                else:
                    results = await self._fn(items)
                if not isinstance(results, (list, tuple)) or len(results) != len(
                    items
                ):
                    raise TypeError(
                        "@serve.batch function must return a list with one "
                        f"result per input ({len(items)} expected, got "
                        f"{type(results).__name__}"
                        + (
                            f" of length {len(results)}"
                            if isinstance(results, (list, tuple))
                            else ""
                        )
                        + ")"
                    )
            except Exception as e:  # noqa: BLE001 — every waiter sees the error
                for _, fut, _ in batch:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            self.batch_sizes.append(len(items))
            for (_, fut, _), res in zip(batch, results):
                if not fut.done():
                    fut.set_result(res)


class _BatchWrapper:
    """Descriptor form of @serve.batch: binding to an instance lazily creates
    that instance's queue (replicas must not share batches across instances)."""

    def __init__(self, fn, max_batch_size: int, batch_wait_timeout_s: float,
                 max_queue_len: int = 0,
                 shed_timeout_s: Optional[float] = None):
        self._fn = fn
        self._max = max_batch_size
        self._wait = batch_wait_timeout_s
        self._max_queue = max_queue_len
        self._shed_timeout = shed_timeout_s
        self._queue_attr = f"__serve_batch_queue_{fn.__name__}__"
        self._free_queue: Optional[_BatchQueue] = None
        self.__name__ = fn.__name__
        self.__doc__ = fn.__doc__

    def _make_queue(self) -> _BatchQueue:
        return _BatchQueue(
            self._fn, self._max, self._wait,
            max_queue_len=self._max_queue, shed_timeout_s=self._shed_timeout,
        )

    def _instance_queue(self, obj) -> _BatchQueue:
        q = obj.__dict__.get(self._queue_attr)
        if q is None:
            q = self._make_queue()
            obj.__dict__[self._queue_attr] = q
        return q

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self

        async def bound(item):
            return await self._instance_queue(obj).submit(obj, item)

        bound.__name__ = self.__name__
        bound._batch_queue = self._instance_queue(obj)
        return bound

    async def __call__(self, item):
        # Free-function form: one module-level queue.
        if self._free_queue is None:
            self._free_queue = self._make_queue()
        return await self._free_queue.submit(None, item)


def batch(_func=None, *, max_batch_size: int = 10,
          batch_wait_timeout_s: float = 0.01,
          max_queue_len: int = 0,
          shed_timeout_s: Optional[float] = None):
    """Decorate an `async def` taking a LIST of items (after self) so that
    concurrent single-item calls coalesce into one call of the underlying
    function. Callers invoke it with ONE item and await one result.

        class Model:
            @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.05)
            async def predict(self, inputs: list) -> list: ...
            async def __call__(self, request):
                return await self.predict(request)

    With `max_queue_len`, submits finding the queue at capacity shed
    immediately (RequestShedded -> 503 + Retry-After at the front door);
    with `shed_timeout_s`, members that waited past it shed individually at
    flush time instead of the whole batch timing out together.
    """
    if max_batch_size < 1:
        raise ValueError("max_batch_size must be >= 1")
    if batch_wait_timeout_s < 0:
        raise ValueError("batch_wait_timeout_s must be >= 0")
    if max_queue_len < 0:
        raise ValueError("max_queue_len must be >= 0 (0 = unbounded)")
    if shed_timeout_s is not None and shed_timeout_s < 0:
        raise ValueError("shed_timeout_s must be >= 0")

    def deco(fn):
        if not inspect.iscoroutinefunction(fn):
            raise TypeError("@serve.batch requires an `async def` function")
        return _BatchWrapper(
            fn, max_batch_size, batch_wait_timeout_s,
            max_queue_len=max_queue_len, shed_timeout_s=shed_timeout_s,
        )

    return deco if _func is None else deco(_func)
