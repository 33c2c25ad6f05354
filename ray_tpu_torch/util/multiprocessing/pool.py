"""Drop-in `multiprocessing.Pool` running on ray_tpu_torch actors.

Reference: `python/ray/util/multiprocessing/pool.py` (`Pool`, `AsyncResult`,
imap iterators). Each pool process is a `_PoolActor`; work is chunked and
round-robined over the actors, and the classic Pool surface (apply/map/
starmap, their `_async` variants, ordered/unordered imap) is implemented on
ObjectRefs instead of pipes. `processes=None` sizes the pool to the
cluster's CPU count like the reference (not the local host's).
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Iterable, List, Optional, Tuple

import ray_tpu_torch

__all__ = ["Pool", "AsyncResult", "TimeoutError"]

TimeoutError = ray_tpu_torch.exceptions.GetTimeoutError


class _PoolActor:
    """One pool process: runs chunks of (func, args, kwargs) calls."""

    def __init__(self, initializer=None, initargs=None):
        if initializer:
            initializer(*(initargs or ()))

    def ping(self):
        return "ok"

    def run_chunk(self, func, items: List[Tuple[tuple, dict]]) -> List[Any]:
        return [func(*args, **kwargs) for args, kwargs in items]

    def run_one(self, func, args, kwargs):
        return func(*args, **(kwargs or {}))


class AsyncResult:
    """Handle on in-flight pool work (reference: `AsyncResult`). `chunks` are
    ObjectRefs each resolving to a list of per-item results."""

    def __init__(self, chunk_refs: List[Any], callback=None, error_callback=None,
                 single: bool = False):
        self._chunk_refs = list(chunk_refs)
        self._single = single
        self._result: Optional[List[Any]] = None
        self._error: Optional[BaseException] = None
        self._done = threading.Event()
        self._callback = callback
        self._error_callback = error_callback
        threading.Thread(target=self._collect, daemon=True).start()

    def _collect(self):
        try:
            chunks = ray_tpu_torch.get(self._chunk_refs)
            if self._single:
                self._result = [chunks[0]]
            else:
                self._result = list(itertools.chain.from_iterable(chunks))
            if self._callback:
                self._callback(
                    self._result[0] if self._single else self._result
                )
        except BaseException as e:  # noqa: BLE001 — surfaced via get()
            self._error = e
            if self._error_callback:
                try:
                    self._error_callback(e)
                except Exception:
                    pass
        finally:
            self._done.set()

    def wait(self, timeout: Optional[float] = None) -> None:
        self._done.wait(timeout)

    def get(self, timeout: Optional[float] = None) -> Any:
        if not self._done.wait(timeout):
            raise TimeoutError("result not ready within timeout")
        if self._error is not None:
            raise self._error
        return self._result[0] if self._single else self._result

    def ready(self) -> bool:
        return self._done.is_set()

    def successful(self) -> bool:
        if not self.ready():
            raise ValueError("result is not ready")
        return self._error is None


class Pool:
    def __init__(
        self,
        processes: Optional[int] = None,
        initializer: Optional[Callable] = None,
        initargs: Optional[tuple] = None,
        maxtasksperchild: Optional[int] = None,  # accepted for parity; unused
        ray_remote_args: Optional[dict] = None,
    ):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        if processes is None:
            processes = max(1, int(ray_tpu_torch.cluster_resources().get("CPU", 1)))
        if processes < 1:
            raise ValueError("processes must be >= 1")
        opts = dict(ray_remote_args or {})
        opts.setdefault("num_cpus", 1)
        self._processes = processes
        self._actors = [
            ray_tpu_torch.remote(_PoolActor).options(**opts).remote(initializer, initargs)
            for _ in range(processes)
        ]
        ray_tpu_torch.get([a.ping.remote() for a in self._actors])
        self._rr = 0  # round-robin cursor
        self._closed = False

    # --------------------------------------------------------------- helpers
    def _next_actor(self):
        self._rr = (self._rr + 1) % len(self._actors)
        return self._actors[self._rr]

    def _check_running(self):
        if self._closed:
            raise ValueError("Pool not running")

    def _chunk(self, func, items: List[Tuple[tuple, dict]], chunksize: Optional[int]):
        if chunksize is None:
            # multiprocessing's heuristic: ~4 chunks per worker.
            chunksize, extra = divmod(len(items), len(self._actors) * 4)
            if extra:
                chunksize += 1
            chunksize = max(1, chunksize)
        refs = []
        for i in range(0, len(items), chunksize):
            refs.append(
                self._next_actor().run_chunk.remote(func, items[i:i + chunksize])
            )
        return refs

    # ----------------------------------------------------------------- apply
    def apply(self, func, args: tuple = (), kwds: Optional[dict] = None) -> Any:
        return self.apply_async(func, args, kwds).get()

    def apply_async(self, func, args: tuple = (), kwds: Optional[dict] = None,
                    callback=None, error_callback=None) -> AsyncResult:
        self._check_running()
        ref = self._next_actor().run_one.remote(func, args, kwds or {})
        return AsyncResult([ref], callback, error_callback, single=True)

    # ------------------------------------------------------------------- map
    def map(self, func, iterable: Iterable, chunksize: Optional[int] = None) -> List[Any]:
        return self.map_async(func, iterable, chunksize).get()

    def map_async(self, func, iterable: Iterable, chunksize: Optional[int] = None,
                  callback=None, error_callback=None) -> AsyncResult:
        self._check_running()
        items = [((x,), {}) for x in iterable]
        return AsyncResult(
            self._chunk(func, items, chunksize), callback, error_callback
        )

    def starmap(self, func, iterable: Iterable[tuple],
                chunksize: Optional[int] = None) -> List[Any]:
        return self.starmap_async(func, iterable, chunksize).get()

    def starmap_async(self, func, iterable: Iterable[tuple],
                      chunksize: Optional[int] = None,
                      callback=None, error_callback=None) -> AsyncResult:
        self._check_running()
        items = [(tuple(x), {}) for x in iterable]
        return AsyncResult(
            self._chunk(func, items, chunksize), callback, error_callback
        )

    # ------------------------------------------------------------------ imap
    def imap(self, func, iterable: Iterable, chunksize: int = 1):
        """Lazy ordered iterator over results."""
        self._check_running()
        items = [((x,), {}) for x in iterable]
        refs = self._chunk(func, items, chunksize)
        for ref in refs:
            for item in ray_tpu_torch.get(ref):
                yield item

    def imap_unordered(self, func, iterable: Iterable, chunksize: int = 1):
        """Lazy iterator over results in chunk-completion order."""
        self._check_running()
        items = [((x,), {}) for x in iterable]
        pending = self._chunk(func, items, chunksize)
        while pending:
            done, pending = ray_tpu_torch.wait(pending, num_returns=1)
            for item in ray_tpu_torch.get(done[0]):
                yield item

    # -------------------------------------------------------------- lifecycle
    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        self._closed = True
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
        self._actors = []

    def join(self) -> None:
        if not self._closed:
            raise ValueError("Pool is still running")
        # Actors drain synchronously per call; nothing further to wait on.
        for a in self._actors:
            try:
                ray_tpu_torch.get(a.ping.remote(), timeout=30)
            except Exception:
                pass
        self.terminate()

    def __enter__(self):
        self._check_running()
        return self

    def __exit__(self, *exc):
        self.terminate()

    def __del__(self):
        try:
            self._closed = True
        except Exception:
            pass
