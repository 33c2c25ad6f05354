"""Replica: the actor wrapping one copy of a deployment's user callable.

Reference: `python/ray/serve/_private/replica.py:276` (`RayServeReplica`) —
resolves the user class/function, injects handle arguments, executes requests.
By default one request at a time (the actor's ordered queue) with concurrency
from replica count, balanced by the router's power-of-two choice; the
deployment option `max_concurrent_queries > 1` runs calls on a thread pool
(async user methods then share the actor's one event loop — where
`@serve.batch` queues accumulate).
"""

from __future__ import annotations

import itertools
import time
from typing import Any, Dict, Tuple


class ServeReplica:
    def __init__(self, deployment_name: str, blob: bytes, init_args: Tuple,
                 init_kwargs: Dict[str, Any],
                 max_concurrent_queries: int = 1):
        import threading
        from concurrent.futures import ThreadPoolExecutor

        from ray_tpu_torch._private import serialization

        # Graceful-drain bookkeeping: requests EXECUTING right now (calls
        # still parked in the actor's ordered queue are counted by the
        # scheduler's ActorRecord — the controller polls that side). The
        # draining flag is set out-of-band by the worker's reader thread
        # (serve_drain tag) or via prepare_drain(); stragglers routed by a
        # not-yet-pushed table still run — drain never drops admitted work.
        self._active = 0
        self._active_lock = threading.Lock()
        self._draining = False
        self.deployment_name = deployment_name
        target = serialization.loads(blob)
        # A raising user constructor is kept, not raised: the runtime would
        # report the creation failed without its cause. ready() raises it.
        self._init_error = None
        self._callable = None
        if isinstance(target, type):
            try:
                self._callable = target(*init_args, **init_kwargs)
            except Exception:  # noqa: BLE001 — re-raised by ready()
                import traceback

                self._init_error = traceback.format_exc()
        else:
            if init_args or init_kwargs:
                raise ValueError("function deployments take no init args")
            self._callable = target
        # Lock-free under concurrent calls (threaded replicas).
        self._request_counter = itertools.count(1)
        self._requests = 0
        # Sync user code dispatched off the shared event loop runs HERE,
        # sized to the deployment's concurrency contract — the loop's default
        # executor caps at min(32, cpus+4) and is shared with sync-generator
        # chunk iteration, which would head-of-line block streams.
        self._sync_executor = ThreadPoolExecutor(
            max_workers=max(1, int(max_concurrent_queries)),
            thread_name_prefix=f"replica-sync-{deployment_name}",
        )
        self._started = time.time()

    def ready(self) -> bool:
        """The controller's readiness probe: raises ReplicaConstructorError
        when the user constructor raised."""
        if self._init_error is not None:
            from ray_tpu_torch.serve._private.common import ReplicaConstructorError

            raise ReplicaConstructorError(self.deployment_name, self._init_error)
        return True

    def _count_request(self) -> None:
        self._requests = next(self._request_counter)

    # --------------------------------------------------------------- draining
    def _admit(self) -> None:
        with self._active_lock:
            self._active += 1

    def _release(self) -> None:
        with self._active_lock:
            self._active -= 1

    def _serve_begin_drain(self) -> None:
        """Out-of-band drain hook (worker reader thread, serve_drain tag)."""
        self._draining = True

    def _serve_inflight(self) -> int:
        return self._active

    def prepare_drain(self) -> int:
        """Actor-call form of the drain flag (threaded replicas; the wire
        form covers max_concurrency=1 replicas whose call queue is busy)."""
        self._draining = True
        return self._active

    async def _release_after(self, coro):
        # An async user method: the load unit must live until the coroutine
        # actually finishes, not until handle_request returns it.
        try:
            return await coro
        finally:
            self._release()

    def _resolve(self, method_name: str):
        if method_name == "__call__":
            target = self._callable
            if not callable(target):
                raise AttributeError(
                    f"deployment {self.deployment_name} object is not callable"
                )
            return target
        return getattr(self._callable, method_name)

    def handle_request(self, method_name: str, args: Tuple, kwargs: Dict[str, Any]):
        import inspect

        self._admit()
        try:
            out = self._handle_request_inner(method_name, args, kwargs)
        except BaseException:
            self._release()
            raise
        if inspect.iscoroutine(out):
            return self._release_after(out)
        self._release()
        return out

    def _handle_request_inner(self, method_name: str, args: Tuple,
                              kwargs: Dict[str, Any]):
        import inspect

        from ray_tpu_torch.serve.multiplex import (
            MODEL_ID_KWARG,
            _reset_model_id,
            _run_with_model_id,
            _set_model_id,
        )

        self._count_request()
        model_id = kwargs.pop(MODEL_ID_KWARG, "")
        target = self._resolve(method_name)
        if not model_id:
            return target(*args, **kwargs)
        # Async: the ctxvar set must live inside the ONE task that drives the
        # user coroutine (task contexts persist across suspensions). Sync:
        # set/reset around the call in this thread.
        fn = target if inspect.isroutine(target) else getattr(
            target, "__call__", target
        )
        if inspect.iscoroutinefunction(fn):
            return _run_with_model_id(model_id, target(*args, **kwargs))
        token = _set_model_id(model_id)
        try:
            return target(*args, **kwargs)
        finally:
            _reset_model_id(token)

    async def handle_request_stream(self, method_name: str, args: Tuple,
                                    kwargs: Dict[str, Any]):
        self._admit()
        try:
            async for ev in self._handle_request_stream_inner(
                method_name, args, kwargs
            ):
                yield ev
        finally:
            self._release()

    async def _handle_request_stream_inner(self, method_name: str, args: Tuple,
                                           kwargs: Dict[str, Any]):
        """Streaming variant (called with num_returns="streaming"): a user
        method returning a generator streams each item as its own object; a
        plain return streams one ("single", value) event. First element of
        each event tells the consumer which case it is (reference: streaming
        deployment responses, `_private/replica.py` CallableWrapper gen path).

        An ASYNC generator: the worker drives it on the actor's shared event
        loop, so `async def` deployments (and their `@serve.batch` queues,
        which must see every concurrent request on ONE loop) work over the
        proxy's streaming path, not just the handle path. SYNC user code must
        never run on that shared loop — a blocking `def __call__` would
        serialize every concurrent request and starve pending batch drains —
        so sync targets (and sync-generator iteration) are pushed to the
        loop's thread pool."""
        import asyncio
        import functools
        import inspect

        from ray_tpu_torch.serve.multiplex import (
            MODEL_ID_KWARG,
            _reset_model_id,
            _run_with_model_id,
            _set_model_id,
        )

        target = self._resolve(method_name)
        self._count_request()
        model_id = kwargs.pop(MODEL_ID_KWARG, "")
        # Class deployments resolve "__call__" to the INSTANCE: the async
        # check must look at its __call__ method, not the object.
        fn = target if inspect.isroutine(target) else getattr(
            target, "__call__", target
        )
        if inspect.iscoroutinefunction(fn) or inspect.isasyncgenfunction(fn):
            out = target(*args, **kwargs)
        else:
            def _call_sync():
                # Executor thread: set/reset the model-id ctxvar around the
                # user call (each pooled thread has its own context).
                if not model_id:
                    return target(*args, **kwargs)
                token = _set_model_id(model_id)
                try:
                    return target(*args, **kwargs)
                finally:
                    _reset_model_id(token)

            import contextvars

            loop = asyncio.get_running_loop()
            # copy_context: run_in_executor does NOT propagate contextvars,
            # and the request's ambient trace context (tracing.context_scope
            # set by the worker's coroutine driver) must reach the user call
            # so nested .remote()s join the request's trace.
            cctx = contextvars.copy_context()
            out = await loop.run_in_executor(
                self._sync_executor, functools.partial(cctx.run, _call_sync)
            )
        if inspect.iscoroutine(out):
            if model_id:
                # ensure_future: the user coroutine runs as ONE task whose
                # context (with the model id set) is stable across every
                # suspension — this async-generator frame itself resumes
                # under a FRESH context per __anext__ and cannot hold it.
                out = await asyncio.ensure_future(
                    _run_with_model_id(model_id, out)
                )
            else:
                out = await out
        if inspect.isgenerator(out):
            loop = asyncio.get_running_loop()
            sentinel = object()

            def _next():
                # Sync generator frames resume in THIS executor thread: set
                # the model id around each pull so the body sees it.
                if not model_id:
                    return next(out, sentinel)
                token = _set_model_id(model_id)
                try:
                    return next(out, sentinel)
                finally:
                    _reset_model_id(token)

            import contextvars

            gctx = contextvars.copy_context()
            while True:
                # Same contextvar propagation as the sync call above: the
                # generator body resumes on an executor thread and may make
                # nested traced calls.
                item = await loop.run_in_executor(
                    self._sync_executor, functools.partial(gctx.run, _next)
                )
                if item is sentinel:
                    break
                yield ("chunk", item)
        elif inspect.isasyncgen(out):
            if model_id:
                # Pump the user async-gen inside ONE task (stable context
                # carrying the model id); this frame resumes under a fresh
                # context per __anext__ and cannot hold the ctxvar itself.
                done = object()
                q: "asyncio.Queue" = asyncio.Queue(maxsize=2)

                async def _pump():
                    token = _set_model_id(model_id)
                    try:
                        async for item in out:
                            await q.put(("chunk", item))
                        await q.put((done, None))
                    except Exception as e:  # noqa: BLE001 — relayed below
                        await q.put(("err", e))
                    finally:
                        _reset_model_id(token)

                task = asyncio.ensure_future(_pump())
                try:
                    while True:
                        kind, item = await q.get()
                        if kind is done:
                            break
                        if kind == "err":
                            raise item
                        yield ("chunk", item)
                finally:
                    task.cancel()
            else:
                async for item in out:
                    yield ("chunk", item)
        else:
            yield ("single", out)

    def handle_asgi(self, scope: Dict[str, Any], body: bytes):
        self._admit()
        try:
            yield from self._handle_asgi_inner(scope, body)
        finally:
            self._release()

    def _handle_asgi_inner(self, scope: Dict[str, Any], body: bytes):
        """Run one HTTP request through the deployment's ASGI app, yielding
        ASGI messages ({"type": "http.response.start"/"http.response.body"})
        as the app sends them — consumed by the proxy over a streaming actor
        call, so chunked/SSE responses stream end-to-end (reference:
        `serve.ingress` ASGI mounting, `python/ray/serve/api.py:160` +
        `http_util.py ASGIReceiveProxy`)."""
        import asyncio
        import queue as q
        import threading

        app = getattr(self._callable, "__serve_asgi_app__", None)
        if app is None:
            raise AttributeError(
                f"deployment {self.deployment_name} is not an ASGI ingress "
                "(decorate the class with @serve.ingress(app))"
            )
        self._count_request()
        # Rebuild bytes-typed scope fields lost to the wire format.
        scope = dict(scope)
        scope["query_string"] = scope.get("query_string", b"") or b""
        scope["headers"] = [
            (k.encode() if isinstance(k, str) else k,
             v.encode() if isinstance(v, str) else v)
            for k, v in scope.get("headers", [])
        ]
        events: "q.Queue" = q.Queue()
        _END = object()
        got_body = {"v": False}
        response_done: Dict[str, Any] = {"event": None}

        async def receive():
            # First call: the (complete) request body. Later calls park until
            # the response finishes, then deliver http.disconnect — this
            # serves both disconnect-watch patterns: a side task (an ASGI
            # framework's listen_for_disconnect) parks harmlessly, and a main-coroutine
            # `send everything, then await receive()` unblocks at the end.
            # A hot-returning receive would spin and starve the response task.
            if not got_body["v"]:
                got_body["v"] = True
                return {"type": "http.request", "body": body, "more_body": False}
            import asyncio as aio

            if response_done["event"] is None:
                response_done["event"] = aio.Event()
            await response_done["event"].wait()
            return {"type": "http.disconnect"}

        async def send(message):
            events.put(message)
            if message.get("type") == "http.response.body" and not message.get(
                "more_body", False
            ):
                ev = response_done["event"]
                if ev is None:
                    import asyncio as aio

                    response_done["event"] = ev = aio.Event()
                ev.set()

        # Multiplexed routing over ASGI: the header sets the request context
        # (the app coroutine runs as one task in this private loop, so the
        # ctxvar set in the runner thread is captured for its whole life).
        from ray_tpu_torch.serve.multiplex import MODEL_ID_HEADER, _set_model_id

        model_id = ""
        for k, v in scope["headers"]:
            if k.decode().lower() == MODEL_ID_HEADER:
                model_id = v.decode()
                break

        # The app coroutine runs on its own thread: hand it the request's
        # ambient trace context so nested traced calls join the trace.
        from ray_tpu_torch.util import tracing

        trace_ctx = (
            tracing.current_trace_context() if tracing.is_enabled() else None
        )

        def run():
            if model_id:
                _set_model_id(model_id)
            loop = asyncio.new_event_loop()
            try:
                with tracing.context_scope(trace_ctx):
                    loop.run_until_complete(app(scope, receive, send))
            except Exception as e:  # noqa: BLE001 — surfaced as a 500 event
                events.put({"type": "asgi.error", "error": repr(e)})
            finally:
                loop.close()
                events.put(_END)

        threading.Thread(target=run, daemon=True, name="asgi-call").start()
        while True:
            ev = events.get()
            if ev is _END:
                return
            yield ev

    def stats(self) -> Dict[str, Any]:
        return {
            "deployment": self.deployment_name,
            "requests": self._requests,
            "inflight": self._active,
            "draining": self._draining,
            "uptime_s": time.time() - self._started,
        }

    def reconfigure(self, user_config: Any) -> None:
        if hasattr(self._callable, "reconfigure"):
            self._callable.reconfigure(user_config)
