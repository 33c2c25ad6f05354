"""Model multiplexing: many models per replica with LRU caching.

Reference: `python/ray/serve/api.py` `@serve.multiplexed` +
`serve.get_multiplexed_model_id()` (`_private/multiplex.py` — per-replica
LRU of loaded models keyed by the request's model id; the router prefers
replicas that already hold the model).

GPU rationale: one card serves MANY fine-tuned variants (LoRA adapters,
per-tenant heads) — reloading weights per request wastes host-to-device
bandwidth; the LRU keeps hot variants resident and model-affinity routing
(see `handle.py Router.route`) sends a model's traffic back to the replica
that already paid its load cost. An evicted model gives its device memory
back once the LRU drops its last reference (and `__serve_unload__` runs).
"""

from __future__ import annotations

import contextvars
from collections import OrderedDict
from typing import Any, Dict, Optional

#: Reserved kwarg smuggling the model id through the replica call protocol
#: (popped by ServeReplica before user code sees kwargs).
MODEL_ID_KWARG = "_serve_multiplexed_model_id"
#: HTTP header carrying the model id through the proxy (reference name).
MODEL_ID_HEADER = "serve_multiplexed_model_id"

_model_id_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "serve_multiplexed_model_id", default=""
)


def get_multiplexed_model_id() -> str:
    """The model id of the current request ("" when none was sent).
    Reference: `serve.get_multiplexed_model_id`."""
    return _model_id_ctx.get()


def _set_model_id(model_id: str):
    return _model_id_ctx.set(model_id)


def _reset_model_id(token) -> None:
    _model_id_ctx.reset(token)


async def _run_with_model_id(model_id: str, coro):
    """Drive a user coroutine with the model-id contextvar set. Run as ONE
    asyncio task so the set persists across every suspension of the user
    code (a task's context is stable for its whole life)."""
    token = _model_id_ctx.set(model_id)
    try:
        return await coro
    finally:
        _model_id_ctx.reset(token)


class _ModelCache:
    """Per-instance LRU of loaded models with single-flight loads."""

    def __init__(self, loader, self_obj, max_models: int):
        self._loader = loader
        self._self = self_obj
        self.max_models = max_models
        self._models: "OrderedDict[str, Any]" = OrderedDict()
        self._loading: Dict[str, Any] = {}  # model_id -> asyncio.Future

    def model_ids(self):
        return list(self._models)

    async def get(self, model_id: str):
        import asyncio

        if model_id in self._models:
            self._models.move_to_end(model_id)
            return self._models[model_id]
        pending = self._loading.get(model_id)
        if pending is not None:
            # Single-flight: concurrent requests for one model await the
            # same load instead of loading N copies.
            return await asyncio.shield(pending)
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._loading[model_id] = fut
        try:
            if self._self is not None:
                model = await self._loader(self._self, model_id)
            else:
                model = await self._loader(model_id)
        except BaseException as e:  # noqa: BLE001 — incl. CancelledError:
            # the single-flight future MUST resolve or every waiter that
            # grabbed it hangs forever (streaming disconnects cancel loads).
            if not fut.done():
                fut.set_exception(e)
            # Consume the exception so an un-awaited future doesn't warn.
            fut.exception()
            raise
        finally:
            self._loading.pop(model_id, None)
        self._models[model_id] = model
        self._models.move_to_end(model_id)
        while len(self._models) > self.max_models:
            _, evicted = self._models.popitem(last=False)
            unload = getattr(evicted, "__serve_unload__", None)
            if callable(unload):
                try:
                    out = unload()
                    if asyncio.iscoroutine(out):
                        await out
                except Exception:  # noqa: BLE001 — eviction is best-effort
                    pass
        if not fut.done():
            fut.set_result(model)
        return model


class _MultiplexWrapper:
    """Descriptor form of @serve.multiplexed: each instance owns its cache."""

    def __init__(self, fn, max_num_models_per_replica: int):
        self._fn = fn
        self._max = max_num_models_per_replica
        self._cache_attr = f"__serve_multiplex_cache_{fn.__name__}__"
        self.__name__ = fn.__name__
        self.__doc__ = fn.__doc__

    def _cache_for(self, obj) -> _ModelCache:
        c = obj.__dict__.get(self._cache_attr)
        if c is None:
            c = _ModelCache(self._fn, obj, self._max)
            obj.__dict__[self._cache_attr] = c
        return c

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        cache = self._cache_for(obj)

        async def bound(model_id: Optional[str] = None):
            if model_id is None:
                model_id = get_multiplexed_model_id()
            if not model_id:
                raise ValueError(
                    "no model id: pass one explicitly or send the request "
                    f"with a multiplexed model id (header {MODEL_ID_HEADER} "
                    "or handle.options(multiplexed_model_id=...))"
                )
            return await cache.get(model_id)

        bound.__name__ = self.__name__
        bound._model_cache = cache
        return bound


def multiplexed(_func=None, *, max_num_models_per_replica: int = 3):
    """Decorate an `async def (self, model_id) -> model` loader: calls are
    LRU-cached per replica (capacity `max_num_models_per_replica`), loads are
    single-flight, and evicted models get `__serve_unload__()` if defined.

        class Multi:
            @serve.multiplexed(max_num_models_per_replica=4)
            async def get_model(self, model_id: str): ...
            async def __call__(self, request):
                model = await self.get_model()  # id from the request context
    """
    import inspect

    if max_num_models_per_replica < 1:
        raise ValueError("max_num_models_per_replica must be >= 1")

    def deco(fn):
        if not inspect.iscoroutinefunction(fn):
            raise TypeError("@serve.multiplexed requires an `async def` loader")
        return _MultiplexWrapper(fn, max_num_models_per_replica)

    return deco if _func is None else deco(_func)
