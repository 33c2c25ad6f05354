"""DeploymentHandle + Router: the client-side request path.

Reference: `python/ray/serve/handle.py` + `_private/router.py:263` — a handle
routes each call to a replica via power-of-two-choices over the router's
outstanding-request counts. Replica membership is PUSHED: a background
listener parks in the controller's `listen_for_change` long poll (the client
half of the reference's LongPollHost, `long_poll.py:185`) and swaps the local
table the moment the replica set changes — no TTL staleness window. Dead
replicas are reported to the controller (which replaces them) and the call
retries on another replica.
"""

from __future__ import annotations

import random
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

_LOAD_REPORT_INTERVAL_S = 0.5
# Model-affinity escape hysteresis: the sticky replica keeps a model's
# traffic until its in-flight load exceeds the power-of-two alternative's by
# more than this (or hits max_concurrent_queries) — switching replicas pays a
# model reload, so a 1-request imbalance must not thrash the affinity map.
_AFFINITY_ESCAPE_THRESHOLD = 2

# Every live Router in this process; serve.shutdown() closes them so their
# long-poll listeners release controller call slots.
import weakref

_all_routers: "weakref.WeakSet" = weakref.WeakSet()

def _metrics():
    """Router metric set, or None when enable_metrics is off. The knob is
    re-read per call (an init/shutdown cycle may flip it); the metric
    objects themselves are cached inside telemetry.router_metrics()."""
    from ray_tpu_torch._private import telemetry

    return telemetry.router_metrics() if telemetry.metrics_enabled() else None


def close_all_routers() -> None:
    for r in list(_all_routers):
        r.close()


def _router_listen_loop(router_ref, deployment_name: str, controller):
    """Long-poll client parked at the controller. Holds only a WEAKREF to
    its router: when the last handle drops, the router is GC'd, its
    __del__ cancels the parked listener (cancel_listener) and this thread
    exits — controller call slots don't leak across app redeploys
    (previously the bound-method thread target kept every router alive
    forever)."""
    import ray_tpu_torch

    key = f"replicas::{deployment_name}"
    version = -1
    failures = 0
    while True:
        r = router_ref()
        if r is None or r._closed:
            return
        router_id = r._router_id
        del r  # never hold the router across the blocking poll
        try:
            updates = ray_tpu_torch.get(
                controller.listen_for_change.remote(
                    {key: version}, router_id
                ),
                timeout=60,
            )
            failures = 0
        except Exception:
            failures += 1
            if failures >= 6:
                # Controller gone (serve.shutdown without closing handles):
                # stop spinning; route() falls back to direct fetches.
                return
            time.sleep(0.5)
            continue
        r = router_ref()
        if r is None or r._closed:
            return
        if key in updates:
            version, replicas = updates[key]
            with r._lock:
                r._version = version
                r._replicas = replicas
            r._have_table.set()
        del r


class Router:
    def __init__(self, deployment_name: str, controller):
        self._name = deployment_name
        self._controller = controller
        self._router_id = uuid.uuid4().hex[:8]
        self._lock = threading.Lock()
        self._replicas: List = []  # ReplicaInfo
        self._version = -1  # -1 = never synced; first listen returns current
        self._have_table = threading.Event()
        self._inflight: Dict[str, List[Any]] = {}  # replica_id -> pending refs
        # Streaming calls have no single ref to sweep: consumers decrement
        # via stream_done() when the stream ends/closes, so load reports (and
        # with them autoscaling) see HTTP/streaming traffic too.
        self._inflight_streams: Dict[str, int] = {}
        # stream_done must be GC-safe (DeploymentResponseGenerator.__del__):
        # lock-free queue drained under the lock by _sweep.
        import collections

        self._stream_done_q: "collections.deque" = collections.deque()
        # Multiplexed model affinity: model_id -> replica_id that last served
        # it (its LRU holds the loaded weights; route traffic back there).
        # Bounded LRU: per-tenant one-shot ids must not grow the router
        # without limit.
        import collections as _c

        self._model_affinity: "_c.OrderedDict[str, str]" = _c.OrderedDict()
        self._model_affinity_cap = 4096
        self._last_load_report = 0.0
        # Route-wait samples (ts, seconds) for the windowed p95 reported to
        # the controller — the SLO-aware autoscaling signal. Own lock: the
        # append happens after route() releases self._lock, while the p95
        # scan iterates from under it — iterating a deque another thread is
        # appending to raises RuntimeError.
        import collections as _c2

        self._wait_samples: "_c2.deque" = _c2.deque(maxlen=2048)
        self._samples_lock = threading.Lock()
        self._closed = False
        _all_routers.add(self)
        threading.Thread(
            target=_router_listen_loop,
            args=(weakref.ref(self), deployment_name, controller),
            daemon=True, name=f"serve-listen-{deployment_name}",
        ).start()

    def close(self):
        if self._closed:
            return
        self._closed = True
        try:
            # Unpark this router's listener so its controller call slot
            # frees now, not at the next server-side timeout.
            self._controller.cancel_listener.remote(self._router_id)
        except Exception:
            pass

    def __del__(self):
        # GC-driven close (the weakref listen loop makes routers
        # collectable): a leaked slot per redeploy otherwise.
        try:
            self.close()
        except Exception:
            pass

    def _ensure_table(self, force: bool = False):
        """Ensure a table exists. Steady-state updates arrive via push; this
        only blocks on the very first request (or re-pulls after a reported
        failure, where waiting for the push would race the retry). MUST be
        called without self._lock held: the listener needs that lock to apply
        the push this may be waiting for."""
        import ray_tpu_torch

        if self._replicas and not force:
            return
        if not force and self._have_table.wait(timeout=5.0) and self._replicas:
            return
        replicas = ray_tpu_torch.get(self._controller.get_replicas.remote(self._name))
        with self._lock:
            if force or not self._replicas:
                self._replicas = replicas

    def _sweep(self):
        """Drop completed refs from the inflight books (lazy decrement) and
        apply queued stream completions."""
        import ray_tpu_torch

        while True:
            try:
                rid = self._stream_done_q.popleft()
            except IndexError:
                break
            n = self._inflight_streams.get(rid, 0)
            if n <= 1:
                self._inflight_streams.pop(rid, None)
            else:
                self._inflight_streams[rid] = n - 1
        for rid, refs in list(self._inflight.items()):
            if not refs:
                continue
            ready, not_ready = ray_tpu_torch.wait(
                refs, num_returns=len(refs), timeout=0
            )
            self._inflight[rid] = not_ready

    def _load_of(self, replica_id: str) -> int:
        return len(self._inflight.get(replica_id, [])) + self._inflight_streams.get(
            replica_id, 0
        )

    def _route_wait_p95(self) -> "Optional[tuple]":
        """(p95_seconds, exemplar_trace_id) of route-wait samples inside the
        SLO window (the route-wait histogram's signal, windowed locally so the
        controller sees CURRENT latency, not all-time). The exemplar is the
        trace id of the p95 sample itself (None when that request was
        untraced). None with no fresh samples."""
        from ray_tpu_torch._private.config import get_config

        cutoff = time.time() - float(get_config().serve_slo_window_s)
        with self._samples_lock:
            snapshot = list(self._wait_samples)
        recent = sorted(
            ((s[1], s[2] if len(s) > 2 else None)
             for s in snapshot if s[0] >= cutoff),
            key=lambda x: x[0],
        )
        if not recent:
            return None
        return recent[min(len(recent) - 1, int(0.95 * len(recent)))]

    def _report_load(self):
        now = time.time()
        if now - self._last_load_report < _LOAD_REPORT_INTERVAL_S:
            return
        self._last_load_report = now
        total = sum(len(v) for v in self._inflight.values()) + sum(
            self._inflight_streams.values()
        )
        sample = self._route_wait_p95()
        p95 = sample[0] if sample else None
        m = _metrics()
        if m is not None:
            # Replica saturation: this router's in-flight load over the
            # replica set's total concurrency capacity. Reported at load-
            # report cadence, not per request.
            capacity = sum(
                max(1, getattr(r, "max_concurrent_queries", 1))
                for r in self._replicas
            )
            tags = {"deployment": self._name}
            m["inflight"].set(total, tags)
            if capacity:
                m["saturation"].set(total / capacity, tags)
            if p95 is not None:
                # The p95 sample's own trace rides as the gauge exemplar, so
                # a firing route-wait SLO alert links to a concrete slow
                # trace (state.get_trace / /api/traces).
                m["slo_p95"].set(p95, tags, exemplar=sample[1])
        try:
            self._controller.report_load.remote(
                self._name, self._router_id, total, p95
            )
        except Exception:
            pass

    def stream_done(self, replica_id: str) -> None:
        """A streaming call finished or was dropped: release its load unit.
        Lock-free (callable from __del__); applied at the next _sweep."""
        self._stream_done_q.append(replica_id)

    def _maybe_shed_overload(self):
        """Per-replica inflight cap (admission control's router half): when
        EVERY replica is loaded past max_concurrent_queries * the cap
        factor, queueing deeper only grows tail latency — shed instead.
        Called under self._lock. Off by default (factor 0): the proxy's
        per-app cap is the primary gate; this one bounds the router's own
        books under direct-handle flood."""
        from ray_tpu_torch._private.config import get_config

        cfg = get_config()
        factor = float(cfg.serve_replica_inflight_cap_factor)
        if factor <= 0:
            return
        from ray_tpu_torch.serve._private.common import RequestShedded

        for r in self._replicas:
            cap = max(1, getattr(r, "max_concurrent_queries", 1)) * factor
            if self._load_of(r.replica_id) < cap:
                return
        from ray_tpu_torch._private import telemetry

        if telemetry.metrics_enabled():
            telemetry.serve_ingress_metrics()["shed"].inc(
                1, {"app": self._name, "reason": "replica_inflight"}
            )
        raise RequestShedded(
            f"all replicas of '{self._name}' at "
            f"max_concurrent_queries x {factor:g}",
            reason="replica_inflight",
            retry_after_s=cfg.serve_retry_after_s,
        )

    def route(self, method_name: str, args, kwargs, force_refresh: bool = False,
              stream: bool = False, raw_method: bool = False,
              trace_ctx: Optional[Dict[str, str]] = None):
        """Pick a replica (power of two choices) and submit.

        Returns ``(ref, replica_id)`` so the response can report the replica
        on actor-death and resubmit (dead-replica retry lives in
        DeploymentResponse.result()). With ``stream=True`` the first element
        is an ObjectRefGenerator from a streaming call to
        `handle_request_stream` (or to `method_name` itself when
        ``raw_method`` — the proxy's ASGI path). ``trace_ctx`` is the
        request's trace context handed down from the HTTP proxy (the root
        span owner): route() opens a "router" child span covering the
        route wait and scopes the replica submit under it, so the actor
        call's submit/execute spans join the SAME trace."""
        from ray_tpu_torch.util import tracing

        if trace_ctx is None:
            # Direct handle calls inside a traced caller (a replica fanning
            # out, a traced driver) still join the ambient trace.
            trace_ctx = tracing.current_trace_context()
        rspan = None
        if trace_ctx is not None and tracing.is_enabled():
            # Detached: route() may run on a shared event-loop thread; the
            # span must not leak into unrelated requests' thread-local state.
            rspan = tracing.start_span(
                f"route::{self._name}", "router", trace_context=trace_ctx,
                detached=True,
            )
        try:
            return self._route_inner(
                method_name, args, kwargs, force_refresh, stream, raw_method,
                trace_ctx, rspan,
            )
        except BaseException:
            # A shed/no-replica/submit failure must still close (and flush)
            # the router span: these are exactly the requests a trace is
            # supposed to explain.
            tracing.end_span(rspan, "ERROR")
            raise

    def _route_inner(self, method_name: str, args, kwargs,
                     force_refresh: bool, stream: bool, raw_method: bool,
                     trace_ctx, rspan):
        from ray_tpu_torch.actor import ActorHandle

        from ray_tpu_torch.serve.multiplex import MODEL_ID_KWARG
        from ray_tpu_torch.util import tracing

        t_route = time.perf_counter()
        scope_ctx = tracing.context_of(rspan) or trace_ctx
        model_id = ""
        if kwargs and MODEL_ID_KWARG in kwargs:
            # raw_method calls go straight to the named replica method (ASGI
            # path) — the reserved kwarg is routing metadata only and must
            # not reach its signature; the normal path's replica pops it.
            model_id = (
                kwargs.pop(MODEL_ID_KWARG) if raw_method
                else kwargs[MODEL_ID_KWARG]
            )
        self._ensure_table(force=force_refresh)  # outside the lock (push needs it)
        with self._lock:
            if not self._replicas:
                raise RuntimeError(f"no replicas for deployment '{self._name}'")
            self._sweep()
            self._maybe_shed_overload()
            chosen = None
            if model_id:
                # Sticky model routing: the replica that served this model
                # already paid its load cost (reference: multiplexed-aware
                # scheduling). Falls through when it died or was scaled away.
                rid = self._model_affinity.get(model_id)
                if rid is not None:
                    chosen = next(
                        (r for r in self._replicas if r.replica_id == rid), None
                    )
                if chosen is not None and len(self._replicas) > 1:
                    # Load-based escape: affinity must not pin a hot model's
                    # traffic to one replica while others idle. When the
                    # sticky replica is at its concurrency cap, or ahead of a
                    # power-of-two alternative by more than the hysteresis
                    # threshold (re-loading weights costs something), fall
                    # back to the alternative and re-point the affinity map.
                    aff_load = self._load_of(chosen.replica_id)
                    others = [
                        r for r in self._replicas
                        if r.replica_id != chosen.replica_id
                    ]
                    alt = min(
                        random.sample(others, min(2, len(others))),
                        key=lambda r: self._load_of(r.replica_id),
                    )
                    alt_load = self._load_of(alt.replica_id)
                    if aff_load >= chosen.max_concurrent_queries and (
                        alt_load < alt.max_concurrent_queries
                        or alt_load < aff_load
                    ):
                        chosen = alt
                    elif aff_load > alt_load + _AFFINITY_ESCAPE_THRESHOLD:
                        chosen = alt
            if chosen is None:
                if len(self._replicas) == 1:
                    chosen = self._replicas[0]
                else:
                    a, b = random.sample(self._replicas, 2)
                    chosen = (
                        a
                        if self._load_of(a.replica_id) <= self._load_of(b.replica_id)
                        else b
                    )
            if model_id:
                self._model_affinity[model_id] = chosen.replica_id
                self._model_affinity.move_to_end(model_id)
                while len(self._model_affinity) > self._model_affinity_cap:
                    self._model_affinity.popitem(last=False)
            handle = ActorHandle(chosen.actor_id, "ServeReplica")
            # The scope makes the router span (or the handed-down request
            # context) the ambient parent for the actor-call submit span, so
            # proxy -> router -> replica-execute form ONE trace.
            with tracing.context_scope(scope_ctx):
                if stream:
                    if raw_method:
                        method = getattr(handle, method_name)
                        ref = method.options(num_returns="streaming").remote(*args, **kwargs)
                    else:
                        ref = handle.handle_request_stream.options(
                            num_returns="streaming"
                        ).remote(method_name, tuple(args), kwargs)
                    self._inflight_streams[chosen.replica_id] = (
                        self._inflight_streams.get(chosen.replica_id, 0) + 1
                    )
                else:
                    ref = handle.handle_request.remote(method_name, tuple(args), kwargs)
                    self._inflight.setdefault(chosen.replica_id, []).append(ref)
            self._report_load()
        wait = time.perf_counter() - t_route
        if rspan is not None:
            rspan["attributes"]["replica_id"] = chosen.replica_id
            tracing.end_span(rspan)
        trace_id = trace_ctx.get("trace_id") if trace_ctx else None
        # Sampled regardless of enable_metrics: the SLO autoscaler needs the
        # p95 signal even on a metrics-off runtime (append is O(1), bounded).
        with self._samples_lock:
            self._wait_samples.append((time.time(), wait, trace_id))
        m = _metrics()
        if m is not None:
            tags = {"deployment": self._name}
            m["requests"].inc(1, tags)
            # Route wait: table fetch + lock + replica pick + submit — the
            # router-side queueing a request pays before reaching a replica.
            # The trace id rides as an EXEMPLAR: a route-wait observation in
            # the series store links back to the concrete trace that paid it.
            m["route_wait"].observe(wait, tags, exemplar=trace_id)
        return ref, chosen.replica_id

    def report_failure(self, replica_id: str):
        import ray_tpu_torch

        try:
            ray_tpu_torch.get(
                self._controller.report_failure.remote(self._name, replica_id)
            )
        except Exception:
            pass
        with self._lock:
            self._replicas = [r for r in self._replicas if r.replica_id != replica_id]
            for mid in [
                m for m, r in self._model_affinity.items() if r == replica_id
            ]:
                del self._model_affinity[mid]


class DeploymentResponse:
    """Lazy response: `.result()` blocks, `ray_tpu_torch.get(resp.ref)` also works
    (reference: `serve/handle.py` DeploymentResponse).

    On actor-death at fetch time the dead replica is reported to the
    controller (which replaces it) and the request is resubmitted to another
    replica under the unified retry policy (`_private/retry.py`):
    `Config.serve_resubmit_attempts` bounded attempts with seeded backoff,
    all inside the caller's timeout budget. Each failover increments
    `ray_tpu_serve_resubmit_total{deployment}`."""

    def __init__(
        self,
        ref,
        router: Router,
        replica_id: Optional[str] = None,
        request: Optional[tuple] = None,
    ):
        self.ref = ref
        self._router = router
        self._replica_id = replica_id
        self._request = request  # (method_name, args, kwargs)

    def result(self, timeout: Optional[float] = None):
        import ray_tpu_torch
        from ray_tpu_torch._private import retry
        from ray_tpu_torch._private.config import get_config
        from ray_tpu_torch.exceptions import RayActorError, WorkerCrashedError

        cfg = get_config()
        deadline = None if timeout is None else time.monotonic() + timeout
        attempts_left = max(0, int(cfg.serve_resubmit_attempts))
        # Deterministic backoff between failovers (seeded from the request's
        # first replica via retry.seed_from — stable across processes):
        # replacing replicas need a beat to come up.
        delays = retry.backoff_delays(
            retry.RetryPolicy.from_config(cfg, max_attempts=attempts_left + 1),
            seed=retry.seed_from(self._replica_id or ""),
        )
        while True:
            remaining = (
                None if deadline is None
                else max(0.0, deadline - time.monotonic())
            )
            try:
                return ray_tpu_torch.get(
                    self.ref, timeout=remaining if timeout is not None else None
                )
            except (RayActorError, WorkerCrashedError):
                if self._request is None or self._replica_id is None:
                    raise
                if attempts_left <= 0:
                    raise
                # The retry's controller round-trips are not individually
                # bounded; at minimum don't start them with the caller's
                # budget already spent.
                if deadline is not None and time.monotonic() >= deadline:
                    from ray_tpu_torch.exceptions import GetTimeoutError

                    raise GetTimeoutError(
                        f"request to dead replica {self._replica_id} had no "
                        f"budget left to retry within timeout={timeout}s"
                    )
                attempts_left -= 1
                m = _metrics()
                if m is not None:
                    m["resubmits"].inc(
                        1, {"deployment": self._router._name}
                    )
                # Report the dead replica FIRST so the controller starts the
                # replacement during the backoff sleep, not after it.
                self._router.report_failure(self._replica_id)
                delay = next(delays, 0.0)
                if deadline is not None:
                    delay = min(delay, max(0.0, deadline - time.monotonic()))
                if delay > 0:
                    time.sleep(delay)
                method, args, kwargs = self._request
                self.ref, self._replica_id = self._router.route(
                    method, args, kwargs, force_refresh=True
                )


class _ReplicaStream:
    """One streaming call to a replica: pulls values off the core
    ObjectRefGenerator, resubmits on another replica under the unified retry
    policy (`serve_resubmit_attempts` bounded attempts with seeded backoff,
    counted in `ray_tpu_serve_resubmit_total`) if the chosen one died before
    producing anything, and releases the router's stream load unit when the
    stream ends, errors, or is closed. Mid-stream death (items already
    delivered) is never transparently retried."""

    def __init__(self, router: Router, method_name: str, args, kwargs,
                 raw_method: bool = False, trace_ctx=None):
        from ray_tpu_torch._private import retry
        from ray_tpu_torch._private.config import get_config

        self._router = router
        self._call = (method_name, args, kwargs, raw_method)
        self._trace_ctx = trace_ctx  # request envelope context (HTTP proxy)
        self._gen, self._rid = router.route(
            method_name, args, kwargs, stream=True, raw_method=raw_method,
            trace_ctx=trace_ctx,
        )
        self._got_first = False
        cfg = get_config()
        self._resubmits_left = max(0, int(cfg.serve_resubmit_attempts))
        self._delays = retry.backoff_delays(
            retry.RetryPolicy.from_config(
                cfg, max_attempts=self._resubmits_left + 1
            ),
            seed=retry.seed_from(self._rid or ""),
        )
        self._done = False

    @property
    def replica_id(self) -> str:
        return self._rid

    def next_or_none(self):
        """The next streamed value, or None at end-of-stream."""
        import ray_tpu_torch
        from ray_tpu_torch.exceptions import RayActorError, WorkerCrashedError

        while True:
            try:
                ref = next(self._gen)
                value = ray_tpu_torch.get(ref)
                self._got_first = True
                return value
            except StopIteration:
                self._finish()
                return None
            except (RayActorError, WorkerCrashedError):
                if self._got_first or self._resubmits_left <= 0:
                    # Mid-stream death is not transparently retryable (items
                    # already delivered); surface it.
                    self._finish()
                    raise
                self._resubmits_left -= 1
                m = _metrics()
                if m is not None:
                    m["resubmits"].inc(1, {"deployment": self._router._name})
                # Report first (controller starts the replacement during the
                # backoff sleep), then back off, then re-route.
                self._router.report_failure(self._rid)
                self._router.stream_done(self._rid)
                delay = next(self._delays, 0.0)
                if delay > 0:
                    time.sleep(delay)
                method, args, kwargs, raw = self._call
                self._gen, self._rid = self._router.route(
                    method, args, kwargs, force_refresh=True,
                    stream=True, raw_method=raw, trace_ctx=self._trace_ctx,
                )
            except BaseException:
                # User exception from the deployment (or any other failure):
                # the stream is over — release the load unit before raising.
                self._finish()
                raise

    def close(self):
        if not self._done:
            try:
                self._gen.close()
            finally:
                self._finish()

    def _finish(self):
        if not self._done:
            self._done = True
            self._router.stream_done(self._rid)

    def __del__(self):
        # Abandoned stream: releasing the load unit is GC-safe (lock-free
        # queue); the core generator's own __del__ releases its items.
        try:
            self._finish()
        except Exception:
            pass


class DeploymentResponseGenerator:
    """Streaming response: iterating yields the values a generator deployment
    method produces, as they are produced (reference: `serve/handle.py`
    `DeploymentResponseGenerator`, `handle.options(stream=True)`)."""

    def __init__(self, stream: _ReplicaStream):
        self._stream = stream

    def __iter__(self):
        return self

    def __next__(self):
        event = self._stream.next_or_none()
        if event is None:
            raise StopIteration
        _kind, value = event
        return value

    def close(self):
        self._stream.close()


class DeploymentHandle:
    def __init__(self, deployment_name: str, controller,
                 method_name: str = "__call__", stream: bool = False,
                 multiplexed_model_id: str = ""):
        self.deployment_name = deployment_name
        self._controller = controller
        self._method = method_name
        self._stream = stream
        self._multiplexed_model_id = multiplexed_model_id
        self._router: Optional[Router] = None

    def options(self, *, method_name: Optional[str] = None,
                stream: Optional[bool] = None,
                multiplexed_model_id: Optional[str] = None) -> "DeploymentHandle":
        h = DeploymentHandle(
            self.deployment_name,
            self._controller,
            method_name if method_name is not None else self._method,
            stream if stream is not None else self._stream,
            multiplexed_model_id
            if multiplexed_model_id is not None
            else self._multiplexed_model_id,
        )
        # Derived handles SHARE the parent's router: one replica table, one
        # load book, one model-affinity map — and no router (+ its listener
        # thread) per options()/bound-method call.
        h._router = self._ensure_router()
        return h

    def _ensure_router(self) -> Router:
        if self._router is None:
            self._router = Router(self.deployment_name, self._controller)
        return self._router

    def remote(self, *args, **kwargs):
        if self._multiplexed_model_id:
            from ray_tpu_torch.serve.multiplex import MODEL_ID_KWARG

            kwargs = {**kwargs, MODEL_ID_KWARG: self._multiplexed_model_id}
        router = self._ensure_router()
        if self._stream:
            return DeploymentResponseGenerator(
                _ReplicaStream(router, self._method, args, kwargs)
            )
        ref, replica_id = router.route(self._method, args, kwargs)
        return DeploymentResponse(
            ref, router, replica_id, (self._method, args, kwargs)
        )

    def __reduce__(self):
        return (
            DeploymentHandle,
            (self.deployment_name, self._controller, self._method, self._stream,
             self._multiplexed_model_id),
        )

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return _BoundMethod(self, name)


class _BoundMethod:
    def __init__(self, handle: DeploymentHandle, method_name: str):
        self._h = handle
        self._m = method_name

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return self._h.options(method_name=self._m).remote(*args, **kwargs)
