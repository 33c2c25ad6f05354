"""HTTP proxy: the HTTP front door, one actor per node at scale.

Reference: `python/ray/serve/_private/http_proxy.py:250` (`HTTPProxy`, served
by an ASGI server at `:434`) + `http_state.py` (the controller-managed per-node
proxy fleet). Here the server is a small HTTP/1.1 server of the standard
library's `asyncio.start_server` (the GPU machine has no third-party HTTP
server),
running on a background thread inside the proxy actor; each request resolves its route by longest prefix
match against the controller's route table (cached), then hops to a replica
through the same Router/power-of-two path as Python handles, with the
blocking result fetch pushed onto the loop's executor.

Admission control: each app has a per-proxy cap on admitted-but-unfinished
requests (deployment option `max_queued_requests`, default
`serve_queue_cap_default`); beyond it the proxy answers a FAST
`503 + Retry-After` (counted in `ray_tpu_serve_shed_total{app,reason}`)
instead of queueing toward collapse. A draining proxy (serve_drain tag, or
controller drain_proxy) sheds everything new, withdraws from the head's
service directory, and finishes its in-flight window.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
import urllib.parse
from dataclasses import dataclass, field
from http import HTTPStatus
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.serve._private.common import RequestShedded
from ray_tpu_torch.util import tracing


@dataclass
class ProxyRequest:
    """What a deployment's __call__ receives for an HTTP request."""

    method: str
    path: str  # path with the route prefix stripped
    full_path: str
    query_params: Dict[str, str] = field(default_factory=dict)
    headers: Dict[str, str] = field(default_factory=dict)
    body: bytes = b""

    def json(self) -> Any:
        return json.loads(self.body) if self.body else None

    @property
    def text(self) -> str:
        return self.body.decode()


def _asgi_route_kwargs(request) -> Dict[str, Any]:
    """Routing metadata for ASGI calls: the multiplexed model id (if any)
    rides a reserved kwarg so the router can apply model affinity; route()
    pops it before invoking the replica method."""
    from ray_tpu_torch.serve.multiplex import MODEL_ID_HEADER, MODEL_ID_KWARG

    mid = request.headers.get(MODEL_ID_HEADER, "")
    return {MODEL_ID_KWARG: mid} if mid else {}


# --------------------------------------------------------------------- HTTP/1.1
# The reference's HTTP server library, cut to what the proxy uses: request
# line and headers, Content-Length or chunked request bodies, keep-alive
# (HTTP/1.1 unless `Connection: close`), complete responses, and streamed
# responses in chunked transfer coding with one flushed chunk per write.
_MAX_BODY = 1024 ** 2  # the reference's default client_max_size: larger bodies 413
_MAX_HEADERS = 100


class _Headers(dict):
    """Header fields in the case the client sent them; `get` ignores case
    (as the reference's multidict does)."""

    def get(self, key, default=None):
        key = key.lower()
        for name, value in self.items():
            if name.lower() == key:
                return value
        return default


class _BadRequest(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class _Request:
    """One parsed request: the attributes of the reference's `web.Request` that
    the proxy reads, plus the connection's writer for streamed responses."""

    def __init__(self, method: str, target: str, version: Tuple[int, int],
                 headers: "_Headers", remote: str, writer):
        parts = urllib.parse.urlsplit(target)
        self.method = method
        self.raw_path = target
        self.path = urllib.parse.unquote(parts.path) or "/"
        self.query_string = parts.query
        self.query = dict(urllib.parse.parse_qsl(parts.query, keep_blank_values=True))
        self.version = version
        self.headers = headers
        self.remote = remote
        self.writer = writer
        self.body = b""
        conn = headers.get("Connection", "").lower()
        self.keep_alive = conn != "close" if version >= (1, 1) else conn == "keep-alive"

    async def read(self) -> bytes:
        return self.body


class _Response:
    """A complete response (status, headers, body), written in one piece."""

    def __init__(self, status: int = 200, body: bytes = b"",
                 content_type: str = "application/octet-stream",
                 headers: Optional[Dict[str, str]] = None):
        self.status = status
        self.body = body
        self.headers = {"Content-Type": content_type, **(headers or {})}


def _json_response(obj, status: int = 200,
                   headers: Optional[Dict[str, str]] = None) -> _Response:
    return _Response(status, json.dumps(obj).encode(),
                     "application/json; charset=utf-8", headers)


def _text_response(text: str) -> _Response:
    return _Response(200, text.encode(), "text/plain; charset=utf-8")


def _head(status: int, headers: Dict[str, str], keep_alive: bool) -> bytes:
    try:
        reason = HTTPStatus(status).phrase
    except ValueError:
        reason = ""
    lines = [f"HTTP/1.1 {status} {reason}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    lines.append(f"Connection: {'keep-alive' if keep_alive else 'close'}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class _StreamResponse:
    """A streamed response (the reference's `web.StreamResponse` with chunked
    encoding): `prepare` sends the head, each `write` sends and flushes one
    chunk, `write_eof` ends the body. An HTTP/1.0 client gets the raw bytes
    and the connection closes after them."""

    def __init__(self, status: int = 200, headers: Optional[Dict[str, str]] = None):
        self.status = status
        self.headers = dict(headers or {})
        self._request: Optional[_Request] = None
        self._chunked = True
        self.finished = False

    async def prepare(self, request: _Request) -> None:
        self._request = request
        self._chunked = request.version >= (1, 1)
        headers = dict(self.headers)
        if self._chunked:
            headers["Transfer-Encoding"] = "chunked"
        else:
            request.keep_alive = False
        request.writer.write(_head(self.status, headers, request.keep_alive))
        await request.writer.drain()

    async def write(self, data: bytes) -> None:
        if not data:
            return  # an empty chunk would end the body
        writer = self._request.writer
        writer.write(b"%x\r\n%s\r\n" % (len(data), data) if self._chunked else data)
        await writer.drain()

    async def write_eof(self) -> None:
        if self._chunked:
            self._request.writer.write(b"0\r\n\r\n")
            await self._request.writer.drain()
        self.finished = True


def _parse_int(text, base: int) -> int:
    try:
        value = int(text, base)
    except ValueError:
        raise _BadRequest(400, f"malformed length {text!r}") from None
    if value < 0:
        raise _BadRequest(400, f"negative length {text!r}")
    return value


async def _read_request(reader, writer) -> Optional[_Request]:
    """Parse one request off the connection (None at a clean EOF). Raises
    _BadRequest for a malformed or oversized one."""
    line = await reader.readline()
    if not line:
        return None
    if line in (b"\r\n", b"\n"):  # tolerated blank line between requests
        line = await reader.readline()
    try:
        method, target, proto = line.decode("latin-1").split()
        major, minor = proto.split("/", 1)[1].split(".")
        version = (int(major), int(minor))
    except ValueError:
        raise _BadRequest(400, "malformed request line") from None
    headers = _Headers()
    while True:
        hline = await reader.readline()
        if hline in (b"\r\n", b"\n", b""):
            break
        if len(headers) >= _MAX_HEADERS:
            raise _BadRequest(431, "too many header fields")
        name, sep, value = hline.decode("latin-1").partition(":")
        if not sep or not name.strip():
            raise _BadRequest(400, "malformed header field")
        headers[name.strip()] = value.strip()
    peer = writer.get_extra_info("peername")
    request = _Request(method.upper(), target, version, headers,
                       peer[0] if peer else "", writer)
    if headers.get("Expect", "").lower() == "100-continue":
        writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
    if "chunked" in headers.get("Transfer-Encoding", "").lower():
        parts: List[bytes] = []
        total = 0
        while True:
            size = _parse_int((await reader.readline()).split(b";")[0].strip() or b"0", 16)
            if size == 0:
                while (await reader.readline()) not in (b"\r\n", b"\n", b""):
                    pass  # trailer fields are dropped
                break
            total += size
            if total > _MAX_BODY:
                raise _BadRequest(413, "request body too large")
            parts.append(await reader.readexactly(size))
            await reader.readline()
        request.body = b"".join(parts)
    else:
        length = _parse_int(headers.get("Content-Length", "0") or "0", 10)
        if length > _MAX_BODY:
            raise _BadRequest(413, "request body too large")
        if length:
            request.body = await reader.readexactly(length)
    return request


def _ingress_metrics():
    """Front-door metric set, or None when enable_metrics is off."""
    from ray_tpu_torch._private import telemetry

    return (
        telemetry.serve_ingress_metrics()
        if telemetry.metrics_enabled() else None
    )


class HTTPProxy:
    def __init__(self, controller, port: Optional[int] = None,
                 proxy_id: Optional[str] = None):
        self._controller = controller
        # Controller-assigned identity (EveryNode fleet): the service
        # directory and the controller's proxy registry then share ONE
        # proxy_id, so the two /api/serve views join on it, not on ports.
        self._proxy_id = proxy_id
        self._handles: Dict[str, Any] = {}
        self._routes: Dict[str, str] = {}
        self._routes_fetched = 0.0
        self._port: Optional[int] = None
        self._started = threading.Event()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._start_error: Optional[str] = None
        self._bind_error: Optional[str] = None
        self._routes_thread_started = False
        # ---- admission control / drain state ----
        # deployment -> per-proxy cap on admitted-but-unfinished requests
        # (pushed with the route table; 0 = uncapped).
        self._app_caps: Dict[str, int] = {}
        self._ingress_lock = threading.Lock()
        self._app_inflight: Dict[str, int] = {}
        self._app_shed: Dict[str, int] = {}
        self._app_requests: Dict[str, int] = {}
        self._total_inflight = 0
        self._draining = False
        self._announced_id: Optional[str] = None
        if port is not None:
            # Bind during creation so a crash-restart (max_restarts replays
            # the creation task) comes back LISTENING on the same port — the
            # reference's controller reconciles dead proxies back up the
            # same way (`_private/http_state.py`). A bind failure (port in
            # use) is RECORDED, not raised: raising would fail the creation
            # and restart-loop forever; port() surfaces the error instead.
            try:
                self.start(port=port)
            except Exception as e:  # noqa: BLE001
                self._start_error = repr(e)
                # The common cause during a crash-restart is the dead
                # proxy's socket still draining: keep retrying the SAME
                # port in the background instead of sitting dead forever.
                threading.Thread(
                    target=self._retry_bind, args=(port,), daemon=True,
                    name="proxy-rebind",
                ).start()

    def _retry_bind(self, port: int) -> None:
        import time

        deadline = time.time() + 120
        while time.time() < deadline:
            time.sleep(2.0)
            try:
                self.start(port=port)
                self._start_error = None
                return
            except Exception as e:  # noqa: BLE001
                self._start_error = repr(e)

    def start_error(self):
        return self._start_error

    def pid(self) -> int:
        """Worker pid (health checks + chaos tests)."""
        import os

        return os.getpid()

    # -------------------------------------------------------------- lifecycle
    def start(self, host: str = "127.0.0.1", port: int = 8000) -> int:
        """Start serving; returns the bound port (0 picks a free one).
        Idempotent on a LIVE listener: concurrent starters (the controller's
        ensure_proxies racing its reconcile tick) must not stack a second
        HTTP server inside the actor."""
        if self._port is not None:
            return self._port
        t = threading.Thread(
            target=self._serve_thread, args=(host, port), daemon=True, name="http"
        )
        t.start()
        # Wait for bind FIRST: a failed bind must raise promptly (the serve
        # thread signals failure) and must not leak a routes-listen long-poll
        # thread per attempt — retry loops would stack immortal pollers.
        # Deadline-bounded: a serve thread that hangs before bind (e.g. in
        # runner.setup()) without recording an error must not block the
        # caller (actor creation) forever.
        deadline = time.monotonic() + 60.0
        while not self._started.wait(timeout=0.2):
            if self._bind_error is not None:
                err, self._bind_error = self._bind_error, None
                raise RuntimeError(f"HTTP proxy failed to bind: {err}")
            if not t.is_alive():
                raise RuntimeError("HTTP proxy serve thread died before binding")
            if time.monotonic() > deadline:
                raise RuntimeError("HTTP proxy did not bind within 60s")
        if not self._routes_thread_started:
            self._routes_thread_started = True
            threading.Thread(
                target=self._routes_listen_loop, daemon=True, name="routes-listen"
            ).start()
        self._announce()
        return self._port

    def _announce(self) -> None:
        """Register this proxy's listener in the head's service directory
        (serve_proxy_up tag; no-op outside a worker process)."""
        import os

        from ray_tpu_torch._private import worker_main

        proxy_id = self._proxy_id or f"proxy-{os.getpid()}-{self._port}"
        if worker_main.announce_serve_proxy(
            {"proxy_id": proxy_id, "port": self._port, "pid": os.getpid()}
        ):
            self._announced_id = proxy_id

    # ------------------------------------------------------------------ drain
    def _serve_begin_drain(self) -> None:
        """Out-of-band drain hook (worker reader thread, serve_drain tag):
        stop accepting — every new request sheds 503 + Retry-After — and
        withdraw from the service directory; in-flight requests finish."""
        self._draining = True
        if self._announced_id is not None:
            from ray_tpu_torch._private import worker_main

            worker_main.withdraw_serve_proxy(self._announced_id)
            self._announced_id = None

    def _serve_inflight(self) -> int:
        return self._total_inflight

    def prepare_drain(self) -> int:
        """Actor-call form of the drain flag (tests/tooling)."""
        self._serve_begin_drain()
        return self._total_inflight

    def ingress_stats(self) -> Dict[str, Any]:
        """Live per-app admission counters (dashboard /api/serve)."""
        with self._ingress_lock:
            apps = {
                dep: {
                    "inflight": self._app_inflight.get(dep, 0),
                    "shed": self._app_shed.get(dep, 0),
                    "requests": self._app_requests.get(dep, 0),
                    "cap": self._app_caps.get(dep, 0),
                }
                for dep in (
                    set(self._app_inflight) | set(self._app_shed)
                    | set(self._app_requests) | set(self._app_caps)
                )
            }
        return {
            "port": self._port,
            "draining": self._draining,
            "total_inflight": self._total_inflight,
            "apps": apps,
        }

    def port(self) -> Optional[int]:
        return self._port

    def _serve_thread(self, host: str, port: int):
        import os

        from ray_tpu_torch._private.config import get_config

        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        # Bounded forwarding pipeline (serve_proxy_max_concurrent): requests
        # over the bound park on the semaphore (cheap coroutines) instead of
        # flooding the executor — the event loop stays responsive, so shed
        # 503s are fast even at 2x saturation.
        bound = int(get_config().serve_proxy_max_concurrent)
        if bound <= 0:
            bound = max(4, 4 * (os.cpu_count() or 1))
        self._forward_slots = asyncio.Semaphore(bound)

        try:
            server = loop.run_until_complete(
                asyncio.start_server(self._serve_connection, host, port)
            )
        except Exception as e:  # noqa: BLE001 — surfaced by start()'s wait loop
            self._bind_error = repr(e)
            return
        self._server = server  # held: the loop keeps no reference to it
        self._port = server.sockets[0].getsockname()[1]
        self._started.set()
        loop.run_forever()

    async def _serve_connection(self, reader, writer) -> None:
        """One client connection: requests in order until the client or a
        response closes it."""
        try:
            while True:
                try:
                    request = await _read_request(reader, writer)
                except _BadRequest as e:
                    writer.write(_head(e.status, {"Content-Length": "0"}, False))
                    await writer.drain()
                    return
                if request is None:
                    return
                resp = await self._handle(request)
                if isinstance(resp, _StreamResponse):
                    if not resp.finished:
                        return  # cut mid-stream: the client sees the body end early
                else:
                    body = b"" if request.method == "HEAD" else resp.body
                    headers = {**resp.headers, "Content-Length": str(len(resp.body))}
                    writer.write(_head(resp.status, headers, request.keep_alive) + body)
                    await writer.drain()
                if not request.keep_alive:
                    return
        except (ConnectionError, asyncio.IncompleteReadError, ValueError):
            pass  # the client went away, or sent a line over the reader's limit
        finally:
            writer.close()

    # ---------------------------------------------------------------- routing
    def _routes_listen_loop(self):
        """Park in the controller's long poll for route-table AND admission
        cap pushes (client half of the reference's LongPollHost). Every
        proxy mirrors ONE routing table this way — adding a node just adds
        another parked listener."""
        import time

        import ray_tpu_torch

        versions = {"routes": -1, "app_caps": -1}
        failures = 0
        while True:
            try:
                updates = ray_tpu_torch.get(
                    self._controller.listen_for_change.remote(dict(versions)),
                    timeout=60,
                )
                failures = 0
            except Exception:
                failures += 1
                if failures >= 6:
                    return  # controller gone; fallback fetch path takes over
                time.sleep(0.5)
                continue
            if "routes" in updates:
                versions["routes"], routes = updates["routes"]
                self._routes = routes
            if "app_caps" in updates:
                versions["app_caps"], caps = updates["app_caps"]
                self._app_caps = caps

    def _refresh_routes(self) -> None:
        """Pull the route table directly from the controller (the long-poll
        push keeps it fresh in steady state; this covers the windows)."""
        import ray_tpu_torch

        self._routes = ray_tpu_torch.get(self._controller.get_routes.remote())
        try:
            self._app_caps = ray_tpu_torch.get(
                self._controller.get_app_caps.remote()
            )
        except Exception:  # noqa: BLE001 — caps follow on the next push
            pass
        self._routes_fetched = time.time()

    def has_route(self, prefix: str) -> bool:
        """True once this proxy's route table includes `prefix`. serve.run's
        readiness barrier polls this so it never returns before every proxy
        can route the new app (reference: serve.run blocks until replicas AND
        routes are ready, `serve/api.py:460`). Misses fall through to a direct
        controller fetch so readiness doesn't wait a long-poll round trip."""
        if prefix in self._routes:
            return True
        try:
            self._refresh_routes()
        except Exception:
            return False
        return prefix in self._routes

    def _route_table(self) -> Dict[str, str]:

        # Push keeps this fresh; the fallback fetch covers the pre-first-push
        # window, rate-limited so a legitimately empty table (no routed
        # deployments) doesn't turn every 404 into a controller round trip.
        if not self._routes and time.time() - self._routes_fetched > 2.0:
            self._refresh_routes()
        return self._routes

    def _match(self, path: str) -> Optional[Tuple[str, bool, str]]:
        match = self._match_in(path, self._route_table())
        if match is None:
            # Miss may be push lag for a just-deployed route: refetch once,
            # rate-limited so real 404 traffic can't hammer the controller.
            if time.time() - self._routes_fetched > 0.5:
                try:
                    self._refresh_routes()
                    match = self._match_in(path, self._routes)
                except Exception:
                    pass
        return match

    @staticmethod
    def _match_in(path: str, routes) -> Optional[Tuple[str, bool, str]]:
        best = None
        for prefix, (dep, is_asgi) in routes.items():
            norm = prefix.rstrip("/") or ""
            if path == norm or path.startswith(norm + "/") or norm == "":
                if best is None or len(norm) > len(best[0]):
                    best = (norm, dep, is_asgi)
        if best is None:
            return None
        rest = path[len(best[0]):] or "/"
        return best[1], best[2], rest

    def _handle_for(self, dep: str):
        handle = self._handles.get(dep)
        if handle is None:
            from ray_tpu_torch.serve.handle import DeploymentHandle

            handle = DeploymentHandle(dep, self._controller)
            self._handles[dep] = handle
        return handle

    # ------------------------------------------------------ admission control
    @staticmethod
    def _shed_of(exc) -> Optional[RequestShedded]:
        """The RequestShedded behind `exc`, if any: raised directly (router
        inflight cap) or wrapped in a RayTaskError (a shed-aware
        @serve.batch queue inside the replica). The CAUSE wins over the
        outer exception: RayTaskError.as_instanceof_cause builds a derived
        RayTaskError(RequestShedded) whose MRO re-ran RequestShedded's
        __init__ with DEFAULT reason/retry_after_s — only the original
        cause carries the real shed attributes."""
        cause = getattr(exc, "cause", None) or exc.__cause__
        if isinstance(cause, RequestShedded):
            return cause
        if isinstance(exc, RequestShedded):
            return exc
        return None

    def _shed_response(self, app: str, reason: str,
                       retry_after_s: Optional[float] = None,
                       count: bool = True):
        """Fast 503 + Retry-After: overload converts to an explicit backoff
        signal, never a hung connection (shed-not-collapse). `count=False`
        skips the shared shed counter for sheds the ORIGIN already counted
        (the router's replica_inflight raise) — one shed, one count."""
        if retry_after_s is None:
            from ray_tpu_torch._private.config import get_config

            retry_after_s = get_config().serve_retry_after_s
        with self._ingress_lock:
            self._app_shed[app] = self._app_shed.get(app, 0) + 1
        m = _ingress_metrics() if count else None
        if m is not None:
            m["shed"].inc(1, {"app": app, "reason": reason})
        import math

        # RFC 9110: Retry-After delay-seconds is a non-negative INTEGER —
        # fractional values break conforming clients' parsers. Round up so
        # a sub-second knob still signals a backoff.
        return _json_response(
            {"error": "shed", "reason": reason, "app": app},
            status=503,
            headers={"Retry-After": str(max(1, math.ceil(retry_after_s)))},
        )

    def _admit(self, dep: str) -> bool:
        """Count one request in, unless the app is at its per-proxy cap."""
        cap = self._app_caps.get(dep, 0)
        with self._ingress_lock:
            inflight = self._app_inflight.get(dep, 0)
            if cap and inflight >= cap:
                return False
            self._app_inflight[dep] = inflight + 1
            self._app_requests[dep] = self._app_requests.get(dep, 0) + 1
            self._total_inflight += 1
        m = _ingress_metrics()
        if m is not None:
            m["proxy_requests"].inc(1, {"app": dep})
            m["proxy_queue_depth"].set(inflight + 1, {"app": dep})
        return True

    def _release(self, dep: str) -> None:
        with self._ingress_lock:
            left = max(0, self._app_inflight.get(dep, 0) - 1)
            self._app_inflight[dep] = left
            self._total_inflight = max(0, self._total_inflight - 1)
        m = _ingress_metrics()
        if m is not None:
            m["proxy_queue_depth"].set(left, {"app": dep})

    async def _handle(self, request):
        match = self._match(request.path)
        if match is None:
            return _json_response(
                {"error": f"no route for {request.path}"}, status=404
            )
        dep, is_asgi, rest = match
        # Root span of the end-to-end request trace: the proxy mints it and
        # the context rides the request envelope (route() -> replica submit
        # -> execute -> nested tasks join the SAME trace). Detached (many
        # requests interleave on this event loop) and tail-keep eligible: a
        # request breaching trace_keep_latency_s is flushed even when its
        # trace lost the head-sampling draw.
        root_span = None
        if tracing.is_enabled():
            root_span = tracing.start_span(
                f"request::{dep}", "request",
                attributes={"app": dep, "method": request.method,
                            "path": request.path},
                detached=True, tail_keep=True,
            )
        trace_ctx = tracing.context_of(root_span)
        status = "OK"
        if self._draining:
            tracing.end_span(root_span, "SHED")
            return self._shed_response(dep, "draining")
        if not self._admit(dep):
            tracing.end_span(root_span, "SHED")
            return self._shed_response(dep, "app_queue")
        try:
            body = await request.read()
            handle = self._handle_for(dep)
            try:
                async with self._forward_slots:
                    if is_asgi:
                        return await self._handle_asgi(
                            request, handle, rest, body, trace_ctx
                        )
                    return await self._handle_plain(
                        request, handle, rest, body, trace_ctx
                    )
            except Exception as e:  # noqa: BLE001 — surface as a 500
                shed = self._shed_of(e)
                if shed is not None:
                    status = "SHED"
                    return self._shed_response(
                        dep, shed.reason, shed.retry_after_s,
                        count=shed.reason != "replica_inflight",
                    )
                status = "ERROR"
                return _json_response({"error": str(e)}, status=500)
        except BaseException:
            # Body-read failure or client disconnect (CancelledError): the
            # request did NOT succeed — its trace must not say OK.
            status = "ERROR"
            raise
        finally:
            self._release(dep)
            tracing.end_span(root_span, status)

    async def _handle_plain(self, request, handle, rest: str, body: bytes,
                            trace_ctx=None):
        """Non-ASGI deployment: one streaming call; a generator return
        streams as a chunked response, a plain return answers normally."""
        from ray_tpu_torch.serve.handle import _ReplicaStream

        preq = ProxyRequest(
            method=request.method,
            path=rest,
            full_path=request.path,
            query_params=dict(request.query),
            headers=dict(request.headers),
            body=body,
        )
        call_kwargs = _asgi_route_kwargs(request)
        loop = asyncio.get_event_loop()
        stream = _ReplicaStream(
            handle._ensure_router(), "__call__", (preq,), call_kwargs,
            trace_ctx=trace_ctx,
        )
        resp = None
        try:
            first = await loop.run_in_executor(None, stream.next_or_none)
            if first is None:
                return _Response(status=204)
            kind, value = first
            if kind == "single":
                return self._to_response(value)
            # Generator deployment: chunked transfer, one chunk per yield.
            resp = _StreamResponse()
            await resp.prepare(request)
            ev = first
            while ev is not None:
                await resp.write(self._to_chunk(ev[1]))
                ev = await loop.run_in_executor(None, stream.next_or_none)
            await resp.write_eof()
            return resp
        except Exception:  # noqa: BLE001
            # After prepare() the status line is on the wire: no second
            # response is possible — drop the connection mid-stream instead.
            # Pre-prepare failures re-raise so _handle classifies them
            # (shed -> 503 + Retry-After, anything else -> 500).
            if resp is None:
                raise
            return resp
        finally:
            stream.close()  # releases unconsumed items + router load unit

    async def _handle_asgi(self, request, handle, rest: str, body: bytes,
                           trace_ctx=None):
        """ASGI ingress: speak ASGI to the replica over a streaming call and
        relay response events as they arrive (SSE/chunked stream end-to-end)."""
        from ray_tpu_torch.serve.handle import _ReplicaStream

        scope = {
            "type": "http",
            "asgi": {"version": "3.0", "spec_version": "2.3"},
            "http_version": "1.1",
            "method": request.method,
            "path": rest,
            "raw_path": request.raw_path.encode(),
            "root_path": "",
            "query_string": request.query_string.encode(),
            "headers": [(k.lower(), v) for k, v in request.headers.items()],
            "client": (request.remote, 0),
            "server": ("127.0.0.1", self._port),
        }
        loop = asyncio.get_event_loop()
        stream = _ReplicaStream(
            handle._ensure_router(), "handle_asgi", (scope, body),
            _asgi_route_kwargs(request),
            raw_method=True, trace_ctx=trace_ctx,
        )
        resp = None
        try:
            ev = await loop.run_in_executor(None, stream.next_or_none)
            while ev is not None:
                etype = ev.get("type")
                if etype == "http.response.start":
                    resp = _StreamResponse(status=ev.get("status", 200))
                    for hk, hv in ev.get("headers", []):
                        k = hk.decode() if isinstance(hk, bytes) else hk
                        v = hv.decode() if isinstance(hv, bytes) else hv
                        if k.lower() not in ("content-length", "transfer-encoding",
                                             "connection"):
                            resp.headers[k] = v
                    await resp.prepare(request)
                elif etype == "http.response.body":
                    if resp is None:
                        resp = _StreamResponse()
                        await resp.prepare(request)
                    chunk = ev.get("body", b"")
                    if chunk:
                        await resp.write(chunk)
                elif etype == "asgi.error":
                    if resp is None:
                        return _json_response({"error": ev["error"]}, status=500)
                    break
                ev = await loop.run_in_executor(None, stream.next_or_none)
            if resp is None:
                return _Response(status=204)
            await resp.write_eof()
            return resp
        except Exception:  # noqa: BLE001
            if resp is None:
                raise  # _handle classifies: shed -> 503, else 500
            return resp  # mid-stream failure: connection ends where it stopped
        finally:
            stream.close()

    @staticmethod
    def _to_chunk(value) -> bytes:
        if isinstance(value, bytes):
            return value
        if isinstance(value, str):
            return value.encode()
        return (json.dumps(value) + "\n").encode()

    @staticmethod
    def _to_response(result):
        if isinstance(result, bytes):
            return _Response(body=result)
        if isinstance(result, str):
            return _text_response(result)
        try:
            return _json_response(result)
        except TypeError:
            return _text_response(str(result))
