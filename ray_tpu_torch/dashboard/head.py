"""Dashboard HTTP server (reference: `dashboard/head.py` + per-module REST
handlers under `dashboard/modules/`), on the standard library's
`http.server.ThreadingHTTPServer`: the GPU machine has no third-party web
package, as for Serve's proxy (`serve/_private/http_proxy.py`)."""

from __future__ import annotations

import http.server
import json
import threading
import urllib.parse
from typing import Optional


class DashboardServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 8265):
        self._host = host
        self._want_port = port
        self.port: Optional[int] = None
        self._httpd: Optional[http.server.ThreadingHTTPServer] = None

    # Every kind `/api/{kind}` serves; the 404 for anything else lists them.
    VALID_KINDS = (
        "actors", "alerts", "cluster", "events", "jobs", "latency", "memory",
        "nodes", "objects", "profile", "serve", "series", "stacks", "tasks",
        "timeline", "traces", "train",
    )
    # Ceiling on `/api/profile?duration=` (the handler blocks its request's
    # thread for the duration).
    MAX_PROFILE_DURATION_S = 60.0

    # ------------------------------------------------------------- handlers
    def _serve_payload(self, app: Optional[str] = None):
        """Serve ingress view: apps/replicas with live queue depth, inflight
        and shed counters (from the controller + its proxy fleet) plus the
        head's proxy service directory. Unknown ?app= raises KeyError -> a
        JSON 400 (the caller-error shape of every endpoint)."""
        import ray_tpu_torch
        from ray_tpu_torch._private.worker import global_worker

        out = {"apps": {}, "proxies": [], "directory": []}
        ctx = global_worker.context
        if ctx is not None:
            try:
                out["directory"] = ctx.serve_directory()
            except Exception:  # noqa: BLE001 — head gone/not a driver
                pass
        try:
            from ray_tpu_torch.serve._private.common import CONTROLLER_NAME

            named = ray_tpu_torch.get_actor(CONTROLLER_NAME)
            from ray_tpu_torch.actor import ActorHandle

            ctrl = ActorHandle(named._actor_id, "ServeController")
            out.update(ray_tpu_torch.get(ctrl.ingress_status.remote()))
        except ValueError:
            pass  # Serve not running: empty view, not an error
        if app is not None:
            if app not in out["apps"]:
                raise KeyError(app)
            out["apps"] = {app: out["apps"][app]}
        return out

    def _obs_payload(self, kind: str, limit: Optional[int], query: dict):
        """Time-series / event-log / alert views. Bad caller input raises
        ValueError -> JSON 400 (the limit/duration convention)."""
        from ray_tpu_torch.util import state as state_api

        if kind == "alerts":
            return state_api.list_alerts()
        if kind == "events":
            return state_api.list_cluster_events(
                limit=limit,
                kind=query.get("kind") or None,
                severity=query.get("severity") or None,
                since=float(query["since"]) if query.get("since") else None,
            )
        # kind == "series"
        name = query.get("name")
        if not name:
            raise ValueError("series needs ?name=<metric>")
        labels = None
        if query.get("labels"):
            labels = json.loads(query["labels"])
            if not isinstance(labels, dict):
                raise ValueError("labels must be a JSON object")
        return state_api.query_series(
            name,
            labels=labels,
            since=float(query["since"]) if query.get("since") else None,
            until=float(query["until"]) if query.get("until") else None,
            step=float(query["step"]) if query.get("step") else None,
            agg=query.get("agg", "sum"),
            q=float(query["q"]) if query.get("q") else None,
        )

    def _payload(self, kind: str, limit: Optional[int] = None,
                 duration: Optional[float] = None,
                 app: Optional[str] = None,
                 query: Optional[dict] = None):
        from ray_tpu_torch.util import state as state_api

        if kind in ("series", "events", "alerts"):
            return self._obs_payload(kind, limit, query or {})
        if kind == "serve":
            return self._serve_payload(app)
        if kind == "cluster":
            return state_api.summarize()
        if kind == "nodes":
            return state_api.list_nodes(include_postmortems=True)
        if kind == "actors":
            return state_api.list_actors()
        if kind == "tasks":
            return state_api.list_tasks(limit if limit is not None else 1000)
        if kind == "objects":
            return state_api.list_objects(limit if limit is not None else 1000)
        if kind == "timeline":
            # Unified chrome trace (task stages + spans + collectives):
            # save the JSON and load it at chrome://tracing / Perfetto.
            return state_api.timeline()
        if kind == "traces":
            # End-to-end request traces: ?trace_id= for one trace with its
            # critical-path attribution, else newest-last summaries.
            trace_id = (query or {}).get("trace_id")
            if trace_id:
                return state_api.get_trace(trace_id)
            return state_api.list_traces(limit if limit is not None else 50)
        if kind == "latency":
            # "Where does p95 actually go": per-component attribution over
            # recent traces (state.latency_report).
            return state_api.latency_report(
                limit if limit is not None else 200
            )
        if kind == "stacks":
            # Live all-thread stacks from every process (`ray stack`).
            return state_api.stacks()
        if kind == "memory":
            # Ownership/refcount attribution + leak suspects (`ray memory`).
            return state_api.memory_summary()
        if kind == "profile":
            # Cluster-wide sampling profile; blocks this executor thread
            # for ?duration= seconds (default 1).
            return state_api.profile(duration if duration is not None else 1.0)
        if kind == "train":
            # Training-gang goodput ledgers: ?gang= for one fit's report.
            return state_api.training_report((query or {}).get("gang"))
        if kind == "jobs":
            # Per-job accounting ledgers: every live driver plus the
            # finished-jobs ring; ?job=<hex> for one tenant's full report.
            job = (query or {}).get("job")
            if job:
                return state_api.job_report(job)
            return state_api.list_jobs()
        raise KeyError(kind)

    def _api(self, kind: str, query: dict):
        """(status, JSON body) of `GET /api/{kind}?query`."""
        if kind not in self.VALID_KINDS:
            return 404, {"error": f"unknown endpoint {kind!r}", "valid": list(self.VALID_KINDS)}
        limit = None
        raw_limit = query.get("limit")
        if raw_limit is not None:
            try:
                limit = max(0, int(raw_limit))
            except ValueError:
                return 400, {"error": f"invalid limit {raw_limit!r}"}
        duration = None
        raw_duration = query.get("duration")
        if raw_duration is not None:
            try:
                duration = min(max(0.0, float(raw_duration)), self.MAX_PROFILE_DURATION_S)
            except ValueError:
                return 400, {"error": f"invalid duration {raw_duration!r}"}
        app = query.get("app")
        try:
            payload = self._payload(kind, limit, duration, app, query)
        except ValueError as e:
            # Caller-shaped input error on the obs endpoints (bad ?name=,
            # non-numeric ?since=, malformed ?labels= JSON).
            return 400, {"error": str(e)}
        except KeyError as e:
            if kind == "serve" and app is not None:
                # /api/serve?app=<unknown>: caller error, not service failure.
                return 400, {"error": f"unknown app {app!r}"}
            if kind == "traces":
                # /api/traces?trace_id=<unknown>: caller error.
                return 400, {"error": str(e)}
            if kind == "jobs" and query.get("job"):
                # /api/jobs?job=<unknown>: caller error.
                return 400, {"error": str(e)}
            return 503, {"error": str(e)}
        except Exception as e:  # noqa: BLE001 — e.g. profiler disabled
            return 503, {"error": str(e)}
        return 200, payload

    def _respond(self, path: str, query: dict):
        """(status, content type, body bytes) of `GET path?query`: the
        reference's routes `/`, `/api/{kind}` and `/metrics`."""
        if path == "/":
            from ray_tpu_torch.dashboard.ui import INDEX_HTML

            return 200, "text/html; charset=utf-8", INDEX_HTML.encode()
        if path == "/metrics":
            from ray_tpu_torch.util.metrics import prometheus_text

            return 200, "text/plain; charset=utf-8", prometheus_text().encode()
        kind = path[len("/api/"):] if path.startswith("/api/") else ""
        if not kind or "/" in kind:
            return 404, "text/plain; charset=utf-8", b"404: Not Found"
        status, payload = self._api(urllib.parse.unquote(kind), query)
        body = json.dumps(payload, default=str).encode()
        return status, "application/json; charset=utf-8", body

    # ------------------------------------------------------------ lifecycle
    def start(self) -> int:
        """Bind and serve on a background thread; each request runs on a
        thread of its own, so a slow one (`/api/profile`) blocks no other."""
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — the standard library's name
                url = urllib.parse.urlsplit(self.path)
                query: dict = {}
                for k, v in urllib.parse.parse_qsl(url.query, keep_blank_values=True):
                    query.setdefault(k, v)  # the first value of a repeated key
                status, ctype, body = server._respond(url.path, query)
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *_args):  # no access log
                pass

        httpd = http.server.ThreadingHTTPServer((self._host, self._want_port), Handler)
        httpd.daemon_threads = True
        self._httpd = httpd
        self.port = httpd.server_address[1]
        threading.Thread(target=httpd.serve_forever, daemon=True, name="dashboard").start()
        return self.port

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


def start_dashboard(host: str = "127.0.0.1", port: int = 8265) -> DashboardServer:
    server = DashboardServer(host, port)
    server.start()
    return server
