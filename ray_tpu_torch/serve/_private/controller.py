"""ServeController: the reconciling control plane of Serve.

Reference: `python/ray/serve/_private/controller.py:73` (`ServeController`)
+ `deployment_state.py:1009` (`DeploymentState` reconciler) +
`_private/long_poll.py:185` (`LongPollHost`) + `http_state.py` (per-node
proxy management) + `autoscaling_policy.py`.
One named actor holds the desired state (deployments -> replica sets, plus
the per-node HTTP proxy fleet), starts/stops replica AND proxy actors to
match, PUSHES routing tables / app admission caps / the proxy set to
routers and proxies via key-versioned long polls (`listen_for_change` —
callers block in a threaded-actor slot until a watched key's version
moves), and runs the autoscaling loop off router-reported load and the
route-wait p95 SLO signal.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import lifecycle
from ray_tpu_torch._private.events import emit_event
from ray_tpu_torch.serve._private.common import (
    PROXY_NAME,
    DeploymentInfo,
    ProxyInfo,
    ReplicaInfo,
)

# Long-poll keys: f"replicas::{deployment}", ROUTES_KEY, CAPS_KEY. (The
# proxy FLEET is pull-based — get_proxies / the head's service directory —
# so there is deliberately no long-poll key for it.)
ROUTES_KEY = "routes"
CAPS_KEY = "app_caps"
# Server-side re-arm bound: a poll with no change returns {} after this long
# and the client immediately re-polls (keeps slots from being held forever).
LISTEN_TIMEOUT_S = 20.0
# Cancelled-listener set bound: ids whose listener already unparked (timeout
# race) would otherwise pin a set entry forever.
_MAX_CANCELLED = 1024


class ServeController:
    """Deploy with max_concurrency: long-polling routers each occupy one call
    slot while they wait."""

    def __init__(self):
        self._deployments: Dict[str, DeploymentInfo] = {}
        self._replicas: Dict[str, List[ReplicaInfo]] = {}
        self._replica_counter = 0
        # route_prefix -> (deployment name, is_asgi)
        self._routes: Dict[str, tuple] = {}
        # deployment -> resolved per-proxy admission cap (0 = uncapped).
        self._app_caps: Dict[str, int] = {}
        # node_id -> ProxyInfo for controller-managed per-node proxies.
        self._proxies: Dict[str, ProxyInfo] = {}
        self._proxy_location: Optional[str] = None
        self._proxy_port = 0
        # Nodes cordoned off ingress (drain_proxy): the reconcile loop must
        # not re-adopt the still-alive draining actor (nor respawn one) —
        # a later ensure_proxies() lifts the cordon.
        self._proxy_cordoned: set = set()
        self._self_handle = None
        self._last_proxy_reconcile = 0.0
        # deployment -> {router_id -> (inflight, timestamp, route_wait_p95)}
        self._load: Dict[str, Dict[str, Any]] = {}
        self._downscale_since: Dict[str, Optional[float]] = {}
        self._slo_violation_since: Dict[str, Optional[float]] = {}
        # deployment -> seconds each replica start held self._lock (the
        # constructor included: a GPU replica loads its model there).
        self._replica_start_s: Dict[str, List[float]] = {}
        # deployment -> replicas its GPU share lets the cluster hold (None
        # without a share); an autoscaling upscale stops there.
        self._gpu_caps: Dict[str, Optional[int]] = {}
        self._lock = threading.RLock()
        # Serializes proxy reconciliation passes (ensure_proxies vs the
        # control loop's tick): NOT self._lock — reconciliation does
        # blocking actor calls and must never hold the long-poll lock.
        self._proxy_reconcile_lock = threading.Lock()
        self._change = threading.Condition(self._lock)
        self._versions: Dict[str, int] = {}
        # Long-poll listener bookkeeping: parked call count (leak regression
        # tests read it) + cancelled listener ids (a GC'd router's __del__
        # unparks its listener so controller call slots recycle promptly).
        self._parked_listeners = 0
        self._cancelled_listeners: Dict[str, None] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._control_loop, daemon=True, name="serve-controller"
        )
        self._thread.start()

    # ------------------------------------------------------------- long poll
    def _bump(self, key: str) -> None:
        """Record a change under `key` and wake blocked listeners (must hold
        self._lock)."""
        self._versions[key] = self._versions.get(key, 0) + 1
        self._change.notify_all()

    def _snapshot(self, key: str):
        if key == ROUTES_KEY:
            return dict(self._routes)
        if key == CAPS_KEY:
            return dict(self._app_caps)
        if key.startswith("replicas::"):
            return list(self._replicas.get(key[len("replicas::"):], []))
        return None

    def listen_for_change(self, known: Dict[str, int],
                          listener_id: Optional[str] = None) -> Dict[str, Any]:
        """Block until any watched key's version differs from the caller's,
        then return {key: (version, snapshot)} for the changed keys; {} on
        server-side timeout (client re-arms) or when the listener was
        cancelled (its router was closed/GC'd — the slot must come back).
        The push half of the reference's LongPollHost (`long_poll.py:185`)."""
        deadline = time.time() + LISTEN_TIMEOUT_S
        with self._change:
            self._parked_listeners += 1
            try:
                while True:
                    if (
                        listener_id is not None
                        and listener_id in self._cancelled_listeners
                    ):
                        del self._cancelled_listeners[listener_id]
                        return {}
                    changed = {
                        k: (self._versions.get(k, 0), self._snapshot(k))
                        for k, v in known.items()
                        if self._versions.get(k, 0) != v
                    }
                    if changed:
                        return changed
                    remaining = deadline - time.time()
                    if remaining <= 0 or self._stop.is_set():
                        return {}
                    self._change.wait(remaining)
            finally:
                self._parked_listeners -= 1

    def cancel_listener(self, listener_id: str) -> None:
        """Unpark (and retire) one listener by id — called by Router.close /
        __del__ so a deleted handle's long-poll slot frees immediately
        instead of leaking across app redeploys."""
        with self._change:
            self._cancelled_listeners[listener_id] = None
            while len(self._cancelled_listeners) > _MAX_CANCELLED:
                self._cancelled_listeners.pop(
                    next(iter(self._cancelled_listeners))
                )
            self._change.notify_all()

    def listener_count(self) -> int:
        """Currently-parked listen_for_change calls (leak regression gauge)."""
        with self._lock:
            return self._parked_listeners

    # ------------------------------------------------------------- deployment
    def _resolve_cap(self, info: DeploymentInfo) -> int:
        """Per-proxy admission cap for one app: option > 0 wins, 0 defers to
        the serve_queue_cap_default knob, negative disables (0 out)."""
        from ray_tpu_torch._private.config import get_config

        raw = int(getattr(info, "max_queued_requests", 0))
        if raw > 0:
            return raw
        if raw < 0:
            return 0
        return max(0, int(get_config().serve_queue_cap_default))

    def deploy(self, info: DeploymentInfo) -> None:
        with self._lock:
            existing = self._deployments.get(info.name)
            if existing is not None:
                info.version = existing.version + 1
            self._deployments[info.name] = info
            self._app_caps[info.name] = self._resolve_cap(info)
            self._bump(CAPS_KEY)
            if info.route_prefix:
                self._routes[info.route_prefix] = (info.name, info.is_asgi)
                self._bump(ROUTES_KEY)
            if info.autoscaling_config:
                target = max(
                    info.autoscaling_config.min_replicas,
                    min(info.num_replicas, info.autoscaling_config.max_replicas),
                )
            else:
                target = info.num_replicas
            if existing is not None:
                # Redeploy: replace existing replicas with the new version.
                # The old set drains in the background (graceful) while the
                # new set comes up — routers already stopped sending to it.
                self._scale_to(info.name, 0)
            self._scale_to(info.name, target)
            version = info.version
        # Emit OUTSIDE the lock: the event append is a blocking control-plane
        # round trip and long-poll listeners share self._lock.
        # deploy() runs as an actor call, so the executing worker's job_id is
        # the CALLING driver's (worker_main sets it per task): riding it on
        # the event is what lets the head's JobLedger attribute this app's
        # proxy request counters to the deploying tenant — no new wire tag.
        from ray_tpu_torch._private.worker import global_worker

        job = global_worker.job_id.hex() if global_worker.job_id else None
        emit_event(
            "serve_deploy",
            f"app {info.name} v{version} deployed "
            f"({target} replica(s), route {info.route_prefix or '-'})",
            source="serve-controller", app=info.name, version=version,
            replicas=target, job=job,
        )

    def delete_deployment(self, name: str) -> None:
        with self._lock:
            self._scale_to(name, 0)
            self._deployments.pop(name, None)
            self._replicas.pop(name, None)
            self._load.pop(name, None)
            self._app_caps.pop(name, None)
            # Hysteresis clocks die with the app: a same-name redeploy must
            # not inherit a minutes-old violation/downscale timestamp.
            self._slo_violation_since.pop(name, None)
            self._downscale_since.pop(name, None)
            self._replica_start_s.pop(name, None)
            self._gpu_caps.pop(name, None)
            self._routes = {p: d for p, d in self._routes.items() if d[0] != name}
            self._bump(ROUTES_KEY)
            self._bump(CAPS_KEY)
            self._bump(f"replicas::{name}")
        emit_event("serve_delete", f"app {name} deleted",
                   source="serve-controller", app=name)

    def _scale_to(self, name: str, target: int, drain: bool = True) -> None:
        import ray_tpu_torch
        from ray_tpu_torch._private import retry
        from ray_tpu_torch._private.config import get_config
        from ray_tpu_torch.exceptions import RayActorError, RayTaskError, WorkerCrashedError
        from ray_tpu_torch.serve._private.replica import ServeReplica

        info = self._deployments[name]
        replicas = self._replicas.setdefault(name, [])
        cfg = get_config()
        while len(replicas) < target:
            t_start = time.perf_counter()
            self._replica_counter += 1
            rid = f"{name}#{self._replica_counter}"
            opts = dict(info.ray_actor_options or {})
            opts.setdefault("num_cpus", 0.1)
            opts["name"] = f"SERVE_REPLICA::{rid}"
            if info.max_concurrent_queries > 1:
                # Threaded replica calls; async user methods share the
                # actor's event loop, where @serve.batch queues live.
                opts["max_concurrency"] = int(info.max_concurrent_queries)

            def _create():
                handle = (
                    ray_tpu_torch.remote(ServeReplica)
                    .options(**opts)
                    .remote(
                        name, info.blob, info.init_args, info.init_kwargs,
                        max_concurrent_queries=info.max_concurrent_queries,
                    )
                )
                # Block until constructed so routing tables only list live
                # replicas. A user constructor that raised surfaces here with
                # its traceback; the replica goes, with its resources.
                try:
                    ray_tpu_torch.get(handle.ready.remote())
                except RayTaskError as e:
                    ray_tpu_torch.kill(handle)
                    raise (e.cause or e) from None
                return handle

            # Replica churn rides the unified retry policy (_private/retry.py):
            # a node that just lost capacity (autoscaler/preemption) fails
            # creation for a beat — deterministic backoff instead of a hot failure loop.
            # Sleeps are capped well below the config max: _scale_to runs
            # under self._lock (long-poll listeners share it), so a failing
            # placement must cost milliseconds of lock hold, not seconds.
            # Only a lost creation is retried: a constructor that raised
            # (ReplicaConstructorError) raises again, so it goes to the caller.
            handle = retry.call_with_retry(
                _create,
                retry.RetryPolicy(
                    max_attempts=3,
                    base_delay_s=max(0.0, cfg.retry_backoff_base_ms / 1000.0),
                    max_delay_s=0.25,
                ),
                retry_on=(RayActorError, WorkerCrashedError),
            )
            rep = ReplicaInfo(
                rid, handle._actor_id, name,
                max_concurrent_queries=info.max_concurrent_queries,
            )
            # The creation retry loop above succeeded: the actor exists and
            # routers may target it as soon as the table bumps.
            rep.state = lifecycle.step("serve_replica", rep.state, "RUNNING")
            replicas.append(rep)
            self._bump(f"replicas::{name}")
            self._replica_start_s.setdefault(name, []).append(
                time.perf_counter() - t_start
            )
        while len(replicas) > target:
            rep = replicas.pop()
            # Routers stop sending the moment this push lands; the replica
            # then finishes its inflight window before the kill (graceful
            # drain — zero admitted requests dropped).
            self._bump(f"replicas::{name}")
            if drain:
                self._drain_then_kill(rep)
            else:
                self._kill_replica(rep)

    # ----------------------------------------------------------------- drain
    def _drain_then_kill(self, rep: ReplicaInfo) -> None:
        """Background graceful stop: wait out the replica's inflight window
        (scheduler-side count — it sees calls still parked in the actor's
        ordered queue, which the replica itself cannot), then kill."""
        from ray_tpu_torch._private.config import get_config

        timeout_s = float(get_config().serve_drain_timeout_s)
        rep.state = lifecycle.step("serve_replica", rep.state, "DRAINING")

        def drain():
            from ray_tpu_torch._private.worker import global_worker

            ctx = global_worker.context
            deadline = time.monotonic() + timeout_s
            try:
                while time.monotonic() < deadline:
                    left = ctx.serve_actor_inflight(rep.actor_id.binary())
                    if not left:
                        break
                    time.sleep(0.05)
            except Exception:  # noqa: BLE001 — head gone/actor dead: just kill
                pass
            self._kill_replica(rep)

        threading.Thread(
            target=drain, daemon=True, name=f"serve-drain-{rep.replica_id}"
        ).start()

    def _kill_replica(self, rep: ReplicaInfo) -> None:
        import ray_tpu_torch
        from ray_tpu_torch.actor import ActorHandle

        rep.state = lifecycle.step("serve_replica", rep.state, "STOPPED")
        try:
            ray_tpu_torch.kill(ActorHandle(rep.actor_id, "ServeReplica"))
        except Exception:
            pass

    # ----------------------------------------------------------- proxy fleet
    def _own_handle(self):
        """An ActorHandle to THIS controller actor (passed to proxies)."""
        if self._self_handle is None:
            import ray_tpu_torch
            from ray_tpu_torch.actor import ActorHandle
            from ray_tpu_torch.serve._private.common import CONTROLLER_NAME

            h = ray_tpu_torch.get_actor(CONTROLLER_NAME)
            self._self_handle = ActorHandle(h._actor_id, "ServeController")
        return self._self_handle

    def ensure_proxies(self, port: int = 0) -> Dict[str, int]:
        """Reconcile one HTTP proxy actor per alive node (the reference's
        proxy_location="EveryNode", `http_state.py`): spawned/managed here
        exactly like replicas, registered in the head's service directory on
        bind, each mirroring the routing table via the shared long poll.
        Adding a node adds ingress capacity on the next reconcile tick;
        killing a proxy removes one Retry-After target until its restart.
        Returns node_id -> bound port."""
        with self._lock:
            self._proxy_location = "EveryNode"
            self._proxy_port = int(port)
            self._proxy_cordoned.clear()
        self._reconcile_proxies()
        with self._lock:
            return {nid: p.port for nid, p in self._proxies.items()}

    def _reconcile_proxies(self) -> None:
        with self._proxy_reconcile_lock:
            self._reconcile_proxies_locked()

    def _reconcile_proxies_locked(self) -> None:
        import ray_tpu_torch
        from ray_tpu_torch.actor import ActorHandle
        from ray_tpu_torch.serve._private.http_proxy import HTTPProxy
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy,
        )

        with self._lock:
            if self._proxy_location != "EveryNode":
                return
            existing = dict(self._proxies)
            cordoned = set(self._proxy_cordoned)
            want_port = self._proxy_port
        try:
            nodes = ray_tpu_torch.nodes()
        except Exception:  # noqa: BLE001 — head unreachable mid-shutdown
            return
        alive = {
            n["node_id"] for n in nodes
            if n.get("alive", True) and n["node_id"] not in cordoned
        }
        for nid in list(existing):
            if nid not in alive:
                with self._lock:
                    p = self._proxies.pop(nid, None)
                if p is not None:
                    p.state = lifecycle.step("serve_proxy", p.state, "STOPPED")
                existing.pop(nid, None)
        for nid in sorted(alive):
            # Re-check the LIVE cordon set per node: a drain_proxy that
            # lands mid-pass (this loop blocks on actor probes) must not
            # have its node resurrected by the snapshot taken at pass start.
            with self._lock:
                if nid in self._proxy_cordoned:
                    continue
            info = existing.get(nid)
            respawn = False
            if info is not None:
                # Liveness/port probe: a crash-restarted proxy comes back
                # with no listener (EveryNode binds ephemeral ports in
                # start(), not the creation task) — restart it.
                try:
                    h = ActorHandle(info.actor_id, "HTTPProxy")
                    bound = ray_tpu_torch.get(h.port.remote(), timeout=10)
                    if bound is None:
                        bound = ray_tpu_torch.get(
                            h.start.remote(port=want_port), timeout=30
                        )
                    if bound != info.port:
                        info.port = bound
                    continue
                except Exception:  # noqa: BLE001 — actor gone: respawn below
                    respawn = True
                    with self._lock:
                        p = self._proxies.pop(nid, None)
                    if p is not None:
                        p.state = lifecycle.step("serve_proxy", p.state,
                                                 "STOPPED")
            name = f"{PROXY_NAME}::{nid[:8]}"
            proxy_id = f"{name}@{nid[:8]}"
            try:
                handle = (
                    ray_tpu_torch.remote(HTTPProxy)
                    .options(
                        name=name,
                        num_cpus=0.1,
                        get_if_exists=True,
                        lifetime="detached",
                        max_restarts=10,
                        scheduling_strategy=NodeAffinitySchedulingStrategy(
                            node_id=nid, soft=False
                        ),
                    )
                    # One identity across the fleet registry AND the head's
                    # service directory: the proxy announces this id on bind.
                    .remote(self._own_handle(), proxy_id=proxy_id)
                )
                # get_if_exists may adopt a proxy another driver started:
                # starting it again would stack a second HTTP server (and
                # start() is idempotent on a live listener regardless).
                # Default want_port=0 binds a free port — required when
                # virtual nodes share one host.
                bound = ray_tpu_torch.get(handle.port.remote(), timeout=30)
                if bound is None:
                    bound = ray_tpu_torch.get(
                        handle.start.remote(port=want_port), timeout=60
                    )
            except Exception:  # noqa: BLE001 — node raced away; next tick
                continue
            with self._lock:
                if nid in self._proxy_cordoned:
                    # Cordoned while we were spawning: registering it would
                    # leak a live announced proxy the drain already decided
                    # to remove — kill it instead.
                    cordon_hit = True
                else:
                    cordon_hit = False
                    p = ProxyInfo(
                        proxy_id=proxy_id,
                        actor_id=handle._actor_id,
                        node_id=nid,
                        port=bound,
                        actor_name=name,
                    )
                    # Bound and probed above: it serves as soon as it is in
                    # the fleet table.
                    p.state = lifecycle.step("serve_proxy", p.state, "RUNNING")
                    self._proxies[nid] = p
            if cordon_hit:
                try:
                    ray_tpu_torch.kill(ActorHandle(handle._actor_id, "HTTPProxy"))
                except Exception:
                    pass
            elif respawn:
                emit_event(
                    "serve_proxy_failover",
                    f"proxy on node {nid[:8]} was dead; respawned on port "
                    f"{bound}",
                    severity="warning", source="serve-controller",
                    node_id=nid, port=bound,
                )

    def get_proxies(self) -> Dict[str, Dict[str, Any]]:
        """node_id -> {actor_id, port, name, proxy_id} for managed proxies."""
        with self._lock:
            return {
                nid: {
                    "actor_id": p.actor_id,
                    "port": p.port,
                    "name": p.actor_name,
                    "proxy_id": p.proxy_id,
                }
                for nid, p in self._proxies.items()
            }

    def drain_proxy(self, node_id: str, timeout_s: Optional[float] = None) -> dict:
        """Gracefully drain one managed proxy over the wire protocol
        (serve_drain tag via the head): it stops accepting (503 +
        Retry-After), withdraws from the service directory, finishes its
        in-flight HTTP requests, then is killed and dropped from the fleet."""
        import ray_tpu_torch
        from ray_tpu_torch._private.config import get_config
        from ray_tpu_torch._private.worker import global_worker
        from ray_tpu_torch.actor import ActorHandle

        if timeout_s is None:
            timeout_s = float(get_config().serve_drain_timeout_s)
        with self._lock:
            p = self._proxies.pop(node_id, None)
            if p is not None:
                # Cordon BEFORE the (slow) drain: the reconcile tick must
                # not re-adopt the still-alive draining actor and push it
                # back to clients mid-drain.
                self._proxy_cordoned.add(node_id)
        if p is None:
            return {"ok": False, "inflight": -1, "error": "no proxy on node"}
        p.state = lifecycle.step("serve_proxy", p.state, "DRAINING")
        result = global_worker.context.serve_drain_actor(
            p.actor_id.binary(), float(timeout_s)
        )
        try:
            ray_tpu_torch.kill(ActorHandle(p.actor_id, "HTTPProxy"))
        except Exception:
            pass
        p.state = lifecycle.step("serve_proxy", p.state, "STOPPED")
        emit_event(
            "serve_proxy_drain",
            f"proxy on node {node_id[:8]} drained and removed "
            f"(inflight at finish: {result.get('inflight')})",
            source="serve-controller", node_id=node_id,
            ok=bool(result.get("ok")),
        )
        return result

    # ---------------------------------------------------------------- routing
    def get_replicas(self, name: str) -> List[ReplicaInfo]:
        with self._lock:
            return list(self._replicas.get(name, []))

    def get_routes(self) -> Dict[str, tuple]:
        """route_prefix -> (deployment_name, is_asgi)."""
        with self._lock:
            return dict(self._routes)

    def get_app_caps(self) -> Dict[str, int]:
        """deployment -> resolved per-proxy admission cap (0 = uncapped)."""
        with self._lock:
            return dict(self._app_caps)

    def list_deployments(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {
                name: {
                    "num_replicas": len(self._replicas.get(name, [])),
                    "route_prefix": info.route_prefix,
                    "version": info.version,
                    "autoscaling": info.autoscaling_config is not None,
                    "gpu_replica_cap": self._gpu_caps.get(name),
                    "replica_start_s": list(self._replica_start_s.get(name, [])),
                }
                for name, info in self._deployments.items()
            }

    def ingress_status(self) -> Dict[str, Any]:
        """Apps + replicas + proxy fleet with live queue depth / inflight /
        shed counters (the dashboard's /api/serve payload)."""
        import ray_tpu_torch
        from ray_tpu_torch.actor import ActorHandle

        now = time.time()
        with self._lock:
            apps: Dict[str, Any] = {}
            for name, info in self._deployments.items():
                loads = self._load.get(name, {})
                inflight = sum(
                    v[0] for v in loads.values() if now - v[1] < 5.0
                )
                p95s = [
                    v[2] for v in loads.values()
                    if now - v[1] < 5.0 and len(v) > 2 and v[2] is not None
                ]
                apps[name] = {
                    "route_prefix": info.route_prefix,
                    "version": info.version,
                    "replicas": [
                        r.replica_id for r in self._replicas.get(name, [])
                    ],
                    "max_queued_requests": self._app_caps.get(name, 0),
                    "autoscaling": info.autoscaling_config is not None,
                    "inflight": inflight,
                    "route_wait_p95_s": max(p95s) if p95s else None,
                    "queue_depth": 0,
                    "shed": 0,
                    "requests": 0,
                }
            proxy_infos = dict(self._proxies)
        # Poll every proxy CONCURRENTLY: a sequential loop would make the
        # dashboard's /api/serve degrade linearly with unreachable proxies
        # (N x the per-proxy timeout).
        stats_by_nid: Dict[str, Any] = {}

        def _poll(nid, p):
            try:
                stats_by_nid[nid] = ray_tpu_torch.get(
                    ActorHandle(p.actor_id, "HTTPProxy").ingress_stats.remote(),
                    timeout=2,
                )
            except Exception:  # noqa: BLE001 — mid-restart proxy: listed bare
                pass

        pollers = [
            threading.Thread(target=_poll, args=(nid, p), daemon=True)
            for nid, p in proxy_infos.items()
        ]
        for t in pollers:
            t.start()
        for t in pollers:
            t.join(timeout=5)
        proxies: List[Dict[str, Any]] = []
        for nid, p in proxy_infos.items():
            entry: Dict[str, Any] = {
                "node_id": nid, "port": p.port, "proxy_id": p.proxy_id,
            }
            stats = stats_by_nid.get(nid)
            if stats is None:
                entry["unreachable"] = True
            else:
                entry.update(stats)
                for dep, s in stats.get("apps", {}).items():
                    if dep in apps:
                        apps[dep]["queue_depth"] += s.get("inflight", 0)
                        apps[dep]["shed"] += s.get("shed", 0)
                        apps[dep]["requests"] += s.get("requests", 0)
            proxies.append(entry)
        return {"apps": apps, "proxies": proxies}

    def report_failure(self, name: str, replica_id: str) -> None:
        """Router saw a dead replica: replace it (reference: replica recovery
        in DeploymentState reconciliation)."""
        replaced = False
        with self._lock:
            replicas = self._replicas.get(name, [])
            before = len(replicas)
            for r in replicas:
                if r.replica_id == replica_id:
                    r.state = lifecycle.step("serve_replica", r.state, "STOPPED")
            replicas[:] = [r for r in replicas if r.replica_id != replica_id]
            if len(replicas) < before:
                self._bump(f"replicas::{name}")
                if name in self._deployments:
                    self._scale_to(name, before)
                    replaced = True
        if replaced:
            emit_event(
                "serve_replica_failover",
                f"replica {replica_id} of app {name} died; replacement "
                "started",
                severity="warning", source="serve-controller", app=name,
                replica_id=replica_id,
            )

    # ------------------------------------------------------------ autoscaling
    def report_load(self, name: str, router_id: str, inflight: int,
                    route_wait_p95: Optional[float] = None) -> None:
        with self._lock:
            self._load.setdefault(name, {})[router_id] = (
                inflight, time.time(), route_wait_p95
            )

    @staticmethod
    def _gpu_replica_cap(info: DeploymentInfo, cur: int) -> Optional[int]:
        """Replicas a GPU-share deployment can hold: its `cur` ones plus as
        many as the node's free GPU places; None without a share."""
        import ray_tpu_torch

        share = float((info.ray_actor_options or {}).get("num_gpus", 0) or 0)
        if share <= 0:
            return None
        free = float(ray_tpu_torch.available_resources().get("GPU", 0.0))
        return cur + int(free / share + 1e-9)

    def _control_loop(self):
        while not self._stop.wait(0.5):
            try:
                self._autoscale_once()
            except Exception:
                pass
            try:
                now = time.monotonic()
                if now - self._last_proxy_reconcile >= 2.0:
                    self._last_proxy_reconcile = now
                    self._reconcile_proxies()
            except Exception:
                pass

    def _autoscale_once(self):
        now = time.time()
        scaled: List[tuple] = []
        with self._lock:
            for name, info in list(self._deployments.items()):
                cfg = info.autoscaling_config
                if cfg is None:
                    continue
                loads = self._load.get(name, {})
                fresh = [v for v in loads.values() if now - v[1] < 5.0]
                total = sum(v[0] for v in fresh)
                p95s = [
                    v[2] for v in fresh if len(v) > 2 and v[2] is not None
                ]
                p95 = max(p95s) if p95s else None
                cur = len(self._replicas.get(name, []))
                desired = max(
                    cfg.min_replicas,
                    min(
                        cfg.max_replicas,
                        -(-total // max(cfg.target_num_ongoing_requests_per_replica, 1e-9))
                        if total
                        else cfg.min_replicas,
                    ),
                )
                desired = int(desired)
                # SLO pressure: queue depth can look fine while the p95
                # collapses (slow model, deep batches). A sustained
                # violation (hysteresis = upscale_delay_s) forces +1 above
                # the queue-depth answer; a comfortably-met SLO (p95 under
                # half the target) releases the floor so downscale can run.
                slo = cfg.target_route_wait_p95_s
                if slo is not None:
                    if p95 is not None and p95 > slo:
                        since = self._slo_violation_since.get(name)
                        if since is None:
                            self._slo_violation_since[name] = now
                        elif now - since >= cfg.upscale_delay_s:
                            desired = min(cfg.max_replicas, max(desired, cur + 1))
                            self._slo_violation_since[name] = now
                    else:
                        # Met OR no fresh signal (idle): the violation clock
                        # resets — a single violating sample after an idle
                        # gap must not ride a stale timestamp past the
                        # upscale_delay_s hysteresis.
                        self._slo_violation_since[name] = None
                        if p95 is not None and p95 > 0.5 * slo and desired < cur:
                            desired = cur  # hold: SLO met but not by margin
                cap = self._gpu_replica_cap(info, cur)
                self._gpu_caps[name] = cap
                if cap is not None and desired > cap:
                    # An upscale past what the free GPU holds would block
                    # this loop (and every router) on a replica the
                    # scheduler cannot place.
                    desired = max(cur, cap)
                if desired > cur:
                    self._downscale_since[name] = None
                    self._scale_to(name, desired)
                    scaled.append((name, cur, desired, p95))
                elif desired < cur:
                    since = self._downscale_since.get(name)
                    if since is None:
                        self._downscale_since[name] = now
                    elif now - since >= cfg.downscale_delay_s:
                        self._scale_to(name, desired)
                        self._downscale_since[name] = None
                        scaled.append((name, cur, desired, p95))
                else:
                    self._downscale_since[name] = None
        # Events emitted after the lock drops (the append is a blocking
        # control-plane round trip; long-poll listeners share self._lock).
        for name, cur, desired, p95 in scaled:
            emit_event(
                "serve_scale",
                f"app {name} autoscaled {cur} -> {desired} replica(s)"
                + (f" (route-wait p95 {p95 * 1000:.0f}ms)"
                   if p95 is not None else ""),
                source="serve-controller", app=name,
                replicas_before=cur, replicas_after=desired,
            )

    def shutdown(self) -> None:
        import ray_tpu_torch
        from ray_tpu_torch.actor import ActorHandle

        with self._lock:
            for name in list(self._deployments):
                # Teardown: immediate kills (nothing routes here anymore).
                self._scale_to(name, 0, drain=False)
            self._deployments.clear()
            self._replicas.clear()
            self._routes.clear()
            self._app_caps.clear()
            proxies = list(self._proxies.values())
            self._proxies.clear()
            self._proxy_cordoned.clear()
            self._proxy_location = None
            self._stop.set()
            self._change.notify_all()  # release parked long-polls
        for p in proxies:
            p.state = lifecycle.step("serve_proxy", p.state, "STOPPED")
            try:
                ray_tpu_torch.kill(ActorHandle(p.actor_id, "HTTPProxy"))
            except Exception:
                pass
