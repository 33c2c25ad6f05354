"""Shared Serve dataclasses.

Reference: `python/ray/serve/_private/common.py` (DeploymentInfo,
ReplicaState) and `serve/config.py` (AutoscalingConfig).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

CONTROLLER_NAME = "SERVE_CONTROLLER"
PROXY_NAME = "SERVE_PROXY"
DEFAULT_HTTP_PORT = 8000


class ReplicaConstructorError(RuntimeError):
    """A replica's user constructor raised. Carries the constructor's
    traceback (the runtime reports a failed actor creation without its
    cause), so `serve.run` raises it instead of a bare "actor failed during
    creation"; the controller does not retry it (a constructor that raised
    once raises again)."""

    def __init__(self, deployment: str, traceback_str: str):
        super().__init__(
            f"a replica of deployment {deployment!r} raised in its "
            f"constructor:\n{traceback_str}"
        )
        self.deployment = deployment
        self.traceback_str = traceback_str

    def __reduce__(self):
        return (type(self), (self.deployment, self.traceback_str))


class RequestShedded(Exception):
    """Admission control rejected this request (per-app queue cap at a
    proxy, per-replica inflight cap at the router, a shed-aware
    `@serve.batch` queue, or a draining proxy). The HTTP front door maps it
    to a fast `503 + Retry-After`; handle callers see it raised from
    `.result()`. `reason` feeds `ray_tpu_serve_shed_total{app,reason}`."""

    def __init__(self, message: str, reason: str = "overload",
                 retry_after_s: float = 1.0):
        super().__init__(message)
        self.reason = reason
        self.retry_after_s = retry_after_s

    def __reduce__(self):
        # Default exception pickling replays __init__ with self.args (the
        # message only), silently resetting reason/retry_after_s to their
        # defaults — a replica-raised batch_queue shed would reach the
        # proxy as a generic "overload" with Retry-After 1.
        return (
            type(self),
            (str(self), self.reason, self.retry_after_s),
        )


@dataclass
class AutoscalingConfig:
    min_replicas: int = 1
    max_replicas: int = 10
    target_num_ongoing_requests_per_replica: float = 1.0
    upscale_delay_s: float = 0.0
    downscale_delay_s: float = 10.0
    # SLO-aware scaling: when set, the controller also scales UP whenever the
    # router-reported route-wait p95 (the route-wait histogram, windowed)
    # exceeds this for upscale_delay_s (hysteresis), and only scales DOWN
    # when the p95 sits below half of it — queue depth alone can look calm
    # while per-request latency is collapsing (slow replicas, big batches).
    target_route_wait_p95_s: Optional[float] = None

    def __post_init__(self):
        if not (0 < self.min_replicas <= self.max_replicas):
            raise ValueError("need 0 < min_replicas <= max_replicas")
        if self.target_route_wait_p95_s is not None and (
            self.target_route_wait_p95_s <= 0
        ):
            raise ValueError("target_route_wait_p95_s must be > 0")


@dataclass
class DeploymentInfo:
    name: str
    blob: bytes  # cloudpickled user class/function
    init_args: Tuple = ()
    init_kwargs: Dict[str, Any] = field(default_factory=dict)
    num_replicas: int = 1
    # In-flight calls one replica accepts concurrently (reference
    # `max_concurrent_queries`, default 100 there). Default 1 keeps the
    # strict one-at-a-time replica; raise it to overlap requests — required
    # for `@serve.batch` to ever see a second item.
    max_concurrent_queries: int = 1
    # Per-app admission cap at EACH HTTP proxy: admitted-but-unfinished
    # requests beyond this shed with 503 + Retry-After. 0 = use the global
    # `serve_queue_cap_default` config knob; negative disables for this app.
    max_queued_requests: int = 0
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)
    autoscaling_config: Optional[AutoscalingConfig] = None
    route_prefix: Optional[str] = None
    is_ingress: bool = False
    # True when the target class carries an ASGI app (@serve.ingress): the
    # proxy speaks ASGI to its replicas instead of the ProxyRequest protocol.
    is_asgi: bool = False
    version: int = 0


@dataclass
class ReplicaInfo:
    replica_id: str
    actor_id: Any  # ActorID — picklable
    deployment: str
    # Copied from the deployment so the ROUTER can cap per-replica load
    # decisions (affinity escape) without a controller round trip.
    max_concurrent_queries: int = 1
    # Controller-driven lifecycle (lifecycle.LIFECYCLE_SPEC "serve_replica"):
    # STARTING -> RUNNING -> DRAINING -> STOPPED.
    state: str = "STARTING"


@dataclass
class ProxyInfo:
    """A controller-managed HTTP proxy (one per node under EveryNode)."""

    proxy_id: str
    actor_id: Any  # ActorID — picklable
    node_id: str
    port: Optional[int] = None
    actor_name: str = ""
    # Controller-driven lifecycle (lifecycle.LIFECYCLE_SPEC "serve_proxy").
    state: str = "STARTING"
