"""Global Control Store: cluster-wide metadata tables.

The reference's GCS is a standalone C++ server wiring 13 managers
(`src/ray/gcs/gcs_server/gcs_server.cc:128-167`): node, actor, job,
placement-group, KV, health-check and task-event managers over a pluggable storage
backend. In this build the control plane is hosted in the driver process (single
controller per job); the tables below are the same managers' state, and the storage
backend seam (`InMemoryStore` here) mirrors `store_client/in_memory_store_client.h`
so a redis-backed variant can slot in for fault tolerance later.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch._private.ids import ActorID, NodeID, PlacementGroupID, TaskID


class InMemoryStore:
    """Pluggable KV storage seam (reference: `gcs/store_client/`)."""

    def __init__(self):
        self._data: Dict[str, Dict[bytes, bytes]] = {}
        self._lock = threading.Lock()

    def put(self, table: str, key: bytes, value: bytes) -> None:
        with self._lock:
            self._data.setdefault(table, {})[key] = value

    def get(self, table: str, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self._data.get(table, {}).get(key)

    def delete(self, table: str, key: bytes) -> bool:
        with self._lock:
            return self._data.get(table, {}).pop(key, None) is not None

    def keys(self, table: str, prefix: bytes = b"") -> List[bytes]:
        with self._lock:
            return [k for k in self._data.get(table, {}) if k.startswith(prefix)]


@dataclass
class ActorInfo:
    actor_id: ActorID
    name: Optional[str]
    class_name: str
    state: str = "PENDING"  # PENDING -> ALIVE -> RESTARTING -> DEAD
    max_restarts: int = 0
    num_restarts: int = 0
    node_id: Optional[NodeID] = None
    death_cause: Optional[str] = None


@dataclass
class TaskEvent:
    """Task lifecycle event for the state API / timeline (reference:
    `gcs_task_manager.h:61`, `task_event_buffer.h:188`)."""

    task_id: str
    name: str
    state: str
    timestamp: float
    node_id: str = ""
    worker_pid: int = 0
    extra: Dict[str, Any] = field(default_factory=dict)
    # Per-stage timestamp pipeline, populated on terminal events:
    # submit -> queued -> lease_granted -> args_fetched -> exec_start ->
    # exec_end -> result_stored (reference: the per-state timestamps of
    # `rpc::TaskEvents`/`task_event_buffer.h`; worker-side stages ride the
    # done message, so recording them adds no round trips).
    stages: Dict[str, float] = field(default_factory=dict)


# Canonical stage order for consumers (state API durations, timeline).
TASK_STAGES = (
    "submit", "queued", "lease_granted", "args_fetched",
    "exec_start", "exec_end", "result_stored",
)


class GCS:
    """In-driver control store; every mutation happens on the scheduler thread."""

    def __init__(self):
        self.store = InMemoryStore()
        self.actors: Dict[ActorID, ActorInfo] = {}
        self.named_actors: Dict[str, ActorID] = {}
        self.placement_groups: Dict[PlacementGroupID, Any] = {}
        self.function_table: Dict[str, bytes] = {}
        # Detached actors (lifetime="detached"): actor_id bytes -> pickled
        # creation record, persisted so a restarted head can restart them
        # (reference: Redis-backed GcsActorManager recovery).
        self.detached_actors: Dict[bytes, bytes] = {}
        # Bounded ring (reference: gcs_task_manager's
        # task_events_max_num_task_in_gcs): a full buffer drops the oldest
        # event per append, O(1), instead of periodic bulk head-drops.
        self._task_event_cap = 100000
        self.task_events: "deque[TaskEvent]" = deque(maxlen=self._task_event_cap)
        # Cluster event log (events.py): severity-tagged runtime transitions
        # (node lifecycle, worker crashes, scale decisions, Serve changes,
        # alert edges) in a bounded ring that rides the GCS snapshot, so the
        # event history survives a head restart under --persist. Entries are
        # plain tuples (ts, severity, kind, source, message, data_dict);
        # dicts materialize at read time (cluster_event_list).
        self._cluster_event_cap = 10000
        self.cluster_events: "deque[tuple]" = deque(maxlen=self._cluster_event_cap)
        # Monotonic append count (never decremented by ring eviction): the
        # head's telemetry exports it as ray_tpu_obs_events_total.
        self.cluster_events_total = 0
        # Trace-span ring (util/tracing.py): every process's flusher APPENDS
        # its new-span batches here (`spans_push` cmd), replacing the old
        # per-pid `spans::<pid>` KV blobs whose flush re-read and re-wrote
        # the process's whole history each second. Bounded; spans are plain
        # dicts; eviction is the retention policy (dead processes' spans
        # stay — a trace outlives its workers).
        self._trace_span_cap = 20000
        self.trace_spans: "deque[dict]" = deque(maxlen=self._trace_span_cap)
        self.trace_spans_total = 0
        # Finalized job ledgers (jobs.py): a dead driver's accounting seals
        # into this bounded ring instead of vanishing with the connection.
        # Rides the snapshot — "what did tenant X cost" survives a restart.
        self._finished_job_cap = 256
        self.finished_jobs: "deque[dict]" = deque(maxlen=self._finished_job_cap)
        self._subscribers: Dict[str, List[Callable[[Any], None]]] = {}

    # --- internal KV (reference: GcsKvManager / experimental.internal_kv) ---
    def kv_put(self, key: bytes, value: bytes, namespace: str = "default") -> None:
        self.store.put(f"kv:{namespace}", key, value)

    def kv_get(self, key: bytes, namespace: str = "default") -> Optional[bytes]:
        return self.store.get(f"kv:{namespace}", key)

    def kv_del(self, key: bytes, namespace: str = "default") -> bool:
        return self.store.delete(f"kv:{namespace}", key)

    def kv_keys(self, prefix: bytes, namespace: str = "default") -> List[bytes]:
        return self.store.keys(f"kv:{namespace}", prefix)

    def kv_event(self, payload: tuple) -> bool:
        """Remote cluster-event append riding the existing kv command
        (`ctx.kv("event", (kind, message, severity, source, data, ts))`), so
        non-head processes (Serve controller, autoscaler monitor) emit events
        with no new wire tag. See events.emit_event."""
        kind, message, severity, source, data, ts = payload
        self.append_cluster_event(kind, message, severity=severity,
                                  source=source, data=data, ts=ts)
        return True

    # --- pubsub (reference: src/ray/pubsub) ---
    def subscribe(self, channel: str, callback: Callable[[Any], None]) -> None:
        self._subscribers.setdefault(channel, []).append(callback)

    def publish(self, channel: str, message: Any) -> None:
        for cb in self._subscribers.get(channel, []):
            try:
                cb(message)
            except Exception:
                pass

    # --- finished jobs (jobs.py ledger finalization) ---
    def set_finished_job_cap(self, cap: int) -> None:
        """Resize the ring to `finished_jobs_cap` (config)."""
        cap = max(1, int(cap))
        if cap != self._finished_job_cap:
            self._finished_job_cap = cap
            self.finished_jobs = deque(self.finished_jobs, maxlen=cap)

    def append_finished_job(self, summary: dict) -> None:
        self.finished_jobs.append(summary)

    def finished_job_list(self) -> List[dict]:
        return [dict(s) for s in self.finished_jobs]

    # --- task events ---
    def set_task_event_cap(self, cap: int) -> None:
        """Resize the ring to `task_events_max_num_task_in_gcs` (config)."""
        cap = max(1, int(cap))
        if cap != self._task_event_cap:
            self._task_event_cap = cap
            self.task_events = deque(self.task_events, maxlen=cap)

    def record_task_event(self, ev: TaskEvent) -> None:
        self.record_event_tuple(
            (ev.task_id, ev.name, ev.state, ev.timestamp, ev.stages or None)
        )

    def record_event_tuple(self, ev: tuple) -> None:
        """Hot-path append: `(task_id_hex, name, state, timestamp,
        stages_or_None)`. The ring stores plain tuples (a dataclass + two
        default-factory dicts per event is measurable at 3 events/task);
        TaskEvent objects materialize at read time (task_event_list)."""
        self.task_events.append(ev)  # ring: maxlen evicts the oldest

    def task_event_list(self) -> List[TaskEvent]:
        return [
            TaskEvent(task_id=t, name=n, state=s, timestamp=ts, stages=st or {})
            for (t, n, s, ts, st) in self.task_events
        ]

    # --- trace spans (util/tracing.py; reference: the GCS task-event ring) ---
    def set_trace_span_cap(self, cap: int) -> None:
        cap = max(1, int(cap))
        if cap != self._trace_span_cap:
            self._trace_span_cap = cap
            self.trace_spans = deque(self.trace_spans, maxlen=cap)

    def append_trace_spans(self, spans) -> int:
        """O(new-spans) append of one process's flush batch."""
        n = 0
        for s in spans:
            if isinstance(s, dict) and "trace_id" in s:
                self.trace_spans.append(s)
                n += 1
        self.trace_spans_total += n
        return n

    def trace_span_list(self, trace_id: Optional[str] = None,
                        since: Optional[float] = None,
                        limit: Optional[int] = None) -> List[dict]:
        out = [
            dict(s) for s in self.trace_spans
            if (trace_id is None or s.get("trace_id") == trace_id)
            and (since is None or (s.get("start") or 0.0) >= since)
        ]
        if limit is not None and limit >= 0:
            # [-0:] would be the WHOLE list; limit=0 means none.
            out = out[-int(limit):] if int(limit) > 0 else []
        return out

    # --- cluster events (events.py; reference: the GCS error/event tables) ---
    def set_cluster_event_cap(self, cap: int) -> None:
        cap = max(1, int(cap))
        if cap != self._cluster_event_cap:
            self._cluster_event_cap = cap
            self.cluster_events = deque(self.cluster_events, maxlen=cap)

    def append_cluster_event(self, kind: str, message: str,
                             severity: str = "info", source: str = "head",
                             data: Optional[Dict[str, Any]] = None,
                             ts: Optional[float] = None) -> None:
        from ray_tpu_torch._private.events import SEVERITIES

        # Normalize unknown severities (a typo'd "warn" would otherwise
        # create an unfilterable level) instead of dropping the event.
        if severity not in SEVERITIES:
            severity = "info"
        self.cluster_events.append((
            float(ts) if ts is not None else time.time(),
            str(severity), str(kind), str(source), str(message),
            dict(data or {}),
        ))
        self.cluster_events_total += 1

    def cluster_event_list(self, limit: Optional[int] = None,
                           kind: Optional[str] = None,
                           severity: Optional[str] = None,
                           since: Optional[float] = None) -> List[Dict[str, Any]]:
        """Newest-last event dicts, optionally filtered. `limit` keeps the
        newest N *after* filtering."""
        out = [
            {"ts": ts, "severity": sev, "kind": k, "source": src,
             "message": msg, "data": dict(d)}
            for (ts, sev, k, src, msg, d) in self.cluster_events
            if (kind is None or k == kind)
            and (severity is None or sev == severity)
            and (since is None or ts >= since)
        ]
        if limit is not None and limit >= 0:
            out = out[-int(limit):]
        return out

    # --- persistence (reference: RedisStoreClient-backed GCS fault tolerance,
    # `store_client/redis_store_client.h:28`, restore at `gcs_server.cc:59`) ---
    def snapshot_bytes(self) -> bytes:
        """Serialize the durable tables: the KV store (jobs/metrics/user data
        ride it), the function table, and persisted actor records (detached
        actors AND named owned actors — both replay their creation on head
        restart; see scheduler._persist_detached). Other live entities
        (anonymous owned actors, nodes, task events) die with their
        processes and are intentionally not persisted — the reference
        reconstructs those from re-registration, not storage."""
        import pickle

        with self.store._lock:
            data = {t: dict(kv) for t, kv in self.store._data.items()}

        def _copy(d):
            # Mutated by the scheduler thread without a lock; retry the copy
            # across "dict changed size" races.
            for _ in range(5):
                try:
                    return dict(d)
                except RuntimeError:
                    continue
            return {}

        return pickle.dumps({
            "store": data,
            "functions": _copy(self.function_table),
            "detached_actors": _copy(self.detached_actors),
            # Event history survives head restarts: operators debugging a
            # crash need the transitions that led up to it, not a fresh ring.
            "cluster_events": list(self.cluster_events),
            "cluster_events_total": self.cluster_events_total,
            # Sealed tenant ledgers: accounting history is as durable as the
            # event history it explains.
            "finished_jobs": list(self.finished_jobs),
        })

    def restore_bytes(self, blob: bytes) -> None:
        import pickle

        payload = pickle.loads(blob)
        with self.store._lock:
            self.store._data = {t: dict(kv) for t, kv in payload["store"].items()}
        self.function_table.update(payload.get("functions", {}))
        self.detached_actors.update(payload.get("detached_actors", {}))
        for ev in payload.get("cluster_events", ()):
            self.cluster_events.append(ev)
        self.cluster_events_total += int(payload.get("cluster_events_total", 0))
        for s in payload.get("finished_jobs", ()):
            self.finished_jobs.append(s)

    def save_to(self, path: str) -> None:
        import os

        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(self.snapshot_bytes())
        os.replace(tmp, path)

    def load_from(self, path: str) -> bool:
        try:
            with open(path, "rb") as f:
                self.restore_bytes(f.read())
            return True
        except FileNotFoundError:
            return False
