"""Driver-hosted cluster scheduler: node table, worker pools, task dispatch,
placement groups, and fault handling.

This collapses three reference components into one event loop, keeping their seams:
 - `ClusterTaskManager`/`LocalTaskManager` two-level scheduling with a hybrid
   pack-then-spread policy (`src/ray/raylet/scheduling/
   cluster_task_manager.h`, `local_task_manager.h`, `policy/hybrid_scheduling_policy.cc`),
 - the worker pool with on-demand startup (`raylet/worker_pool.h:77`),
 - the GCS actor/placement-group managers (`gcs/gcs_server/gcs_actor_manager.h:281`,
   `gcs_placement_group_manager.h:223`).

Threading: ONE scheduler thread owns all mutable state. Driver API threads and
worker pipes feed it through a command queue + wakeup socket; results come back on
`concurrent.futures.Future`s. Workers blocked in `get`/`wait` release their CPU so
recursive task graphs cannot deadlock the pool (the reference releases resources on
`ray.get` the same way).
"""

from __future__ import annotations

import base64
import concurrent.futures
import itertools
import math
import multiprocessing
import os
import pickle
import queue
import socket
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private import failpoints, lifecycle, serialization, session_monitor
from ray_tpu_torch._private.batching import approx_msg_nbytes as _approx_msg_nbytes
from ray_tpu_torch._private.concurrency import any_thread, loop_thread_only
from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.gcs import GCS, ActorInfo
from ray_tpu_torch._private.ids import (
    ActorID,
    JobID,
    NodeID,
    ObjectID,
    PlacementGroupID,
    TaskID,
    WorkerID,
)
from ray_tpu_torch._private.object_store import ObjectMeta
from ray_tpu_torch._private.protocol import ExecRequest, FunctionDescriptor, TaskSpec
from ray_tpu_torch._private.worker_main import WorkerArgs, worker_loop
from ray_tpu_torch._private.wire import WireDecodeError
from ray_tpu_torch.exceptions import FrameTooLargeError

_mp = multiprocessing.get_context("spawn")
# How long shutdown waits for killed worker processes to exit.
_EXIT_WAIT_S = 10.0


class _Proc:
    """Popen adapter with a multiprocessing.Process-like surface."""

    def __init__(self, popen: subprocess.Popen):
        self.popen = popen

    @property
    def pid(self) -> int:
        return self.popen.pid

    def is_alive(self) -> bool:
        return self.popen.poll() is None

    def terminate(self) -> None:
        try:
            self.popen.kill()
        except ProcessLookupError:
            pass

    def join(self, timeout: Optional[float] = None) -> None:
        try:
            self.popen.wait(timeout)
        except subprocess.TimeoutExpired:
            pass


class _RemoteProc:
    """Process surface for a worker living on a daemon-managed node. Liveness is
    driven by the daemon's ("worker_exit", ...) notifications rather than local
    polling; terminate() relays a kill to the daemon."""

    def __init__(self, daemon: "DaemonHandle", worker_id_hex: str):
        self._daemon = daemon
        self._worker_id_hex = worker_id_hex
        self._alive = True

    @property
    def pid(self) -> int:
        return -1

    def is_alive(self) -> bool:
        return self._alive

    def mark_dead(self) -> None:
        self._alive = False

    def terminate(self) -> None:
        self._alive = False
        self._daemon.send(("kill_worker", self._worker_id_hex))

    def join(self, timeout: Optional[float] = None) -> None:
        pass


def _frames(msg) -> List[bytes]:
    """``msg``'s frames; one over ``wire_max_frame_bytes`` is reported and
    dropped (the connection stays up; the sender-side checks keep task
    arguments and results from getting here)."""
    try:
        return serialization.frames(msg)
    except FrameTooLargeError as e:
        serialization.report_dropped_frame("scheduler send", e)
        return []


def _decode(data: bytes, where: str):
    """One received frame's message, or None for a frame that does not decode
    (reported; the frame was read whole, so the stream stays aligned)."""
    try:
        return serialization.loads(data)
    except WireDecodeError as e:
        serialization.report_dropped_frame(where, e)
        return None


class _ConnSender:
    """Shared locked-send over a multiprocessing connection."""

    def __init__(self, conn):
        self.conn = conn
        self._send_lock = threading.Lock()

    def send(self, msg) -> bool:
        if failpoints.ENABLED:
            verdict = failpoints.inject_handle_send("sched.send")
            if verdict is not None:
                return verdict
        datas = _frames(msg)
        with self._send_lock:
            try:
                for data in datas:
                    self.conn.send_bytes(data)
                return True
            except (OSError, ValueError, BrokenPipeError):
                return False


class DaemonHandle(_ConnSender):
    """Control connection to a per-node daemon process (the raylet analogue,
    `src/ray/raylet/main.cc:78`): spawns workers on its machine,
    reports their exits, and serves shm-segment reads for object pulls."""

    def __init__(self, node_id: NodeID, conn):
        super().__init__(conn)
        self.node_id = node_id
        # OS pid from the registration info (None for legacy daemons): the
        # death hooks prune this process's metrics::/spans:: KV snapshots.
        self.pid = None


class DriverHandle(_ConnSender):
    """Connection from a driver process in client mode (`init(address=...)`).
    Quacks enough like a WorkerHandle for the shared `_req_*` handlers: it has
    `send`, a non-"busy" `state`, and a function cache."""

    def __init__(self, conn, pull_node_id: Optional[bytes]):
        super().__init__(conn)
        self.state = "driver"
        self.node_id: Optional[NodeID] = None
        self.current_task: Optional[TaskID] = None
        self.known_functions: set = set()
        # Pseudo-node id under which this driver's shm segments are published;
        # pulls for it route back over this connection.
        self.pull_node_id = pull_node_id
        # Identity under which this driver's ObjectRefs are counted.
        self.holder_id = "driver-" + os.urandom(4).hex()
        # OS pid from the attach info (None for legacy drivers): death-time
        # pruning of this process's metrics::/spans:: KV snapshots + series.
        self.pid = None
        # Job id minted for this driver at attach (hex; None until then).
        # Everything the driver creates embeds it via the id scheme.
        self.job_id: Optional[str] = None


@dataclass
class WorkerHandle:
    worker_id: WorkerID
    node_id: NodeID
    process: Any
    conn: Any = None  # attached when the worker connects back
    state: str = "idle"  # idle | busy | blocked
    current_task: Optional[TaskID] = None
    actor_id: Optional[ActorID] = None
    # Hash of the worker's provisioned runtime env; idle reuse is per-hash
    # (reference: dedicated workers for runtime envs, worker_pool.h:609).
    env_hash: str = ""
    known_functions: set = field(default_factory=set)
    send_lock: threading.Lock = field(default_factory=threading.Lock)
    outbox: List[bytes] = field(default_factory=list)
    started_at: float = field(default_factory=time.time)
    # Lease pipelining (stateless workers): the dispatch class this worker is
    # leased to and its FIFO of in-flight task ids — inflight_tasks[0] is the
    # task actually executing (and the one holding the acquired resources;
    # accounting transfers to the successor on completion).
    lease_key: Optional[tuple] = None
    inflight_tasks: List[TaskID] = field(default_factory=list)
    # Why this worker is blocked ("dep" | "throttle"); see _mark_blocked.
    blocked_kind: str = "dep"
    # Heartbeat channel: last beat received + detector verdict. For workers
    # the verdict is OBSERVATIONAL ("ALIVE"/"SUSPECT" — surfaced, counted,
    # never a kill signal; a GIL-bound compile must not get its worker shot).
    last_heartbeat: float = field(default_factory=time.time)
    health: str = "ALIVE"
    # Real OS pid from the worker's ("register", id, pid) hello. process.pid
    # is -1 for daemon-managed workers (_RemoteProc), so death-time pruning
    # of metrics::<pid>/spans::<pid> must use THIS, not the process surface.
    os_pid: Optional[int] = None
    # Flight-recorder stack dump auto-captured at the ALIVE -> SUSPECT
    # transition (or {"dump": {"transport": "unavailable", ...}} when the
    # process couldn't answer) — surfaced on the node's worker entries in
    # get_nodes so a postmortem doesn't start with log spelunking.
    flight_recorder: Optional[dict] = None

    def send(self, msg) -> bool:
        if failpoints.ENABLED:
            verdict = failpoints.inject_handle_send("sched.send")
            if verdict is not None:
                return verdict
        datas = _frames(msg)
        with self.send_lock:
            if self.conn is None:
                # Worker still starting up: queue until it connects back.
                self.outbox.extend(datas)
                return True
            try:
                for data in datas:
                    self.conn.send_bytes(data)
                return True
            except (OSError, ValueError, BrokenPipeError):
                return False

    def attach(self, conn) -> bool:
        with self.send_lock:
            self.conn = conn
            try:
                for data in self.outbox:
                    conn.send_bytes(data)
            except (OSError, ValueError, BrokenPipeError):
                return False
            self.outbox.clear()
        return True


@dataclass
class NodeState:
    """A (possibly virtual) node: resource spec + worker pool. `cluster_utils.Cluster`
    registers several of these to emulate multi-node on one machine, the analogue of
    the reference's in-process multi-raylet `Cluster` fixture
    (`python/ray/cluster_utils.py:99`)."""

    node_id: NodeID
    resources: Dict[str, float]
    available: Dict[str, float]
    shm_dir: str
    labels: Dict[str, str] = field(default_factory=dict)
    workers: Dict[WorkerID, WorkerHandle] = field(default_factory=dict)
    idle: List[WorkerID] = field(default_factory=list)
    alive: bool = True
    # Set for nodes backed by a separate daemon process; None for the head's
    # in-process node and virtual test nodes.
    daemon: Optional[DaemonHandle] = None
    # "host:port" of the daemon's data server: readers pull segments straight
    # from the owning node instead of relaying through the head.
    data_address: Optional[str] = None
    # Last time work was dispatched here (autoscaler idle detection).
    last_active: float = field(default_factory=time.time)
    # Heartbeat channel (daemon-backed nodes only): last beat received and
    # the detector verdict ALIVE -> SUSPECT (one period silent) -> DEAD
    # (period * threshold silent => node removed, tasks fail over).
    last_heartbeat: float = field(default_factory=time.time)
    health: str = "ALIVE"
    # Stack dump auto-captured when the daemon went SUSPECT (see
    # WorkerHandle.flight_recorder); carried into the node's postmortem
    # entry if it is later declared DEAD.
    flight_recorder: Optional[dict] = None
    # GPU device ids of this node -> the share of each that actors hold. The
    # ids are what an actor that holds `GPU: n` finds in its
    # CUDA_VISIBLE_DEVICES; empty means ids 0..GPU-1.
    gpu_load: Dict[str, float] = field(default_factory=dict)

    def __post_init__(self):
        if not self.gpu_load:
            self.gpu_load = {str(i): 0.0 for i in range(int(self.resources.get("GPU", 0)))}

    def can_assign_gpu_ids(self, amount: float) -> bool:
        """Whether ids are free for a holder of `amount` GPUs. Accounting can
        admit a whole GPU while fractions hold a share of every id."""
        if amount >= 1:
            return sum(load == 0.0 for load in self.gpu_load.values()) >= math.ceil(amount)
        return any(load + amount <= 1.0 for load in self.gpu_load.values())

    def assign_gpu_ids(self, amount: float) -> List[str]:
        """Take device ids for a holder of `amount` GPUs: whole GPUs take as
        many free ids, a fraction packs onto the fullest id with room, so
        whole ids stay free (the reference's GPU resource allocator, best
        fit). The caller has checked can_assign_gpu_ids."""
        if amount >= 1:
            free = [i for i, load in self.gpu_load.items() if load == 0.0]
            ids = free[: math.ceil(amount)]
            for i in ids:
                self.gpu_load[i] = 1.0
            return ids
        room = [i for i, load in self.gpu_load.items() if load + amount <= 1.0]
        ids = sorted(room, key=lambda i: -self.gpu_load[i])[:1]
        for i in ids:
            self.gpu_load[i] += amount
        return ids

    def return_gpu_ids(self, ids: List[str], amount: float) -> None:
        share = 1.0 if amount >= 1 else amount
        for i in ids:
            if i in self.gpu_load:
                self.gpu_load[i] = max(self.gpu_load[i] - share, 0.0)

    def utilization(self) -> float:
        """Critical-resource utilization: the max used-fraction over resource
        kinds (reference: hybrid_scheduling_policy.cc scores nodes the same
        way). Summing kinds instead would let a huge mostly-idle denominator
        (memory bytes) mask full CPU saturation."""
        worst = 0.0
        for k, total in self.resources.items():
            if total <= 0:
                continue
            used = total - max(self.available.get(k, 0.0), 0.0)
            worst = max(worst, used / total)
        return worst


@dataclass
class TaskRecord:
    spec: TaskSpec
    # Each arg entry: ("id", bytes) for an ObjectRef dep | ("meta", ObjectMeta).
    arg_entries: List[Tuple[str, Any]]
    kwarg_entries: Dict[str, Tuple[str, Any]]
    return_ids: List[ObjectID]
    func_blob: Optional[bytes]
    retries_left: int = 0
    state: str = "PENDING"
    worker: Optional[WorkerID] = None
    node: Optional[NodeID] = None
    acquired: Dict[str, float] = field(default_factory=dict)
    acquired_pg: Optional[Tuple[PlacementGroupID, int]] = None
    unresolved: int = 0
    submitted_at: float = field(default_factory=time.time)
    # Object-lifecycle bookkeeping: dependency ids pinned for the task's
    # lifetime, released exactly once when it reaches a terminal state.
    dep_ids: List[bytes] = field(default_factory=list)
    pins_released: bool = False
    # Generator tasks (spec.returns_mode set): items sealed so far, parked
    # stream_next callers, final item count (set at terminal state), the
    # holder string of the consumer (interim "gen:<task>" holders are swept
    # when this holder's process dies), and whether the consumer released the
    # stream early.
    stream_metas: List[ObjectMeta] = field(default_factory=list)
    stream_waiters: List[Tuple[int, concurrent.futures.Future]] = field(default_factory=list)
    stream_total: Optional[int] = None
    stream_owner: Optional[str] = None
    stream_released: bool = False
    # Generator backpressure: highest item index the consumer has asked for,
    # and producers parked until the consumer catches up (threshold, respond).
    stream_requested: int = -1
    throttle_waiters: List[Tuple[int, Callable]] = field(default_factory=list)
    # Cached dispatch-class key (see _PendingQueue): tasks with equal keys
    # have identical feasibility, so one failed dispatch parks the class.
    dispatch_key: Optional[tuple] = None
    # Memory-monitor bookkeeping: when this task started running, the holder
    # that submitted it (group-by-owner policy), and whether its worker was
    # OOM-killed (error type selection on death).
    running_since: float = 0.0
    owner: str = ""
    oom_killed: bool = False
    oom_detail: str = ""  # human context, e.g. " (node at 97% of 4096MB)"
    # Per-stage lifecycle timestamps (submit lives on spec.submitted_ts;
    # queued/lease_granted stamp here scheduler-side; args_fetched/exec_start/
    # exec_end/result_stored merge in from the worker's done message).
    stage_ts: Dict[str, float] = field(default_factory=dict)


def fast_task_record(
    spec: TaskSpec,
    arg_entries,
    kwarg_entries,
    return_ids,
    func_blob,
    retries_left: int = 0,
    dispatch_key: Optional[tuple] = None,
) -> TaskRecord:
    """Hot-path TaskRecord construction: one dict.update instead of the
    dataclass __init__'s ~28 field assignments + default factories. Used by
    the `.remote()` submission path, where record construction is a
    measurable slice of the per-task budget. `_FAST_RECORD_FIELDS` below
    asserts this stays in sync with the dataclass definition."""
    rec = TaskRecord.__new__(TaskRecord)
    rec.__dict__.update(
        spec=spec,
        arg_entries=arg_entries,
        kwarg_entries=kwarg_entries,
        return_ids=return_ids,
        func_blob=func_blob,
        retries_left=retries_left,
        state="PENDING",
        worker=None,
        node=None,
        acquired={},
        acquired_pg=None,
        unresolved=0,
        submitted_at=spec.submitted_ts,
        dep_ids=[],
        pins_released=False,
        stream_metas=[],
        stream_waiters=[],
        stream_total=None,
        stream_owner=None,
        stream_released=False,
        stream_requested=-1,
        throttle_waiters=[],
        dispatch_key=dispatch_key,
        running_since=0.0,
        owner="",
        oom_killed=False,
        oom_detail="",
        stage_ts={},
    )
    return rec


# Guard: fast_task_record bypasses the dataclass __init__, so a field added
# to TaskRecord without updating it would surface as a late AttributeError
# deep in the scheduler. Fail at import instead.
_FAST_RECORD_FIELDS = set(
    fast_task_record(
        TaskSpec(task_id=None, func=FunctionDescriptor("", "")), [], {}, [], None
    ).__dict__
)
assert _FAST_RECORD_FIELDS == {f.name for f in TaskRecord.__dataclass_fields__.values()}, (
    "fast_task_record is out of sync with the TaskRecord dataclass: "
    f"{_FAST_RECORD_FIELDS ^ {f.name for f in TaskRecord.__dataclass_fields__.values()}}"
)


class _PendingQueue:
    """Pending tasks indexed by dispatch class.

    A burst of N same-shaped submissions must not cost O(N) dispatch attempts
    per scheduler wakeup (the reference queues ~1M tasks/node,
    `release/benchmarks/README.md:30`; its ClusterTaskManager keys queues by
    scheduling class, `common/task/task_spec.h SchedulingClass`). Records
    whose (resources, strategy, runtime-env, PG) tuple matches are one class:
    per wakeup each class is drained head-first until its first
    resource-failure, so cost is O(classes + dispatched) instead of
    O(pending).

    Dependency-unresolved records are parked OUT of the class queues (the
    object-ready callback re-queues them), so an unresolved head never blocks
    the rest of its class.
    """

    def __init__(self):
        from collections import OrderedDict, deque

        self._deque = deque
        self._by_class: "OrderedDict[tuple, Any]" = OrderedDict()
        self._parked: Dict[int, TaskRecord] = {}

    @staticmethod
    def key_of(rec: TaskRecord) -> tuple:
        if rec.dispatch_key is None:
            from ray_tpu_torch._private.runtime_env import env_hash

            spec = rec.spec
            strategy = spec.scheduling_strategy
            if isinstance(strategy, str) or strategy is None:
                strat_key = strategy
            else:
                strat_key = (
                    getattr(strategy, "node_id", None),
                    getattr(strategy, "soft", None),
                )
            rec.dispatch_key = (
                spec.is_actor_creation,
                frozenset(spec.resources.items()),
                spec.placement_group_id,
                spec.placement_group_bundle_index,
                env_hash(spec.runtime_env),
                strat_key,
            )
        return rec.dispatch_key

    def push(self, rec: TaskRecord, front: bool = False) -> None:
        key = self.key_of(rec)
        q = self._by_class.get(key)
        if q is None:
            q = self._by_class[key] = self._deque()
        if front:
            q.appendleft(rec)
        else:
            q.append(rec)

    def park(self, rec: TaskRecord) -> None:
        """Hold a dependency-unresolved record outside the class queues."""
        self._parked[id(rec)] = rec

    def unpark(self, rec: TaskRecord) -> bool:
        return self._parked.pop(id(rec), None) is not None

    def classes(self) -> List[tuple]:
        return list(self._by_class.keys())

    def head(self, key: tuple) -> Optional[TaskRecord]:
        q = self._by_class.get(key)
        return q[0] if q else None

    def pop_head(self, key: tuple) -> Optional[TaskRecord]:
        q = self._by_class.get(key)
        if not q:
            self._by_class.pop(key, None)
            return None
        rec = q.popleft()
        if not q:
            del self._by_class[key]
        return rec

    def remove(self, rec: TaskRecord) -> bool:
        if self.unpark(rec):
            return True
        key = self.key_of(rec)
        q = self._by_class.get(key)
        if q is None:
            return False
        try:
            q.remove(rec)
        except ValueError:
            return False
        if not q:
            del self._by_class[key]
        return True

    def records(self) -> List[TaskRecord]:
        out = [r for q in self._by_class.values() for r in q]
        out.extend(self._parked.values())
        return out

    def __contains__(self, rec: TaskRecord) -> bool:
        if id(rec) in self._parked:
            return True
        q = self._by_class.get(self.key_of(rec))
        return bool(q) and rec in q

    def __len__(self) -> int:
        return sum(len(q) for q in self._by_class.values()) + len(self._parked)

    def __bool__(self) -> bool:
        return bool(self._by_class) or bool(self._parked)


@dataclass
class ActorRecord:
    actor_id: ActorID
    creation_req: ExecRequest
    resources: Dict[str, float]
    worker: Optional[WorkerID] = None
    node: Optional[NodeID] = None
    state: str = "PENDING"  # PENDING -> ALIVE -> RESTARTING -> DEAD
    max_restarts: int = 0
    num_restarts: int = 0
    # lifetime="detached": survives its creator, persists under head
    # --persist, dies only via kill_actor (reference:
    # `gcs_actor_manager.h:281` ownership rules).
    detached: bool = False
    # Holder id of the creating driver/worker for owned (non-detached)
    # actors: its death kills the actor.
    owner_holder: Optional[str] = None
    # In-flight call ids, insertion-ordered. A dict (used as an ordered set):
    # a burst enqueues thousands of calls on one actor, and the list version
    # made each completion's membership-check + removal O(inflight) —
    # O(n^2) per burst on the scheduler thread.
    inflight: Dict[TaskID, None] = field(default_factory=dict)
    # Method calls queued while the actor is PENDING/RESTARTING.
    backlog: List[ExecRequest] = field(default_factory=list)
    acquired_pg: Optional[Tuple[PlacementGroupID, int]] = None
    acquired: Dict[str, float] = field(default_factory=dict)
    # GPU device ids given to the actor's worker (CUDA_VISIBLE_DEVICES),
    # returned to its node with its resources.
    gpu_ids: List[str] = field(default_factory=list)
    death_cause: Optional[str] = None


@dataclass
class Bundle:
    index: int
    resources: Dict[str, float]
    node: Optional[NodeID] = None
    available: Dict[str, float] = field(default_factory=dict)


@dataclass
class PGRecord:
    pg_id: PlacementGroupID
    bundles: List[Bundle]
    strategy: str
    state: str = "PENDING"
    ready_futures: List[concurrent.futures.Future] = field(default_factory=list)
    name: str = ""
    # GPU_SLICE: the NVLink domain the gang was placed in, None when it was
    # placed by the STRICT_SPREAD fallback (or not yet placed).
    domain: Optional[str] = None


def _fits(avail: Dict[str, float], req: Dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) + 1e-9 >= v for k, v in req.items())


def _acquire(avail: Dict[str, float], req: Dict[str, float]) -> None:
    for k, v in req.items():
        avail[k] = avail.get(k, 0.0) - v


class _Introspection:
    """One in-flight cluster introspection fan-out (stack dump or profile
    collect). Loop-thread-owned: created by a _cmd/_req handler, filled by
    stacks_data/profile_data replies, finished by the reply that empties
    `pending` or by the loop's deadline tick (which, for stack dumps, first
    escalates silent workers to the out-of-band SIGUSR1 path)."""

    __slots__ = ("kind", "results", "pending", "respond", "deadline",
                 "oob_fired")

    def __init__(self, kind: str, respond: Callable[[dict], None],
                 deadline: float):
        self.kind = kind            # "stacks" | "profile"
        self.results: Dict[str, Any] = {}
        # key -> ("worker", WorkerHandle) | ("daemon", DaemonHandle): what is
        # still owed a reply, with enough context to escalate out-of-band.
        self.pending: Dict[str, tuple] = {}
        self.respond = respond
        self.deadline = deadline
        self.oob_fired = False


def _release(avail: Dict[str, float], req: Dict[str, float]) -> None:
    for k, v in req.items():
        avail[k] = avail.get(k, 0.0) + v


class Scheduler:
    def __init__(
        self,
        gcs: GCS,
        config: Config,
        session_dir: str,
        tcp_port: int = 0,
        advertise_host: str = "127.0.0.1",
        bind_host: Optional[str] = None,
        virtual: bool = False,
    ):
        # virtual=True builds the full in-memory control plane but binds NO
        # external resources (no unix/TCP listeners, no data-plane push
        # server) and is never start()ed: rt-state's interleaving explorer
        # (devtools/verify/explore.py) drives the real handlers
        # single-threaded against fake connections instead.
        self.virtual = virtual
        self.gcs = gcs
        self.config = config
        self.session_dir = session_dir
        # Task-event ring capacity comes from config, not the GCS default.
        gcs.set_task_event_cap(config.task_events_max_num_task_in_gcs)
        # Trace-span ring bound (util/tracing.py flushers append here).
        gcs.set_trace_span_cap(config.trace_spans_cap)
        # Internal runtime metrics: hot paths bump plain ints on this object;
        # gauges/histograms materialize once per loop tick (telemetry.py).
        from ray_tpu_torch._private.telemetry import SchedulerTelemetry

        self.telemetry = SchedulerTelemetry(config)
        # Watch-it-over-time layer (timeseries.py): the head-side series
        # store + alert engine, fed by the metrics:: KV flushes the _cmd_kv
        # handler already sees. None when metrics are off — the knob-off
        # contract is that NOTHING observability-shaped exists.
        self.obs = None
        # Per-job accounting (jobs.py): tenant ledger keyed by the job id
        # embedded in every ActorID/TaskID/ObjectID. Exists exactly when the
        # obs layer does — same knob-off contract. Identity MINTING is
        # unconditional (ids are structural); only the metering is gated.
        self.jobs = None
        # Next job id to mint; job 1 is the in-process driver (the id every
        # worker and legacy client also defaults to).
        self._job_counter = 1
        if config.enable_metrics and config.enable_obs:
            from ray_tpu_torch._private.timeseries import ObsState
            from ray_tpu_torch._private.jobs import JobLedger

            self.obs = ObsState(config, gcs)
            self.jobs = JobLedger(config, gcs)
            gcs.set_finished_job_cap(config.finished_jobs_cap)
            # Serve request attribution rides the snapshot parse ingest_kv
            # already pays for.
            self.obs.snapshot_hook = self.jobs.ingest_snapshot
            self.jobs.register_job(
                JobID.from_int(1).hex(), self._INPROC_DRIVER, "inproc"
            )
            self._emit_event(
                "job_started",
                f"job {JobID.from_int(1).hex()} started (in-process driver)",
                job=JobID.from_int(1).hex(), source_kind="inproc",
            )
        self.nodes: Dict[NodeID, NodeState] = {}
        self.node_order: List[NodeID] = []
        self.object_table: Dict[bytes, ObjectMeta] = {}
        self.object_waiters: Dict[bytes, List[Callable[[ObjectMeta], None]]] = {}
        self.tasks: Dict[TaskID, TaskRecord] = {}
        self.pending = _PendingQueue()
        self.actors: Dict[ActorID, ActorRecord] = {}
        self.pgs: Dict[PlacementGroupID, PGRecord] = {}
        self.pending_pgs: List[PGRecord] = []
        self._commands: "queue.SimpleQueue" = queue.SimpleQueue()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        # Urgent wake channel: blocking call()s signal here. During burst
        # coalescing the loop stops watching the NORMAL wake fd (submit
        # wakes accumulate silently), but stays responsive to this one — a
        # get/wait must never pay the coalesce budget.
        self._urgent_r, self._urgent_w = socket.socketpair()
        self._urgent_r.setblocking(False)
        self._urgent_pending = False
        # True while a wake byte is undrained: submit bursts send one wake
        # syscall, not one per task. _wake_lock couples the flag to the byte
        # state — set+send and drain+clear are each atomic, so the flag can
        # never be True with no byte in flight (which would strand commands
        # until the loop's poll timeout).
        self._wake_pending = False
        self._wake_lock = threading.Lock()
        # Burst coalescing (scheduler_burst_coalesce_ms): fire-and-forget
        # command streams defer the drain while hot; any blocking call()
        # cancels. _blocking_pending counts queued fut-carrying commands
        # (mutated under _wake_lock from API threads, decremented by the
        # loop); _last_cmd_enqueue timestamps the newest nowait command.
        self._blocking_pending = 0
        # In-process driver threads parked on the OwnershipTable (their get()
        # never enters the command queue): counted here so burst coalescing
        # yields to them exactly like a blocking call().
        self._owner_waiters = 0
        self._last_cmd_enqueue = 0.0
        self._burst_defer_start: Optional[float] = None
        self._burst_coalesce_s = max(
            0.0, float(config.scheduler_burst_coalesce_ms) / 1000.0
        )
        # A command stream counts as "hot" while enqueues arrive closer
        # together than this (~500/s); sparse traffic processes immediately.
        # Loose on purpose: a GC pause or an unrelated conn wake mid-burst
        # must not read as "stream ended" and trigger a full drain inside
        # the burst (blocking calls cancel deferral regardless, so the only
        # cost of the loose window is added dispatch latency for sparse
        # PURE fire-and-forget traffic, bounded by the coalesce budget).
        self._burst_hot_s = 0.002
        # Outbound control-plane micro-batching (batching.py): while the loop
        # thread is inside an iteration, messages to workers/drivers/daemons
        # coalesce per connection into ("batch", [msgs]) frames, flushed on a
        # count/byte threshold and unconditionally before the loop sleeps.
        # None = batching disabled (every _send_to is a direct send).
        self._out_buffer: Optional[Dict[int, List[Any]]] = (
            {} if config.control_plane_batching else None
        )
        self._loop_tid: Optional[int] = None
        self._batch_max_msgs = max(1, int(config.control_plane_batch_max_msgs))
        self._batch_max_bytes = int(config.control_plane_batch_max_bytes)
        # dispatch-class key -> leased workers (kept in sync by dispatch /
        # idle / death transitions): O(1) pipeline-candidate lookup.
        self._leases: Dict[tuple, List[WorkerHandle]] = {}
        self._last_memory_check = 0.0
        self._last_hb_check = 0.0
        # Serve ingress service directory: proxy_id -> {node_id, port, pid,
        # worker_id} for every announced HTTP proxy (serve_proxy_up/down;
        # pruned on worker death). The head answers *discovery* queries only —
        # request bytes flow client -> proxy -> replica, never through here.
        self._serve_proxies: Dict[str, dict] = {}
        # Pending graceful drains: token -> (reply_to, deadline, target_hex).
        # reply_to is ("conn", wh, req_id) or ("future", fut); resolved by the
        # serve_drained reply, the target worker's death (drained by
        # definition), or the deadline sweep.
        self._serve_drains: Dict[int, tuple] = {}
        self._serve_drain_tokens = itertools.count(1)
        # (when, rec) pairs re-queued after a delay (OOM retry backoff).
        self._delayed_retries: List[Tuple[float, TaskRecord]] = []
        # Pubsub plane (reference: src/ray/pubsub/publisher.h — long-poll
        # channels for logs/errors/locations; here channels push over the
        # persistent driver conns): channel -> remote holder ids, and
        # channel -> in-process callbacks (the in-proc driver's path).
        self._subscriptions: Dict[str, set] = {}
        self._inproc_subs: Dict[str, List[Callable]] = {}
        self._conn_to_worker: Dict[Any, WorkerHandle] = {}
        self._conn_to_daemon: Dict[Any, DaemonHandle] = {}
        self._conn_to_driver: Dict[Any, DriverHandle] = {}
        # Persistent readiness watcher for the loop: connections register
        # once at attach and unregister at death, instead of the loop
        # rebuilding + re-registering every fd per iteration (mpc.wait was
        # ~25% of loop samples under task load). Loop-thread only.
        import selectors as _selectors

        self._selectors_mod = _selectors
        self._selector = _selectors.DefaultSelector()
        self._workers_by_id: Dict[str, WorkerHandle] = {}
        # Ownership decentralization (_private/ownership.py): sealed metas
        # forward to the owner process so its table answers gets in-process.
        # The in-process driver's table gets a direct call (set by init());
        # remote owners resolve holder id -> connection here.
        self.inproc_meta_sink: Optional[Callable[[ObjectMeta], None]] = None
        self._holder_to_driver: Dict[str, DriverHandle] = {}
        # Holder ids (drivers + workers) that died: lineage reconstruction of
        # their objects refuses to re-execute (owner-survives-only rule), and
        # their non-terminal tasks were sealed with OwnerDiedError.
        self._dead_holders: set = set()
        # Object-pull plumbing (relay FALLBACK; the peer-direct data plane in
        # object_transfer.py carries most bytes): node_id bytes -> connection
        # that can read that node's segments; outstanding reads keyed by
        # token, with concurrent relay pulls of one key coalesced into a
        # single read (waiters pile onto _relay_waiters[key]).
        self._pull_sources: Dict[bytes, _ConnSender] = {}
        self._pending_pulls: Dict[int, Tuple[bytes, ObjectMeta]] = {}
        self._relay_waiters: Dict[bytes, List[Callable[[bool, Any], None]]] = {}
        self._pull_token = 0
        # Location directory for the data plane: nodes holding a CACHED copy
        # of a sealed object beside its owner (registered by pullers after a
        # successful transfer; purged with the object / the node).
        self.object_replicas: Dict[bytes, set] = {}
        # Cumulative data-plane counters (never reset; transfer_stats() and
        # the telemetry tick both read them): relay traffic the peer-direct
        # plane is supposed to eliminate, plus locality-placement outcomes.
        self._transfer_stats = {
            "relay_pulls": 0, "relay_bytes": 0, "local_reads": 0,
            "locality_hits": 0, "locality_misses": 0,
        }
        # Object lifecycle (reference: ownership refcounting in
        # `core_worker/reference_count.h:59`, plasma capacity/eviction in
        # `object_manager/plasma/eviction_policy.h`, lineage reconstruction in
        # `core_worker/object_recovery_manager.h:41`):
        #  holders: processes (driver/worker ids) holding live ObjectRefs
        #  pins: task-dependency + containment counts
        #  contained_pins: object -> child ids it pins while alive
        #  node_usage: bytes of sealed segments per node (capacity accounting)
        self.holders: Dict[bytes, set] = {}
        self.pins: Dict[bytes, int] = {}
        self.contained_pins: Dict[bytes, List[bytes]] = {}
        self.node_usage: Dict[NodeID, int] = {}
        # How many RETAINED task records list each object id among their deps
        # (lineage chains: reconstructing a record's output re-executes it,
        # which needs its arg objects — whose own records must survive).
        self.lineage_consumers: Dict[bytes, int] = {}
        # Bounded summaries of lineage-GC'd records so the state/dashboard
        # task listing still shows completed history (the reference keeps a
        # separate bounded GcsTaskManager store for the same reason).
        from collections import deque

        self._gc_task_summaries: "deque" = deque(maxlen=1000)
        self._reconstructing: Dict[bytes, List[Callable[[bool, Any], None]]] = {}
        # Live-introspection fan-outs (stack dumps / profile collects):
        # reply token -> (collection, target key), plus the collections the
        # loop's deadline tick watches. Empty (and therefore free) unless an
        # introspection call is actually in flight.
        self._introspect_token = 0
        self._introspect_pending: Dict[int, Tuple[_Introspection, str]] = {}
        self._introspections: List[_Introspection] = []
        # Bounded postmortems for heartbeat-DEAD daemon nodes: node entry +
        # the flight-recorder dump captured at SUSPECT time, queryable via
        # get_nodes(include_postmortems) after the node itself is gone.
        self._node_postmortems: "deque" = deque(maxlen=16)
        # Local worker processes killed before shutdown and maybe still
        # exiting (a CUDA worker takes a while to release its context):
        # shutdown waits for them, so no process of the session outlives it.
        self._exiting: List[_Proc] = []
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._acceptors: List[threading.Thread] = []
        self._rr_counter = 0
        env_key = os.environ.get("RAY_TPU_TORCH_AUTHKEY_HEX")
        self._authkey = bytes.fromhex(env_key) if env_key else os.urandom(16)
        self._sock_path = os.path.join(session_dir, "worker.sock")
        if virtual:
            self._listener = None
            self._tcp_listener = None
            self.tcp_address = (advertise_host, 0)
            self._transfer = None
            self._data_address = None
            return
        from multiprocessing.connection import Listener

        # backlog: multiprocessing's default is 1 — a gang of concurrently
        # spawned workers overflows the accept queue, the kernel silently
        # drops the excess connections, and each dropped worker blocks
        # FOREVER in its auth-challenge recv (no hello ever reaches the
        # acceptor, so its lease hangs with the exec parked in the outbox).
        self._listener = Listener(
            self._sock_path, family="AF_UNIX", backlog=128,
            authkey=self._authkey,
        )
        # TCP listener: node daemons, remote workers, and client-mode drivers
        # dial this (the analogue of the reference's gRPC ports). Bound to the
        # advertise host (loopback by default) so a plain single-machine
        # `init()` never exposes a network port; multi-host heads pass their
        # reachable interface explicitly.
        self._tcp_listener = Listener(
            (bind_host if bind_host is not None else advertise_host, tcp_port),
            family="AF_INET",
            backlog=128,  # see the unix listener's backlog note
            authkey=self._authkey,
        )
        self.tcp_address = (advertise_host, self._tcp_listener.address[1])
        # The head's own half of the data plane: a push server over the head
        # store dir (head-held objects stream to readers WITHOUT crossing the
        # scheduler loop or control sockets) plus the coalescing local-read
        # pool behind the relay fallback. Virtual nodes share the head's shm
        # dir, so one server covers them all.
        from ray_tpu_torch._private.object_transfer import ObjectTransferManager

        self._transfer = ObjectTransferManager(
            os.path.join(session_dir, "shm"), cfg=config, authkey=self._authkey
        )
        try:
            self._data_address = self._transfer.start_push_server(advertise_host)
        except OSError:
            self._data_address = None

    @property
    def authkey(self) -> bytes:
        return self._authkey

    # ------------------------------------------------------------------ lifecycle
    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True, name="scheduler")
        self._thread.start()
        for name, listener in (("acceptor-unix", self._listener), ("acceptor-tcp", self._tcp_listener)):
            t = threading.Thread(target=self._accept_loop, args=(listener,), daemon=True, name=name)
            t.start()
            self._acceptors.append(t)

    def _accept_loop(self, listener):
        """Accept connect-backs. The first message identifies the peer:
        ("worker", worker_id_hex) | ("daemon", info) | ("driver", info)."""
        while not self._stopped.is_set():
            try:
                conn = listener.accept()
                hello = serialization.loads(conn.recv_bytes())
            except (OSError, EOFError, Exception):
                if self._stopped.is_set():
                    return
                continue
            # Req/resp roundtrips on TCP control connections otherwise stall
            # on Nagle + delayed-ACK (~40ms per small frame after idle).
            from ray_tpu_torch._private.object_transfer import set_nodelay

            set_nodelay(conn)
            kind = hello[0]
            if kind == "worker":
                self.call("attach_worker", (hello[1], conn))
            elif kind == "daemon":
                self.call("attach_daemon", (hello[1], conn))
            elif kind == "driver":
                self.call("attach_driver", (hello[1], conn))
            else:
                try:
                    conn.close()
                except OSError:
                    pass

    def _cmd_attach_worker(self, payload):
        worker_id_hex, conn = payload
        wh = self._workers_by_id.get(worker_id_hex)
        if wh is None:
            try:
                conn.close()
            except OSError:
                pass
            return False
        if not wh.attach(conn):
            self._on_worker_death(wh)
            return False
        self._conn_to_worker[conn] = wh
        self._watch_conn(conn)
        self._emit_event(
            "worker_started",
            f"worker {worker_id_hex[:8]} (pid "
            f"{getattr(wh.process, 'pid', None)}) connected",
            worker_id=worker_id_hex, node_id=wh.node_id.hex(),
        )
        return True

    def _cmd_attach_daemon(self, payload):
        """A node daemon registered: create a real node backed by it (the seam
        the reference crosses in `services.py:1346` when a raylet starts)."""
        info, conn = payload
        node_id = NodeID.from_random()
        resources = dict(info["resources"])
        node = NodeState(
            node_id=node_id,
            resources=resources,
            available=dict(resources),
            shm_dir=info["shm_dir"],
            labels=dict(info.get("labels") or {}),
            data_address=info.get("data_address"),
            # The ids the daemon's own CUDA_VISIBLE_DEVICES names (empty:
            # 0..GPU-1, as for a virtual node).
            gpu_load={str(i): 0.0 for i in info.get("gpu_ids") or ()},
        )
        daemon = DaemonHandle(node_id, conn)
        # Daemon's OS pid (registration info): worker/daemon metrics flush
        # under `metrics::<pid>`, and the death hooks prune by that key.
        daemon.pid = info.get("pid")
        node.daemon = daemon
        self.nodes[node_id] = node
        self.node_order.append(node_id)
        self._conn_to_daemon[conn] = daemon
        self._watch_conn(conn)
        self._pull_sources[node_id.binary()] = daemon
        self._emit_event(
            "node_added",
            f"node {node_id.hex()[:8]} joined with "
            f"{resources.get('CPU', 0):g} CPU / {resources.get('GPU', 0):g} GPU",
            node_id=node_id.hex(), resources=dict(resources),
        )
        daemon.send(
            (
                "ok",
                node_id.hex(),
                {
                    "memory_usage_threshold": self.config.memory_usage_threshold,
                    "memory_monitor_refresh_ms": self.config.memory_monitor_refresh_ms,
                    # Daemons beat at the head's configured cadence — this
                    # process never saw the driver's _system_config.
                    "health_check_period_ms": self.config.health_check_period_ms,
                },
            )
        )
        return node_id

    def _cmd_attach_driver(self, payload):
        info, conn = payload
        pull_hex = info.get("pull_node_id")
        dh = DriverHandle(conn, bytes.fromhex(pull_hex) if pull_hex else None)
        dh.pid = info.get("pid")
        self._conn_to_driver[conn] = dh
        self._watch_conn(conn)
        self._holder_to_driver[dh.holder_id] = dh
        if dh.pull_node_id:
            self._pull_sources[dh.pull_node_id] = dh
        # Trusted mint: each attaching driver gets the next job id; every
        # TaskID/ActorID/ObjectID it creates embeds it (ids.py), so all of
        # its usage is attributable with no per-message tags. Minting is
        # identity, not observability — it happens even when the ledger is
        # off (the id must be stable if obs is flipped on later via restart).
        self._job_counter += 1
        job = JobID.from_int(self._job_counter)
        dh.job_id = job.hex()
        if self.jobs is not None:
            self.jobs.register_job(dh.job_id, dh.holder_id, "client")
        self._emit_event(
            "job_started",
            f"job {dh.job_id} started (client driver {dh.holder_id})",
            job=dh.job_id, driver=dh.holder_id, source_kind="client",
        )
        head = self.nodes.get(self.node_order[0]) if self.node_order else None
        dh.send(
            (
                "ok",
                {
                    "session_dir": self.session_dir,
                    "shm_dir": head.shm_dir if head else os.path.join(self.session_dir, "shm"),
                    "head_node_id": head.node_id.hex() if head else "",
                    "config": self.config,
                    "job_id": dh.job_id,
                },
            )
        )
        return True

    @loop_thread_only
    def _on_daemon_death(self, daemon: DaemonHandle):
        self._drop_outbound(daemon)
        self._conn_to_daemon.pop(daemon.conn, None)
        self._unwatch_conn(daemon.conn)
        self._pull_sources.pop(daemon.node_id.binary(), None)
        self._fail_pulls_from(daemon.node_id.binary())
        try:
            daemon.conn.close()
        except OSError:
            pass
        node = self.nodes.get(daemon.node_id)
        if node is not None:
            for wh in list(node.workers.values()):
                if isinstance(wh.process, _RemoteProc):
                    wh.process.mark_dead()
            self._cmd_remove_node(daemon.node_id)

    def _on_driver_death_cleanup_subs(self, dh: DriverHandle) -> None:
        for holders in self._subscriptions.values():
            holders.discard(dh.holder_id)

    @loop_thread_only
    def _on_driver_death(self, dh: DriverHandle):
        self._drop_outbound(dh)
        # A departed driver's frozen snapshots (e.g. its Serve-router p95
        # gauge) must not keep a gauge-based alert latched forever.
        self._prune_dead_process(dh.pid)
        self._conn_to_driver.pop(dh.conn, None)
        self._unwatch_conn(dh.conn)
        self._holder_to_driver.pop(dh.holder_id, None)
        self._dead_holders.add(dh.holder_id)
        self._on_driver_death_cleanup_subs(dh)
        if dh.pull_node_id:
            self._pull_sources.pop(dh.pull_node_id, None)
            self._fail_pulls_from(dh.pull_node_id)
        self._drop_holder_everywhere(dh.holder_id)
        self._fail_tasks_of_dead_owner(dh.holder_id)
        # Owned actors die with their creator; detached actors survive.
        self._kill_actors_owned_by(dh.holder_id)
        # Seal the tenant ledger AFTER the dead-owner sweeps above: they
        # close each task/actor accrual through the normal terminal hooks,
        # and finalize_job closes whatever those left open (e.g. a RUNNING
        # task allowed to finish) before the summary enters the ring.
        if self.jobs is not None:
            if dh.job_id is not None:
                summary = self.jobs.finalize_job(
                    dh.job_id, time.time(), "driver disconnected"
                )
                if summary is not None:
                    t = summary["totals"]
                    self._emit_event(
                        "job_finished",
                        f"job {dh.job_id} finished: "
                        f"{t['tasks']['finished']} tasks ok, "
                        f"{t['tasks']['failed']} failed, "
                        f"{t['cpu_seconds']:.1f} cpu-s",
                        job=dh.job_id, driver=dh.holder_id,
                        reason="driver disconnected",
                        totals=t,
                    )
        try:
            dh.conn.close()
        except OSError:
            pass

    def _fail_pulls_from(self, source_node_id: bytes):
        """Fail outstanding relay pulls whose source just died, so readers
        error out instead of hanging on a response that will never arrive."""
        for token, (key, meta) in list(self._pending_pulls.items()):
            if meta.node_id == source_node_id:
                del self._pending_pulls[token]
                if session_monitor.ENABLED:
                    session_monitor.forget("read_object", token)
                for respond in self._relay_waiters.pop(key, []):
                    respond(False, ConnectionError(
                        "object source node died during pull"))

    def stop(self):
        fut = self.call("_stop", None)
        try:
            fut.result(timeout=5)
        except Exception:
            pass
        self._stopped.set()
        if self.obs is not None:
            # Unhook the registry's local flush sink: a later cluster in this
            # process must not flush into this dead GCS/store.
            self.obs.close()
        self._transfer.close()
        for listener in (self._listener, self._tcp_listener):
            try:
                listener.close()
            except OSError:
                pass
        self._wake()
        self._wake_urgent()
        if self._thread:
            self._thread.join(timeout=5)
        # Close the loop's private fds (epoll + wake/urgent socketpairs):
        # test suites cycle hundreds of init/shutdown pairs in one process,
        # and leaked fds eventually push every new fd past select()'s
        # FD_SETSIZE for unrelated code.
        try:
            self._selector.close()
        except OSError:
            pass
        for sock in (self._wake_r, self._wake_w, self._urgent_r, self._urgent_w):
            try:
                sock.close()
            except OSError:
                pass
        # Spilled payloads live outside the session dir (possibly a
        # user-configured path): remove them with the session.
        import shutil

        shutil.rmtree(self._spill_dir, ignore_errors=True)

    @any_thread
    def call(self, method: str, payload: Any) -> concurrent.futures.Future:
        """Thread-safe entry for driver API threads. Fails fast once the
        scheduler has stopped — a caller blocked on .result() of a command no
        thread will ever process would hang forever (e.g. a background ref
        flusher racing shutdown)."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        if self._stopped.is_set():
            fut.set_exception(RuntimeError("scheduler is stopped"))
            return fut
        with self._wake_lock:
            self._blocking_pending += 1
        self._commands.put((method, payload, fut))
        self._wake()
        self._wake_urgent()
        # Re-check AFTER the put: if stop raced in between, the loop's final
        # drain may already have run and this command would sit unprocessed
        # forever. The drain and this check both guard with fut.done(), so at
        # most one of them settles the future.
        if self._stopped.is_set() and not fut.done():
            try:
                fut.set_exception(RuntimeError("scheduler is stopped"))
            except Exception:
                pass  # settled by the loop in the meantime
        return fut

    @any_thread
    def call_nowait(self, method: str, payload: Any) -> None:
        """Fire-and-forget command: enqueue and return without waiting for
        the loop to process it. Used by the hot submission path — pipelined
        `.remote()` bursts must not pay one loop-wakeup ack each. FIFO with
        `call()` commands, so a later blocking get/wait still observes every
        prior submission. Errors surface through the task's return refs (the
        command itself only registers the record)."""
        if self._stopped.is_set():
            raise RuntimeError("scheduler is stopped")
        self._last_cmd_enqueue = time.monotonic()
        self._commands.put((method, payload, None))
        self._wake()
        # Post-put stop-race check (mirrors call()): if the loop's final
        # drain already ran, this command would be dropped silently.
        if self._stopped.is_set():
            raise RuntimeError("scheduler is stopped")

    @any_thread
    def _wake(self):
        if self._wake_pending:
            return  # racy fast-path read; re-checked under the lock
        with self._wake_lock:
            if self._wake_pending:
                return
            self._wake_pending = True
            try:
                self._wake_w.send(b"x")
            except OSError:
                pass

    @any_thread
    def note_owner_wait(self, delta: int) -> None:
        """A driver thread is about to park on (or just left) its ownership
        table: burst coalescing must yield — the parked thread's results
        only arrive through this loop's dispatch/done processing."""
        with self._wake_lock:
            self._owner_waiters += delta
        if delta > 0:
            self._wake_urgent()

    @any_thread
    def _wake_urgent(self):
        if self._urgent_pending:
            return
        with self._wake_lock:
            if self._urgent_pending:
                return
            self._urgent_pending = True
            try:
                self._urgent_w.send(b"x")
            except OSError:
                pass

    # -------------------------------------------------- outbound micro-batching
    @any_thread
    def _send_to(self, handle, msg, nbytes: Optional[int] = None) -> None:
        """Send a control message to a worker/driver/daemon handle, coalescing
        per connection while the scheduler thread is inside a loop iteration
        (flushed on threshold and before the loop sleeps). Off-thread callers
        (e.g. pull-read responders) and disabled batching send directly. Send
        failures route to the handle's death path. `nbytes` lets hot callers
        pass a size they already know instead of the estimator walk."""
        buf = self._out_buffer
        if buf is None or threading.get_ident() != self._loop_tid:
            if not handle.send(msg):
                if threading.get_ident() == self._loop_tid:
                    self._on_send_failure(handle)
                else:
                    # Death handlers mutate loop-owned tables (worker maps,
                    # pending queue, leases): an off-thread caller (e.g. a
                    # pull-read responder) must hand the failure to the loop
                    # instead of running them here (rt-lint affinity rule).
                    try:
                        self.call_nowait("handle_send_failure", handle)
                    except RuntimeError:
                        pass  # scheduler stopped; nothing left to clean up
            return
        ent = buf.get(id(handle))
        if ent is None:
            ent = buf[id(handle)] = [handle, [], 0]
        ent[1].append(msg)
        ent[2] += _approx_msg_nbytes(msg) if nbytes is None else nbytes
        self.telemetry.out_msgs += 1
        if len(ent[1]) >= self._batch_max_msgs or ent[2] >= self._batch_max_bytes:
            del buf[id(handle)]
            self._send_many(handle, ent[1])

    def _send_many(self, handle, msgs: List[Any]) -> None:
        msg = msgs[0] if len(msgs) == 1 else ("batch", msgs)
        self.telemetry.out_frames += 1
        if not handle.send(msg):
            self._on_send_failure(handle)

    @loop_thread_only
    def _flush_outbound(self) -> None:
        buf = self._out_buffer
        if buf is None:
            return
        # Loop until drained: a send failure runs death handlers, which may
        # legitimately buffer NEW messages to other connections (error
        # responses, actor-restart execs) — those must not sit through the
        # loop's next sleep. Terminates: each pass only re-buffers via
        # (liveness-guarded) death handlers, which run at most once per
        # handle.
        while buf:
            entries = list(buf.values())
            buf.clear()
            for handle, msgs, _nbytes in entries:
                self._send_many(handle, msgs)

    @loop_thread_only
    def _drop_outbound(self, handle) -> None:
        """Forget buffered messages for a dying connection (flushing to the
        corpse would re-enter the death path)."""
        if self._out_buffer is not None:
            self._out_buffer.pop(id(handle), None)

    def _cmd_handle_send_failure(self, handle) -> None:
        # Loop-thread re-entry for off-thread _send_to failures.
        self._on_send_failure(handle)

    @loop_thread_only
    def _on_send_failure(self, handle) -> None:
        # Liveness guards make the failure path idempotent: a flush may fail
        # for a handle whose death was already handled this iteration.
        if isinstance(handle, WorkerHandle):
            if self._workers_by_id.get(handle.worker_id.hex()) is handle:
                self._on_worker_death(handle)
        elif isinstance(handle, DriverHandle):
            if handle.conn in self._conn_to_driver:
                self._on_driver_death(handle)
        elif isinstance(handle, DaemonHandle):
            if handle.conn in self._conn_to_daemon:
                self._on_daemon_death(handle)

    # ------------------------------------------------------- readiness watch
    @loop_thread_only
    def _watch_conn(self, conn) -> None:
        try:
            self._selector.register(conn, self._selectors_mod.EVENT_READ)
        except (KeyError, ValueError, OSError):
            pass  # already registered / fd already dead (EOF path handles it)

    @loop_thread_only
    def _unwatch_conn(self, conn) -> None:
        try:
            self._selector.unregister(conn)
        except (KeyError, ValueError, OSError):
            pass

    @loop_thread_only
    def _rebuild_selector(self) -> None:
        """Recover from a stale fd (a connection closed without unwatch —
        e.g. a peer process died mid-iteration): re-register every live
        connection the maps still know about."""
        try:
            self._selector.close()
        except OSError:
            pass
        self._selector = self._selectors_mod.DefaultSelector()
        self._watch_conn(self._wake_r)
        self._watch_conn(self._urgent_r)
        for conn in list(self._conn_to_worker):
            self._watch_conn(conn)
        for conn in list(self._conn_to_daemon):
            self._watch_conn(conn)
        for conn in list(self._conn_to_driver):
            self._watch_conn(conn)

    # ------------------------------------------------------------------ main loop
    @loop_thread_only
    def _loop(self):
        self._loop_tid = threading.get_ident()
        self._watch_conn(self._wake_r)
        self._watch_conn(self._urgent_r)
        last_health_check = time.time()
        # Burst coalescing state: while deferring, the normal wake fd is
        # unwatched (submit wakes accumulate silently) and the select
        # timeout is the remaining budget; the urgent fd stays watched.
        deferring = False
        defer_deadline = 0.0
        while not self._stopped.is_set():
            timeout = 0.25
            if deferring:
                timeout = max(0.0005, defer_deadline - time.monotonic())
            try:
                ready = [key.fileobj for key, _ in self._selector.select(timeout=timeout)]
            except OSError:
                # A watched fd went stale (peer died without the EOF being
                # drained yet): rebuild from the live connection maps.
                self._rebuild_selector()
                ready = []
            # Reap workers that died before (or without) connecting back.
            now = time.time()
            if now - last_health_check > 0.5:
                last_health_check = now
                for node in list(self.nodes.values()):
                    for wh in list(node.workers.values()):
                        if not wh.process.is_alive() and wh.conn is None:
                            self._on_worker_death(wh)
            # Self-gated by memory_monitor_refresh_ms (NOT the 0.5s health
            # gate — sub-500ms refresh settings must be honored).
            self._memory_monitor_tick(now)
            self._sweep_serve_drains(now)
            # Telemetry snapshot: self-gated by internal_metrics_interval_s,
            # so a loop spinning per-message never pays per-iteration gauges.
            self.telemetry.on_iteration(self, now)
            # Alert evaluation + obs self-gauges: self-gated by
            # alert_eval_interval_s; absent entirely when metrics are off.
            if self.obs is not None:
                self.obs.on_iteration(self, now)
            # Tenant ledger sample + metric flush: same self-gated cadence,
            # same absence contract (self.jobs is None exactly when obs is).
            if self.jobs is not None:
                self.jobs.on_iteration(self, now)
            if self._delayed_retries:
                due = [x for x in self._delayed_retries if x[0] <= now]
                if due:
                    self._delayed_retries = [
                        x for x in self._delayed_retries if x[0] > now
                    ]
                    for _, rec in due:
                        if rec.state == "PENDING":
                            self.pending.push(rec)
            for obj in ready:
                if obj is self._wake_r:
                    # Drain + clear atomically vs _wake's set + send: after
                    # this block, either no byte is pending and the flag is
                    # False, or a producer has sent a fresh byte.
                    with self._wake_lock:
                        try:
                            while self._wake_r.recv(4096):
                                pass
                        except BlockingIOError:
                            pass
                        self._wake_pending = False
                    continue
                if obj is self._urgent_r:
                    with self._wake_lock:
                        try:
                            while self._urgent_r.recv(4096):
                                pass
                        except BlockingIOError:
                            pass
                        self._urgent_pending = False
                    continue
                wh = self._conn_to_worker.get(obj)
                if wh is not None:
                    self._drain_worker(wh)
                    continue
                daemon = self._conn_to_daemon.get(obj)
                if daemon is not None:
                    self._drain_daemon(daemon)
                    continue
                dh = self._conn_to_driver.get(obj)
                if dh is not None:
                    self._drain_driver(dh)
            # Heartbeat staleness detector — AFTER the drains, so beats that
            # queued while the loop was busy are applied before staleness is
            # judged (a slow loop iteration must not false-kill live peers).
            # Self-gated by its own period, honoring sub-500ms settings.
            self._check_heartbeats(time.time())
            # Deadline watcher for in-flight stack-dump / profile fan-outs
            # (an empty list — the steady state — costs one attribute check).
            if self._introspections:
                self._tick_introspection(time.time())
            # Burst coalescing: a HOT fire-and-forget command stream (the
            # newest enqueue within _burst_hot_s) with no blocking caller
            # waiting defers the drain up to the coalesce budget. On a
            # single core the alternative is the loop timeslicing against
            # the submitting thread mid-burst — both run slower than
            # letting the burst land first and draining it in one pass.
            if (
                self._burst_coalesce_s > 0.0
                and self._blocking_pending == 0
                and self._owner_waiters == 0
                and time.monotonic() - self._last_cmd_enqueue < self._burst_hot_s
                and not self._commands.empty()
            ):
                if not deferring:
                    deferring = True
                    defer_deadline = time.monotonic() + self._burst_coalesce_s
                    self._unwatch_conn(self._wake_r)
                if time.monotonic() < defer_deadline:
                    # Deliver anything the drains above coalesced, then park.
                    try:
                        self._flush_outbound()
                    except Exception:
                        import traceback

                        traceback.print_exc()
                    continue
            if deferring:
                deferring = False
                self._watch_conn(self._wake_r)
            # Drain commands (a fire-and-forget submit has fut=None: the whole
            # burst is processed in ONE wakeup instead of one ack round trip
            # per submission — the pipelined-submission fast path).
            while True:
                try:
                    method, payload, fut = self._commands.get_nowait()
                except queue.Empty:
                    break
                if fut is not None:
                    with self._wake_lock:
                        self._blocking_pending -= 1
                if method == "_stop":
                    if self.jobs is not None:
                        # Orderly shutdown: every still-live job (including
                        # the in-process driver's) seals into the ring so a
                        # --persist restart can still answer for it.
                        self.jobs.finalize_all(time.time())
                    self._shutdown_workers()
                    fut.set_result(None)
                    self._stopped.set()
                    break
                try:
                    if failpoints.ENABLED and failpoints.fire(
                        "sched.cmd." + method
                    ):
                        # Injected mid-handler crash: follows the real error
                        # path (future rejection / submit-failure sealing).
                        raise failpoints.FailpointInjected(
                            f"sched.cmd.{method}"
                        )
                    result = getattr(self, "_cmd_" + method)(payload)
                    # _ASYNC handlers resolve a caller-provided inner future later;
                    # the command future just acknowledges receipt.
                    if fut is not None:
                        fut.set_result(None if result is _ASYNC else result)
                except Exception as e:  # noqa: BLE001
                    if fut is not None:
                        fut.set_exception(e)
                    else:
                        # Fire-and-forget command: the error must reach the
                        # caller through the task's return refs, or a get()
                        # on them would hang forever.
                        self._seal_submit_failure(payload, e)
            # The loop must survive any scheduling-path exception: a dead
            # scheduler thread would hang every future get/put forever.
            try:
                self._schedule()
            except Exception:
                import traceback

                traceback.print_exc()
            # Never sleep on undelivered output: everything this iteration
            # coalesced goes out before the next mpc.wait.
            try:
                self._flush_outbound()
            except Exception:
                import traceback

                traceback.print_exc()
        # Loop exited: fail any command that raced the stop and is still queued
        # (fire-and-forget commands have no future to fail).
        while True:
            try:
                _method, _payload, fut = self._commands.get_nowait()
            except queue.Empty:
                break
            if fut is not None and not fut.done():
                fut.set_exception(RuntimeError("scheduler is stopped"))

    @loop_thread_only
    def _drain_worker(self, wh: WorkerHandle):
        try:
            while wh.conn.poll():
                msg = _decode(wh.conn.recv_bytes(), "scheduler <- worker")
                if msg is not None:
                    self._on_worker_message(wh, msg)
        except (EOFError, OSError):
            self._on_worker_death(wh)

    @loop_thread_only
    def _drain_daemon(self, daemon: DaemonHandle):
        try:
            while daemon.conn.poll():
                msg = _decode(daemon.conn.recv_bytes(), "scheduler <- daemon")
                if msg is not None:
                    self._on_daemon_message(daemon, msg)
        except (EOFError, OSError):
            self._on_daemon_death(daemon)

    @loop_thread_only
    def _on_daemon_message(self, daemon: DaemonHandle, msg):
        kind = msg[0]
        if session_monitor.ENABLED:
            session_monitor.check_tag("scheduler.daemon", kind)
        if kind == "batch":
            for m in msg[1]:
                self._on_daemon_message(daemon, m)
            return
        if kind == "heartbeat":
            node = self.nodes.get(daemon.node_id)
            if node is not None:
                node.last_heartbeat = time.time()
                node.health = lifecycle.step("node_health", node.health, "ALIVE")
            return
        if kind == "worker_exit" or kind == "spawn_failed":
            wh = self._workers_by_id.get(msg[1])
            if wh is not None and isinstance(wh.process, _RemoteProc):
                wh.process.mark_dead()
                # If the worker never connected back, its EOF will never arrive:
                # reap it here. Connected workers are reaped via conn EOF.
                if wh.conn is None:
                    self._on_worker_death(wh)
        elif kind == "object_data":
            _, token, ok, data = msg
            self._finish_pull(token, ok, data)
        elif kind == "stacks_data" or kind == "profile_data":
            if session_monitor.ENABLED:
                session_monitor.resolve(kind, msg[1])
            self._on_introspect_reply(msg[1], msg[2])
        elif kind == "memory_pressure":
            from ray_tpu_torch._private.memory_monitor import MemorySnapshot

            snap = MemorySnapshot(msg[1], msg[2])
            # The head's config governs (daemons sample with the thresholds
            # pushed at registration, but re-check here so init-time
            # disabling always wins).
            if (
                self.config.memory_monitor_refresh_ms > 0
                and snap.used_fraction >= self.config.memory_usage_threshold
            ):
                node = next(
                    (n for n in self.nodes.values() if n.daemon is daemon), None
                )
                if node is not None and node.alive:
                    self._oom_kill_one([node], snap)

    @loop_thread_only
    def _drain_driver(self, dh: DriverHandle):
        try:
            while dh.conn.poll():
                msg = _decode(dh.conn.recv_bytes(), "scheduler <- driver")
                if msg is not None:
                    self._on_driver_message(dh, msg)
        except (EOFError, OSError):
            self._on_driver_death(dh)

    @loop_thread_only
    def _on_driver_message(self, dh: DriverHandle, msg):
        kind = msg[0]
        if session_monitor.ENABLED:
            session_monitor.check_tag("scheduler.driver", kind)
        if kind == "batch":
            for m in msg[1]:
                self._on_driver_message(dh, m)
        elif kind == "req":
            _, req_id, method, payload = msg
            self._on_worker_request(dh, req_id, method, payload)
        elif kind == "cmd":
            self._on_worker_request(dh, None, msg[1], msg[2])
        elif kind == "object_data":
            _, token, ok, data = msg
            self._finish_pull(token, ok, data)
        elif kind == "locate_object":
            self._on_locate_object(dh, msg[1], msg[2])
        elif kind == "ref_ops":
            self._apply_ref_ops(msg[1], dh.holder_id)

    @loop_thread_only
    def _shutdown_workers(self):
        # Deliver anything still coalesced before the shutdown frames — a
        # direct send must never overtake buffered messages on a connection.
        self._flush_outbound()
        for node in self.nodes.values():
            if node.daemon is not None:
                node.daemon.send(("shutdown",))
            for wh in list(node.workers.values()):
                wh.send(("shutdown",))
        deadline = time.time() + 2.0
        for node in self.nodes.values():
            for wh in list(node.workers.values()):
                t = max(0.0, deadline - time.time())
                wh.process.join(timeout=t)
                if wh.process.is_alive():
                    wh.process.terminate()
                    self._exiting.append(wh.process)
        # Killed processes cannot refuse to die; wait (bounded) until they have.
        deadline = time.time() + _EXIT_WAIT_S
        for proc in self._exiting:
            proc.join(timeout=max(0.0, deadline - time.time()))
        self._exiting.clear()

    # ------------------------------------------------------------------ nodes
    def _cmd_add_node(self, payload) -> NodeID:
        # (resources, labels[, gpu_ids]): gpu_ids are the node's device ids
        # when they are not 0..GPU-1 (a driver started under
        # CUDA_VISIBLE_DEVICES).
        resources, labels, *rest = payload
        gpu_ids = rest[0] if rest else None
        node_id = NodeID.from_random()
        shm_dir = os.path.join(self.session_dir, "shm")
        node = NodeState(
            node_id=node_id,
            resources=dict(resources),
            available=dict(resources),
            shm_dir=shm_dir,
            labels=labels or {},
            # Head/virtual nodes share the head store dir; the head's own
            # push server serves their segments peer-direct.
            data_address=self._data_address,
            gpu_load={str(i): 0.0 for i in gpu_ids or ()},
        )
        self.nodes[node_id] = node
        self.node_order.append(node_id)
        return node_id

    def _cmd_remove_node(self, node_id: NodeID):
        """Simulate node failure: kill its workers, fail its tasks/actors
        (chaos-testing hook; reference: NodeKillerActor, test_utils.py:1355)."""
        node = self.nodes.get(node_id)
        if node is None:
            return False
        node.alive = False
        self._emit_event(
            "node_removed",
            f"node {node_id.hex()[:8]} removed "
            f"({len(node.workers)} worker(s) terminated)",
            node_id=node_id.hex(),
        )
        if node.daemon is not None:
            self._prune_dead_process(getattr(node.daemon, "pid", None))
            node.daemon.send(("shutdown",))
            self._conn_to_daemon.pop(node.daemon.conn, None)
            self._unwatch_conn(node.daemon.conn)
            self._pull_sources.pop(node_id.binary(), None)
            try:
                node.daemon.conn.close()
            except OSError:
                pass
        for wh in list(node.workers.values()):
            try:
                wh.process.terminate()
            except Exception:
                pass
            self._on_worker_death(wh)
        del self.nodes[node_id]
        self.node_order.remove(node_id)
        self._drop_node_replicas(node_id.binary())
        # PG bundles on this node go back to pending.
        for pg in self.pgs.values():
            for b in pg.bundles:
                if b.node == node_id:
                    b.node = None
                    pg.state = lifecycle.step("placement_group", pg.state,
                                              "RESCHEDULING")
                    if pg not in self.pending_pgs:
                        self.pending_pgs.append(pg)
        return True

    def _cmd_get_nodes(self, payload=None):
        out = [
            {
                "node_id": n.node_id.hex(),
                "resources": dict(n.resources),
                "available": dict(n.available),
                "alive": n.alive,
                "health": n.health,
                "labels": dict(n.labels),
                "num_workers": len(n.workers),
                "flight_recorder": n.flight_recorder,
                "workers": [
                    {
                        "worker_id": w.worker_id.hex(),
                        # os_pid = the register hello's real pid (process.pid
                        # is -1 for daemon-managed workers).
                        "pid": w.os_pid or w.process.pid,
                        "state": w.state,
                        "health": w.health,
                        "actor_id": w.actor_id.hex() if w.actor_id else None,
                        "current_task": w.current_task.hex()
                        if w.current_task else None,
                        "flight_recorder": w.flight_recorder,
                    }
                    for w in n.workers.values()
                ],
            }
            for n in self.nodes.values()
        ]
        if isinstance(payload, dict) and payload.get("include_postmortems"):
            # Heartbeat-DEAD daemon nodes: gone from the live table, but the
            # postmortem (with its flight-recorder dump) is still wanted.
            out.extend(dict(p) for p in self._node_postmortems)
        return out

    def _cmd_available_resources(self, _):
        out: Dict[str, float] = {}
        for n in self.nodes.values():
            for k, v in n.available.items():
                out[k] = out.get(k, 0.0) + v
        return out

    def _cmd_cluster_resources(self, _):
        out: Dict[str, float] = {}
        for n in self.nodes.values():
            for k, v in n.resources.items():
                out[k] = out.get(k, 0.0) + v
        return out

    # ------------------------------------------------------------------ workers
    def _spawn_worker(self, node: NodeState, actor_id: Optional[ActorID] = None,
                      env_vars: Optional[Dict[str, str]] = None,
                      runtime_env: Optional[Dict] = None) -> WorkerHandle:
        if node.daemon is not None:
            return self._spawn_remote_worker(node, actor_id, env_vars, runtime_env)
        worker_id = WorkerID.from_random()
        args = WorkerArgs(
            worker_id_hex=worker_id.hex(),
            node_id_hex=node.node_id.hex(),
            shm_dir=node.shm_dir,
            session_name=os.path.basename(self.session_dir),
            config=self.config,
            env_vars=env_vars or {},
            is_actor_worker=actor_id is not None,
            runtime_env=runtime_env,
            head_address=f"{self.tcp_address[0]}:{self.tcp_address[1]}",
        )
        log_dir = os.path.join(self.session_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        envb = dict(os.environ)
        envb.update(env_vars or {})
        envb["RAY_TPU_TORCH_AUTHKEY_HEX"] = self._authkey.hex()
        envb["RAY_TPU_TORCH_LOG_TO_DRIVER"] = "1" if self.config.log_to_driver else "0"
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        envb["PYTHONPATH"] = repo_root + os.pathsep + envb.get("PYTHONPATH", "")
        blob = base64.b64encode(pickle.dumps(args)).decode()
        out = open(os.path.join(log_dir, f"worker-{worker_id.hex()[:8]}.log"), "wb")
        cmd = [sys.executable, "-m", "ray_tpu_torch._private.worker_entry",
               "--address", self._sock_path, "--args", blob]
        if runtime_env and runtime_env.get("container"):
            from ray_tpu_torch._private.runtime_env import wrap_worker_command

            cmd = wrap_worker_command(
                runtime_env, cmd, envb,
                [node.shm_dir, self.session_dir, repo_root],
            )
        popen = subprocess.Popen(
            cmd,
            env=envb,
            stdout=out,
            stderr=subprocess.STDOUT,
            cwd=repo_root,
        )
        out.close()
        from ray_tpu_torch._private.runtime_env import env_hash as _renv_hash

        wh = WorkerHandle(
            worker_id=worker_id,
            node_id=node.node_id,
            process=_Proc(popen),
            state="idle" if actor_id is None else "busy",
            actor_id=actor_id,
            env_hash=_renv_hash(runtime_env),
        )
        node.workers[worker_id] = wh
        self._workers_by_id[worker_id.hex()] = wh
        if actor_id is None:
            node.idle.append(worker_id)
        return wh

    def _spawn_remote_worker(self, node: NodeState, actor_id: Optional[ActorID],
                             env_vars: Optional[Dict[str, str]],
                             runtime_env: Optional[Dict] = None) -> WorkerHandle:
        """Lease a worker on a daemon-managed node: the daemon execs the worker
        process, which dials back over TCP (reference: raylet WorkerPool start,
        `src/ray/raylet/worker_pool.h:77`)."""
        from ray_tpu_torch._private.runtime_env import env_hash as _renv_hash

        worker_id = WorkerID.from_random()
        args = WorkerArgs(
            worker_id_hex=worker_id.hex(),
            node_id_hex=node.node_id.hex(),
            shm_dir=node.shm_dir,
            session_name=os.path.basename(self.session_dir),
            config=self.config,
            env_vars=env_vars or {},
            is_actor_worker=actor_id is not None,
            runtime_env=runtime_env,
            head_address=f"{self.tcp_address[0]}:{self.tcp_address[1]}",
        )
        wh = WorkerHandle(
            worker_id=worker_id,
            node_id=node.node_id,
            process=_RemoteProc(node.daemon, worker_id.hex()),
            state="idle" if actor_id is None else "busy",
            actor_id=actor_id,
            env_hash=_renv_hash(runtime_env),
        )
        node.workers[worker_id] = wh
        self._workers_by_id[worker_id.hex()] = wh
        if actor_id is None:
            node.idle.append(worker_id)
        blob = base64.b64encode(pickle.dumps(args)).decode()
        # The worker's environment over the daemon's, as a local spawn sets
        # it: an actor's CUDA_VISIBLE_DEVICES names its own device ids, not
        # every device of the daemon's.
        info = {"worker_id_hex": worker_id.hex(), "args_blob": blob,
                "env_vars": dict(env_vars or {})}
        if runtime_env and runtime_env.get("container"):
            # The daemon wraps the worker command on ITS host (binary
            # discovery and mounts are node-local decisions).
            info["container_env"] = runtime_env
        if not node.daemon.send(("spawn_worker", info)):
            # Daemon unreachable: the health/reap path collects this handle and
            # the daemon-EOF path removes the node.
            wh.process.mark_dead()
        return wh

    @loop_thread_only
    def _on_worker_death(self, wh: WorkerHandle):
        self._drop_outbound(wh)
        # os_pid comes from the worker's register hello; process.pid is the
        # fallback for workers that died before registering (local spawns
        # only — _RemoteProc reports -1, which the helper ignores).
        pid = wh.os_pid or getattr(wh.process, "pid", None)
        self._prune_dead_process(pid)
        self._emit_event(
            "worker_dead",
            f"worker {wh.worker_id.hex()[:8]} (pid {pid}) died"
            + (f" while running actor {wh.actor_id.hex()[:8]}"
               if wh.actor_id else ""),
            severity="warning", worker_id=wh.worker_id.hex(), pid=pid,
            node_id=wh.node_id.hex(),
        )
        node = self.nodes.get(wh.node_id)
        if node is not None:
            node.workers.pop(wh.worker_id, None)
            if wh.worker_id in node.idle:
                node.idle.remove(wh.worker_id)
        if isinstance(wh.process, _Proc) and wh.process.is_alive():
            self._exiting = [p for p in self._exiting if p.is_alive()] + [wh.process]
        self._workers_by_id.pop(wh.worker_id.hex(), None)
        if wh.conn is not None:
            self._conn_to_worker.pop(wh.conn, None)
            self._unwatch_conn(wh.conn)
            try:
                wh.conn.close()
            except OSError:
                pass
        self._drop_holder_everywhere(wh.worker_id.hex())
        self._dead_holders.add(wh.worker_id.hex())
        self._prune_serve_state_for_worker(wh.worker_id.hex())
        self._fail_tasks_of_dead_owner(wh.worker_id.hex())
        self._kill_actors_owned_by(wh.worker_id.hex())
        if wh.actor_id is not None:
            self._handle_actor_worker_death(wh)
        else:
            # Every in-flight task dies with the worker — the running head
            # AND any lease-pipelined tasks queued behind it.
            dead = list(wh.inflight_tasks) or (
                [wh.current_task] if wh.current_task is not None else []
            )
            self._drop_lease(wh)
            for tid in dead:
                rec = self.tasks.get(tid)
                if rec is not None and rec.state == "RUNNING":
                    self._handle_task_worker_death(rec)

    def _handle_task_worker_death(self, rec: TaskRecord):
        self._release_task_resources(rec)
        if rec.retries_left > 0:
            rec.retries_left -= 1
            rec.state = lifecycle.step("task", rec.state, "PENDING")
            rec.worker = None
            self._record_event(rec.spec, "RETRY")
            self.telemetry.retried += 1
            if self.jobs is not None:
                # The dead attempt's partial lease accrues; the retry waits
                # in queue again from now.
                self.jobs.task_requeued(rec.spec.task_id, time.time())
            # A fresh attempt gets a fresh stage pipeline (the dead attempt's
            # lease/worker stamps would otherwise leak into the retry's).
            rec.stage_ts = {"queued": time.time()}
            if rec.oom_killed:
                # Back off before re-queuing (task_oom_retry_delay_ms): an
                # immediate redispatch under sustained pressure would be
                # re-killed on the next tick, burning every retry at once.
                rec.oom_killed = False
                delay = self.config.task_oom_retry_delay_ms / 1000.0
                self._delayed_retries.append((time.time() + delay, rec))
            else:
                self.pending.push(rec)
        else:
            from ray_tpu_torch.exceptions import OutOfMemoryError, WorkerCrashedError

            name = rec.spec.name or rec.spec.func.name
            if rec.oom_killed:
                err: Exception = OutOfMemoryError(
                    f"Task {name} was killed by the memory monitor"
                    f"{rec.oom_detail} (no retries left)."
                )
            else:
                err = WorkerCrashedError(
                    f"Worker running task {name} died "
                    "unexpectedly (no retries left)."
                )
            self._store_error_results(rec, err)
            # Push to the errors channel too (reference: error messages reach
            # the driver via GCS pubsub even before anyone get()s the ref).
            self._publish(
                "errors",
                {"task": name, "message": str(err), "type": type(err).__name__},
            )

    # -------------------------------------------------------------- OOM killer
    @loop_thread_only
    def _memory_monitor_tick(self, now: float) -> None:
        """Sample host/cgroup usage; above the threshold, kill one worker by
        the configured policy (reference: MemoryMonitor callback ->
        WorkerKillingPolicy). Daemon-managed nodes sample their own hosts and
        report pressure via ("memory_pressure", used, total)."""
        if self.config.memory_monitor_refresh_ms <= 0:
            return
        if now - self._last_memory_check < self.config.memory_monitor_refresh_ms / 1000.0:
            return
        self._last_memory_check = now
        from ray_tpu_torch._private import memory_monitor as mm

        snap = mm.get_memory_snapshot()
        if snap.used_fraction < self.config.memory_usage_threshold:
            return
        # Local tick covers locally-spawned workers; daemon nodes are killed
        # on their own pressure reports.
        nodes = [n for n in self.nodes.values() if n.alive and n.daemon is None]
        self._oom_kill_one(nodes, snap)

    def _oom_kill_one(self, nodes: List["NodeState"], snap) -> None:
        from ray_tpu_torch._private import memory_monitor as mm

        candidates = []
        actor_candidates = []
        for node in nodes:
            for wh in node.workers.values():
                if wh.state == "dying":
                    continue
                if wh.actor_id is not None:
                    # Restartable actors are retriable in the reference
                    # worker-killing sense — lower priority than stateless
                    # tasks (in-flight calls fail with RayActorError), but
                    # killing one beats falling through to the kernel OOM
                    # killer when actor memory is what's growing. Per-actor
                    # cooldown (the task path's oom retry delay): without it,
                    # sustained pressure re-kills the restarted actor every
                    # monitor tick and burns its whole max_restarts budget in
                    # ~a second.
                    ar = self.actors.get(wh.actor_id)
                    if (
                        ar is not None
                        and ar.num_restarts < ar.max_restarts
                        and time.monotonic()
                        - getattr(ar, "last_oom_kill", 0.0)
                        > 10 * self.config.task_oom_retry_delay_ms / 1000.0
                    ):
                        rec = (
                            self.tasks.get(wh.current_task)
                            if wh.current_task is not None
                            else None
                        )
                        actor_candidates.append(
                            mm.KillCandidate(
                                worker_key=wh,
                                retriable=True,
                                started_at=(
                                    rec.running_since
                                    if rec is not None and rec.state == "RUNNING"
                                    else 0.0
                                ),
                                owner=rec.owner if rec is not None else "",
                            )
                        )
                    continue
                if wh.current_task is None:
                    continue
                rec = self.tasks.get(wh.current_task)
                if rec is None or rec.state != "RUNNING":
                    continue
                candidates.append(
                    mm.KillCandidate(
                        worker_key=wh,
                        retriable=rec.retries_left > 0,
                        started_at=rec.running_since,
                        owner=rec.owner,
                    )
                )
        victim = mm.select_worker_to_kill(
            candidates, self.config.worker_killing_policy
        )
        if victim is None:
            victim = mm.select_worker_to_kill(
                actor_candidates, self.config.worker_killing_policy
            )
        if victim is None:
            # Persistent pressure with nothing eligible must be visible to
            # operators — otherwise the node quietly drifts into the kernel
            # OOM killer with no record of why the framework stood by.
            now = time.monotonic()
            if now - getattr(self, "_last_no_victim_log", 0.0) > 30.0:
                self._last_no_victim_log = now
                self._publish(
                    "errors",
                    {
                        "task": "memory_monitor",
                        "message": (
                            f"memory pressure at {snap.used_fraction:.0%} but no "
                            "eligible worker to kill (no running stateless tasks, "
                            "no restartable actors)"
                        ),
                        "type": "MemoryPressureNoVictim",
                    },
                )
            return
        wh = victim.worker_key
        if wh.actor_id is not None:
            ar = self.actors.get(wh.actor_id)
            if ar is not None:
                ar.last_oom_kill = time.monotonic()
        detail = (
            f" (node at {snap.used_fraction:.0%} of "
            f"{snap.total_bytes >> 20}MB, policy "
            f"{self.config.worker_killing_policy})"
        )
        # Tag every task in the worker's in-flight window so the death
        # handler raises OutOfMemoryError (retriable) instead of a crash.
        for tid in wh.inflight_tasks or (
            [wh.current_task] if wh.current_task else []
        ):
            rec = self.tasks.get(tid)
            if rec is not None:
                rec.oom_killed = True
                rec.oom_detail = detail
        # The process dies asynchronously (EOF/exit notification lags the
        # terminate by up to a health-check period): take the worker OUT of
        # scheduling NOW or fresh tasks pipeline onto the corpse and die as
        # collateral. Keep inflight_tasks — the death handler fails/retries
        # exactly that window.
        self._remove_from_lease_index(wh)
        wh.lease_key = None
        wh.state = lifecycle.step("worker", wh.state, "dying")
        node = self.nodes.get(wh.node_id)
        if node is not None and wh.worker_id in node.idle:
            node.idle.remove(wh.worker_id)
        try:
            wh.process.terminate()
        except Exception:
            pass
        # Local processes reap via conn EOF / liveness check; daemon workers
        # via the daemon's worker_exit notification.

    # ------------------------------------------------------------- heartbeats
    @loop_thread_only
    def _check_heartbeats(self, now: float) -> None:
        """ALIVE -> SUSPECT -> DEAD staleness detector over the heartbeat
        channel. Connection EOF only catches CLEAN deaths; a SIGSTOP'd,
        wedged, or partitioned peer keeps its socket open forever — this is
        the path that catches those. Daemon-backed nodes: one silent period
        marks the node SUSPECT, period * threshold declares it DEAD (node
        removed, in-flight tasks fail over; the daemon rejoins as a fresh
        node if it ever wakes). Workers: SUSPECT is observational only —
        liveness/EOF stays the kill signal, so a long GIL-bound compile is
        never shot by its own slowness."""
        period = self.config.health_check_period_ms / 1000.0
        if period <= 0:
            return
        if now - self._last_hb_check < min(period / 2.0, 0.25):
            return
        self._last_hb_check = now
        grace = period * max(1, self.config.health_check_failure_threshold)
        # SUSPECT at two silent periods (not one): beats arrive AT period
        # cadence, so a one-period threshold would flap ALIVE<->SUSPECT on
        # ordinary jitter. Two periods = at least one genuinely missed beat.
        suspect_after = 2.0 * period
        tel = self.telemetry
        for node in list(self.nodes.values()):
            if node.daemon is None or not node.alive:
                continue
            stale = now - node.last_heartbeat
            if stale > grace:
                node.health = lifecycle.step("node_health", node.health, "DEAD")
                tel.hb_dead_daemon += 1
                # Postmortem entry: the node is about to vanish from the
                # table, but the flight recorder captured at SUSPECT time
                # (or its "unavailable" verdict) must stay queryable.
                self._node_postmortems.append(
                    {
                        "node_id": node.node_id.hex(),
                        "alive": False,
                        "health": "DEAD",
                        "postmortem": True,
                        "died_at": now,
                        "labels": dict(node.labels),
                        "flight_recorder": node.flight_recorder
                        or {
                            "trigger": "DEAD",
                            "captured_at": now,
                            "dump": {
                                "transport": "unavailable",
                                "error": f"no heartbeat for {stale:.1f}s and "
                                         "no stack capture completed before "
                                         "the node was declared DEAD",
                            },
                        },
                    }
                )
                self._publish(
                    "errors",
                    {
                        "task": "health_check",
                        "type": "NodeHeartbeatTimeout",
                        "message": (
                            f"node {node.node_id.hex()[:8]} sent no heartbeat "
                            f"for {stale:.1f}s (grace {grace:.1f}s): "
                            "declaring it DEAD"
                        ),
                    },
                )
                self._emit_event(
                    "node_dead",
                    f"node {node.node_id.hex()[:8]} declared DEAD: no "
                    f"heartbeat for {stale:.1f}s (grace {grace:.1f}s)",
                    severity="error", node_id=node.node_id.hex(),
                    stale_s=round(stale, 3),
                )
                self._on_daemon_death(node.daemon)
            elif stale > suspect_after and node.health == "ALIVE":
                node.health = lifecycle.step("node_health", node.health, "SUSPECT")
                tel.hb_suspect_daemon += 1
                self._emit_event(
                    "node_suspect",
                    f"node {node.node_id.hex()[:8]} marked SUSPECT: no "
                    f"heartbeat for {stale:.1f}s",
                    severity="warning", node_id=node.node_id.hex(),
                    stale_s=round(stale, 3),
                )
                # Flight recorder: grab a stack dump the MOMENT the process
                # goes quiet — by DEAD time there may be nothing left to ask.
                self._capture_flight_recorder(
                    f"daemon:{node.node_id.hex()}",
                    node.daemon,
                    ("daemon", node.daemon),
                    lambda d, n=node: self._store_node_flight_recorder(n, d),
                )
        for wh in self._workers_by_id.values():
            if wh.conn is None:
                continue  # still connecting: spawn latency is not a hang
            if now - wh.last_heartbeat > suspect_after and wh.health == "ALIVE":
                wh.health = lifecycle.step("worker_health", wh.health, "SUSPECT")
                tel.hb_suspect_worker += 1
                self._emit_event(
                    "worker_suspect",
                    f"worker {wh.worker_id.hex()[:8]} (pid "
                    f"{getattr(wh.process, 'pid', None)}) marked SUSPECT "
                    "(observational: EOF/liveness stay the kill signals)",
                    severity="warning", worker_id=wh.worker_id.hex(),
                )
                self._capture_flight_recorder(
                    f"worker:{wh.worker_id.hex()}",
                    wh,
                    ("worker", wh),
                    lambda d, w=wh: setattr(w, "flight_recorder", d),
                )

    def _handle_actor_worker_death(self, wh: WorkerHandle):
        from ray_tpu_torch.exceptions import RayActorError

        ar = self.actors.get(wh.actor_id)
        if ar is None:
            return
        info = self.gcs.actors.get(wh.actor_id)
        # Fail all in-flight calls.
        err = RayActorError(f"Actor {wh.actor_id.hex()} died (worker crashed).")
        for tid in ar.inflight:
            rec = self.tasks.get(tid)
            if rec is not None:
                self._store_error_results(rec, err)
        ar.inflight.clear()
        ar.worker = None
        if ar.state == "DEAD":
            self._release_actor_resources(ar)
            return
        if ar.num_restarts < ar.max_restarts:
            ar.num_restarts += 1
            ar.state = lifecycle.step("actor", ar.state, "RESTARTING")
            if info:
                info.state = lifecycle.step("actor", info.state, "RESTARTING")
                info.num_restarts = ar.num_restarts
            self._release_actor_resources(ar)
            self._try_start_actor(ar)
        else:
            ar.state = lifecycle.step("actor", ar.state, "DEAD")
            ar.death_cause = "worker crashed"
            if info:
                info.state = lifecycle.step("actor", info.state, "DEAD")
                info.death_cause = ar.death_cause
            self._release_actor_resources(ar)
            self._release_actor_creation_pins(ar)
            self._drop_detached(ar.actor_id)
            self._drop_actor_name(ar.actor_id)
            for req in ar.backlog:
                rec = self.tasks.get(req.spec.task_id)
                if rec is not None:
                    self._store_error_results(rec, err)
            ar.backlog.clear()

    # ------------------------------------------------------------------ messages
    @loop_thread_only
    def _on_worker_message(self, wh: WorkerHandle, msg):
        kind = msg[0]
        if session_monitor.ENABLED:
            session_monitor.check_tag("scheduler.worker", kind)
        if kind == "batch":
            # Coalesced frame: apply every contained message now; scheduling
            # work runs once per loop iteration regardless of batch size.
            for m in msg[1]:
                self._on_worker_message(wh, m)
            return
        if kind == "register":
            # Restart the staleness clock: last_heartbeat was stamped at
            # SPAWN, and a slow cold start (interpreter + imports) must not
            # count as silence — the first beat is one period away from HERE.
            wh.last_heartbeat = time.time()
            # Real OS pid (process.pid is -1 for daemon-managed workers):
            # death-time metrics/series pruning keys on it.
            if len(msg) > 2:
                wh.os_pid = msg[2]
            return
        if kind == "heartbeat":
            wh.last_heartbeat = time.time()
            wh.health = lifecycle.step("worker_health", wh.health, "ALIVE")
            return
        if kind == "done":
            # Lease-pipelined workers coalesce dones into "batch" frames
            # while their local queue is non-empty; order within the frame =
            # execution order. Element 5 (worker-side stage timestamps) is
            # optional: absent when enable_timeline is off.
            _, task_id_bytes, ok, metas = msg[:4]
            stages = msg[4] if len(msg) > 4 else None
            self._on_task_done(wh, TaskID(task_id_bytes), ok, metas, stages)
        elif kind == "stream":
            _, task_id_bytes, index, meta = msg
            self._on_stream_item(TaskID(task_id_bytes), index, meta)
        elif kind == "req":
            _, req_id, method, payload = msg
            self._on_worker_request(wh, req_id, method, payload)
        elif kind == "cmd":
            # One-way request (no ack): the pipelined submission path.
            self._on_worker_request(wh, None, msg[1], msg[2])
        elif kind == "log":
            self._on_worker_log(wh, msg)
        elif kind == "ref_ops":
            self._apply_ref_ops(msg[1], wh.worker_id.hex())
        elif kind == "locate_object":
            self._on_locate_object(wh, msg[1], msg[2])
        elif kind == "serve_proxy_up":
            self._serve_proxy_up(wh, msg[1])
        elif kind == "serve_proxy_down":
            self._serve_proxies.pop(msg[1], None)
        elif kind == "serve_drained":
            if session_monitor.ENABLED:
                session_monitor.resolve("serve_drained", msg[1])
            self._on_serve_drained(msg[1], msg[2], msg[3])
        elif kind == "stacks_data" or kind == "profile_data":
            if session_monitor.ENABLED:
                session_monitor.resolve(kind, msg[1])
            self._on_introspect_reply(msg[1], msg[2])

    # ------------------------------------------------------ serve ingress tier
    def _serve_proxy_up(self, wh: WorkerHandle, info: dict) -> None:
        """Service-directory registration for a Serve HTTP proxy: the head
        records WHERE ingress listens (node, port, pid) so clients/dashboards
        discover endpoints; it never relays request bytes."""
        entry = dict(info)
        entry["worker_id"] = wh.worker_id.hex()
        proxy_id = entry.get("proxy_id") or wh.worker_id.hex()
        entry["proxy_id"] = proxy_id
        self._serve_proxies[proxy_id] = entry

    def _cmd_serve_directory(self, _arg=None):
        return [dict(v) for v in self._serve_proxies.values()]

    def _cmd_serve_actor_inflight(self, actor_id_bytes: bytes):
        """Submitted-but-unfinished call count for one actor — the precise
        inflight window a graceful drain must let finish (the actor itself
        cannot see calls still parked in its ordered queue)."""
        ar = self.actors.get(ActorID(actor_id_bytes))
        if ar is None:
            return 0
        return len(ar.inflight) + len(ar.backlog)

    def _start_serve_drain(self, actor_id_bytes: bytes, timeout_s: float,
                           reply_to: tuple) -> None:
        ar = self.actors.get(ActorID(actor_id_bytes))
        target = None
        if ar is not None and ar.worker is not None:
            target = self._workers_by_id.get(ar.worker.hex())
        if target is None:
            # Dead or never placed: drained by definition.
            self._finish_serve_drain(reply_to, {"ok": True, "inflight": 0})
            return
        token = next(self._serve_drain_tokens)
        self._serve_drains[token] = (
            reply_to, time.time() + float(timeout_s) + 5.0,
            target.worker_id.hex(),
        )
        if session_monitor.ENABLED:
            session_monitor.expect("serve_drain", token)
        self._send_to(target, ("serve_drain", token, float(timeout_s)))

    def _finish_serve_drain(self, reply_to: tuple, result: dict) -> None:
        if reply_to[0] == "conn":
            self._respond(reply_to[1], reply_to[2], True, result)
        elif not reply_to[1].done():
            reply_to[1].set_result(result)

    def _req_serve_drain_actor(self, wh, req_id: Optional[int], payload):
        actor_id_bytes, timeout_s = payload
        self._start_serve_drain(actor_id_bytes, timeout_s, ("conn", wh, req_id))

    def _cmd_serve_drain_actor(self, payload):
        # In-process driver form: (actor_id_bytes, timeout_s, inner_future).
        actor_id_bytes, timeout_s, fut = payload
        self._start_serve_drain(actor_id_bytes, timeout_s, ("future", fut))
        return _ASYNC

    def _on_serve_drained(self, token, ok, inflight) -> None:
        entry = self._serve_drains.pop(token, None)
        if entry is None:
            return  # deadline sweep answered first; late reply tolerated
        reply_to, _deadline, _target = entry
        self._finish_serve_drain(
            reply_to, {"ok": bool(ok), "inflight": int(inflight)}
        )

    def _sweep_serve_drains(self, now: float) -> None:
        if not self._serve_drains:
            return
        for token, (reply_to, deadline, _target) in list(
            self._serve_drains.items()
        ):
            if now >= deadline:
                del self._serve_drains[token]
                if session_monitor.ENABLED:
                    session_monitor.forget("serve_drain", token)
                self._finish_serve_drain(
                    reply_to, {"ok": False, "inflight": -1}
                )

    def _prune_serve_state_for_worker(self, worker_id_hex: str) -> None:
        """Worker death: its proxy directory entries vanish and any drain
        targeting it completes — a dead actor's inflight window is over."""
        for pid_, entry in list(self._serve_proxies.items()):
            if entry.get("worker_id") == worker_id_hex:
                del self._serve_proxies[pid_]
        for token, (reply_to, _deadline, target) in list(
            self._serve_drains.items()
        ):
            if target == worker_id_hex:
                del self._serve_drains[token]
                if session_monitor.ENABLED:
                    session_monitor.forget("serve_drain", token)
                self._finish_serve_drain(
                    reply_to, {"ok": True, "inflight": 0}
                )

    @any_thread
    def _respond(self, wh: WorkerHandle, req_id: Optional[int], ok: bool, payload):
        # req_id None = one-way "cmd" message: no ack is expected.
        if req_id is None:
            return
        # Coalesced on the loop thread (a burst of object-ready answers rides
        # one frame); off-thread responders (pull reads) send directly.
        self._send_to(wh, ("resp", req_id, ok, payload))

    def _on_worker_request(self, wh: WorkerHandle, req_id: Optional[int], method: str, payload):
        handler = getattr(self, "_req_" + method, None)
        if handler is None:
            self._respond(wh, req_id, False, ValueError(f"unknown request {method}"))
            return
        try:
            if failpoints.ENABLED and failpoints.fire("sched.req." + method):
                raise failpoints.FailpointInjected(f"sched.req.{method}")
            handler(wh, req_id, payload)
        except Exception as e:  # noqa: BLE001
            if req_id is None:
                # One-way submit: surface the failure through the task's
                # return refs (nobody is waiting on an ack).
                self._seal_submit_failure(payload, e, holder=self._holder_of(wh))
            else:
                self._respond(wh, req_id, False, e)

    def _seal_submit_failure(self, payload, err: Exception,
                             holder: Optional[str] = None) -> None:
        """A fire-and-forget submit's handler raised: seal the error into the
        payload's return refs so the caller's get() raises instead of
        hanging. `holder` is the actual submitter (holder sets are
        idempotent, so re-registering after a partial handler is safe).
        Payloads without return refs just log."""
        import traceback

        traceback.print_exc()
        rec = None
        if isinstance(payload, TaskRecord):
            rec = payload
        elif (
            isinstance(payload, tuple)
            and len(payload) == 4
            and isinstance(payload[0], TaskSpec)
        ):
            # submit_fast payload: (spec, return_ids, func_blob, dispatch_key).
            spec, return_ids, func_blob, dispatch_key = payload
            rec = self.tasks.get(spec.task_id) or fast_task_record(
                spec, (), {}, return_ids, func_blob, spec.max_retries, dispatch_key
            )
        elif isinstance(payload, ExecRequest):
            rec = self.tasks.get(payload.spec.task_id) or TaskRecord(
                spec=payload.spec,
                arg_entries=[],
                kwarg_entries={},
                return_ids=list(payload.return_ids),
                func_blob=None,
            )
        if rec is not None and rec.return_ids:
            try:
                # Owner must be set BEFORE sealing: the error seal forwards
                # to the owner's table, else its in-process get would hang.
                if not rec.owner:
                    rec.owner = holder or self._INPROC_DRIVER
                self.tasks.setdefault(rec.spec.task_id, rec)
                self._register_return_holders(
                    rec.return_ids, holder or self._INPROC_DRIVER
                )
                self._store_error_results(rec, err)
            except Exception:
                traceback.print_exc()

    # ----------------------------------------------------------- cluster events
    def _prune_dead_process(self, pid) -> None:
        """Observability teardown for a departed process (worker, daemon, or
        client driver): delete its frozen `metrics::<pid>`/`spans::<pid>` KV
        snapshots — they would ride every future /metrics exposition forever
        — and drop its series from the time-series store (a frozen gauge
        would otherwise keep carrying forward into alert evaluation)."""
        if not pid or pid < 0:  # unknown / _RemoteProc's -1 placeholder
            return
        self.gcs.kv_del(f"metrics::{pid}".encode())
        self.gcs.kv_del(f"spans::{pid}".encode())
        if self.obs is not None:
            self.obs.prune_process(str(pid))
        if self.jobs is not None:
            self.jobs.prune_process(str(pid))

    def _emit_event(self, kind: str, message: str, severity: str = "info",
                    **data) -> None:
        """Head-side cluster-event append (events.py kinds; the scheduler's
        seams call this directly — no command hop, no traffic). Gated with
        the rest of the over-time layer (enable_metrics + enable_obs)."""
        if self.obs is None:
            return
        self.gcs.append_cluster_event(kind, message, severity=severity,
                                      source="head", data=data)

    # ------------------------------------------------------------------ pubsub
    def _publish(self, channel: str, payload: dict) -> None:
        """Deliver to every subscriber of `channel`: in-process callbacks
        directly, remote drivers as a ("pub", channel, payload) push."""
        for cb in self._inproc_subs.get(channel, ()):
            try:
                cb(payload)
            except Exception:  # noqa: BLE001 — a bad printer must not kill the loop
                pass
        holders = self._subscriptions.get(channel)
        if not holders:
            return
        for dh in list(self._conn_to_driver.values()):
            if dh.holder_id in holders:
                try:
                    self._send_to(dh, ("pub", channel, payload))
                except (OSError, ValueError):
                    pass

    def _cmd_subscribe(self, payload):
        channel, callback = payload
        self._inproc_subs.setdefault(channel, []).append(callback)
        return True

    def _req_subscribe(self, wh, req_id: int, channel: str):
        self._subscriptions.setdefault(channel, set()).add(self._holder_of(wh))
        self._respond(wh, req_id, True, True)

    def _on_worker_log(self, wh: WorkerHandle, msg) -> None:
        _, worker_id_hex, pid, stream, task_name, lines = msg
        self._publish(
            "logs",
            {
                "worker_id": worker_id_hex,
                "pid": pid,
                "stream": stream,
                "task": task_name,
                "node_id": wh.node_id.hex(),
                "lines": lines,
            },
        )

    @loop_thread_only
    def _on_task_done(self, wh: WorkerHandle, task_id: TaskID, ok: bool,
                      metas: List[ObjectMeta],
                      stages: Optional[Dict[str, float]] = None):
        rec = self.tasks.get(task_id)
        if rec is None:
            return
        if rec.state == "CANCELLED":
            # The task executed before its cancel landed (its done was
            # buffered/in flight). The cancel already sealed the results and
            # removed it from the worker's inflight window — re-running the
            # completion path would clobber the successor's transferred
            # accounting and overwrite the cancellation error.
            return
        if stages:
            rec.stage_ts.update(stages)
        rec.state = lifecycle.step("task", rec.state,
                                   "FINISHED" if ok else "FAILED")
        tel = self.telemetry
        if ok:
            tel.finished += 1
        else:
            tel.failed += 1
        if self.jobs is not None:
            # Before resource release/transfer below: the ledger reads the
            # lease interval it opened at dispatch, not rec.acquired.
            self.jobs.task_terminal(
                task_id, "finished" if ok else "failed", time.time()
            )
        if tel.enabled and stages:
            t0, t1 = stages.get("exec_start"), stages.get("exec_end")
            if t0 is not None and t1 is not None:
                tel.exec_times.append(t1 - t0)
        self._record_event(rec.spec, rec.state, rec=rec)
        # Actor-creation args stay pinned for the actor's lifetime: a restart
        # replays the creation task and needs them (released on DEAD).
        if not rec.spec.is_actor_creation:
            self._release_task_pins(rec)
        for meta in metas:
            self._seal_object(meta)
        if rec.spec.returns_mode is not None:
            self._finalize_stream(rec)
        if rec.spec.actor_id is not None:
            ar = self.actors.get(rec.spec.actor_id)
            if ar is not None:
                ar.inflight.pop(task_id, None)
                if rec.spec.is_actor_creation:
                    self._on_actor_created(ar, ok, metas)
        else:
            was_inflight = task_id in wh.inflight_tasks
            if was_inflight:
                wh.inflight_tasks.remove(task_id)
            elif wh.inflight_tasks:
                # Stale done (task already removed from the window, e.g. a
                # cancel raced an in-flight completion): other tasks still
                # own the lease — touching the transfer logic would corrupt
                # their accounting.
                return
            successor = None
            if wh.actor_id is None and wh.inflight_tasks:
                successor = self.tasks.get(wh.inflight_tasks[0])
            if successor is not None:
                # Lease pipelining: the worker is already executing the next
                # queued task — transfer the resource accounting instead of
                # release+reacquire (every acquired unit still released
                # exactly once, by whichever task finishes last).
                successor.acquired = rec.acquired
                successor.acquired_pg = rec.acquired_pg
                rec.acquired = {}
                rec.acquired_pg = None
                if self.jobs is not None:
                    # The successor's (cpus=0) open lease now carries the
                    # transferred resources — its job pays from here on.
                    self.jobs.task_lease_transferred(
                        successor.spec.task_id,
                        successor.acquired.get("CPU", 0.0), time.time(),
                    )
                wh.current_task = successor.spec.task_id
                if wh.state == "blocked":
                    # The blocked head finished; the successor runs unblocked.
                    wh.state = lifecycle.step("worker", wh.state, "busy")
            else:
                self._release_task_resources(rec)
                if wh.actor_id is None and wh.state != "dying":
                    # Never re-idle a worker the OOM killer already
                    # terminated — a late-buffered done must not put the
                    # corpse back into dispatch rotation.
                    wh.state = lifecycle.step("worker", wh.state, "idle")
                    wh.current_task = None
                    self._drop_lease(wh)
                    node = self.nodes.get(wh.node_id)
                    if node is not None and wh.worker_id not in node.idle and node.alive:
                        node.idle.append(wh.worker_id)

    def _on_actor_created(self, ar: ActorRecord, ok: bool, metas: List[ObjectMeta]):
        info = self.gcs.actors.get(ar.actor_id)
        if ar.state == "DEAD":
            # Killed while the creation task was in flight: tear the worker down.
            node = self.nodes.get(ar.node)
            wh = node.workers.get(ar.worker) if node else None
            if wh is not None:
                try:
                    wh.process.terminate()
                except Exception:
                    pass
                self._on_worker_death(wh)
            return
        if ok:
            ar.state = lifecycle.step("actor", ar.state, "ALIVE")
            if info:
                info.state = lifecycle.step("actor", info.state, "ALIVE")
                info.node_id = ar.node
            for req in ar.backlog:
                self._dispatch_actor_call(ar, req)
            ar.backlog.clear()
        else:
            # Creation raised: actor is dead; error already sealed into the
            # creation "ready" object so waiters see the root cause.
            ar.state = lifecycle.step("actor", ar.state, "DEAD")
            ar.death_cause = "creation task failed"
            if info:
                info.state = lifecycle.step("actor", info.state, "DEAD")
                info.death_cause = ar.death_cause
            from ray_tpu_torch.exceptions import RayActorError

            err = RayActorError(f"Actor {ar.actor_id.hex()} failed during creation.")
            for req in ar.backlog:
                rec = self.tasks.get(req.spec.task_id)
                if rec is not None:
                    self._store_error_results(rec, err)
            ar.backlog.clear()
            self._release_actor_resources(ar)
            self._release_actor_creation_pins(ar)
            self._drop_detached(ar.actor_id)
            self._drop_actor_name(ar.actor_id)

    # ------------------------------------------------------------------ generator streams
    # Reference semantics: `num_returns="dynamic"` / streaming generator tasks
    # (`python/ray/_raylet.pyx:174 ObjectRefGenerator`,
    # `core_worker/task_manager.cc HandleReportGeneratorItemReturns`). The worker
    # seals each yielded value as it is produced; consumers pull items through
    # `stream_next` before the task finishes.
    @staticmethod
    def _gen_holder(task_id: TaskID) -> str:
        return "gen:" + task_id.hex()

    def _on_stream_item(self, task_id: TaskID, index: int, meta: ObjectMeta):
        rec = self.tasks.get(task_id)
        if rec is None:
            # Cancelled + GC'd while the item was in flight: nothing holds it.
            self._seal_object(meta)
            return
        if index == len(rec.stream_metas):
            # Interim holder keeps the item alive between seal and consumption
            # (dropped when the consumer takes its own reference, when the
            # dynamic handle's contained_ids pin it, or at stream release).
            if not rec.stream_released:
                self._add_holder(meta.object_id.binary(), self._gen_holder(task_id))
            self._seal_object(meta)
            rec.stream_metas.append(meta)
            rec.return_ids.append(meta.object_id)
        elif index < len(rec.stream_metas):
            # Replay after a retry / lineage re-execution: reseal fresh bytes.
            rec.stream_metas[index] = meta
            self._seal_object(meta)
        else:
            # Out-of-order index (should not happen on a FIFO pipe): seal so the
            # bytes are tracked, but don't corrupt the stream order.
            self._seal_object(meta)
            return
        if rec.stream_waiters:
            n = len(rec.stream_metas)
            still = []
            for want, fut in rec.stream_waiters:
                if want < n:
                    if not fut.done():
                        fut.set_result(("item", rec.stream_metas[want]))
                else:
                    still.append((want, fut))
            rec.stream_waiters = still

    def _finalize_stream(self, rec: TaskRecord):
        """Terminal transition of a generator task: fix the item count and
        answer parked consumers with EOF."""
        if rec.spec.returns_mode == "dynamic":
            # The handle object (sealed just before this) pins every item via
            # contained_ids; the interim gen holders can go.
            gh = self._gen_holder(rec.spec.task_id)
            for m in rec.stream_metas:
                self._rel_holder(m.object_id.binary(), gh)
        if rec.stream_total is None:
            rec.stream_total = len(rec.stream_metas)
        self._wake_throttled(rec, flush_all=True)
        n = len(rec.stream_metas)
        waiters, rec.stream_waiters = rec.stream_waiters, []
        for want, fut in waiters:
            if fut.done():
                continue
            if want < n:
                fut.set_result(("item", rec.stream_metas[want]))
            else:
                fut.set_result(("eof", n))

    def _seal_stream_error(self, rec: TaskRecord, make_meta) -> None:
        """Seal an error as the NEXT stream item of a streaming-mode record, so
        the consumer raises exactly where the producer stopped. `make_meta`
        builds the ObjectMeta for the chosen ObjectID."""
        idx = len(rec.stream_metas)
        oid = ObjectID.for_return(rec.spec.task_id, 1 + idx)
        m = make_meta(oid)
        if not rec.stream_released:
            self._add_holder(oid.binary(), self._gen_holder(rec.spec.task_id))
        self._seal_object(m)
        rec.stream_metas.append(m)
        rec.return_ids.append(oid)

    def _async_stream_next(self, task_id_bytes: bytes, index: int, fut, blocking: bool = True):
        rec = self.tasks.get(TaskID(task_id_bytes))
        if rec is None:
            # Record evicted (cancelled or fully GC'd): the stream is over.
            fut.set_result(("eof", index))
            return
        if index > rec.stream_requested:
            rec.stream_requested = index
            self._wake_throttled(rec)
        if index < len(rec.stream_metas):
            fut.set_result(("item", rec.stream_metas[index]))
            return
        if rec.stream_total is not None or rec.state in ("FINISHED", "FAILED", "CANCELLED"):
            fut.set_result(("eof", len(rec.stream_metas)))
            return
        if not blocking:
            # Poller (e.g. the Data streaming executor): answer immediately
            # instead of parking a waiter per poll.
            fut.set_result(("pending", None))
            return
        rec.stream_waiters.append((index, fut))

    def _wake_throttled(self, rec: TaskRecord, flush_all: bool = False):
        """Un-park producers waiting for the consumer to catch up. A released
        stream answers "stop": the producer abandons the generator gracefully
        (no worker kill, the process returns to the idle pool)."""
        if not rec.throttle_waiters:
            return
        verdict = "stop" if rec.stream_released else "go"
        still = []
        for threshold, respond in rec.throttle_waiters:
            if flush_all or rec.stream_requested >= threshold:
                respond(verdict)
            else:
                still.append((threshold, respond))
        rec.throttle_waiters = still

    def _req_stream_throttle(self, wh, req_id: int, payload):
        """Producer-side backpressure: block until the consumer has requested
        item `threshold` (i.e. the producer is within its window again), the
        stream is released ("stop"), or the record is gone."""
        task_id_bytes, threshold = payload
        rec = self.tasks.get(TaskID(task_id_bytes))
        if rec is None or rec.stream_released:
            self._respond(wh, req_id, True, "stop")
            return
        if rec.stream_requested >= threshold:
            self._respond(wh, req_id, True, "go")
            return
        self._mark_blocked(wh, kind="throttle")

        def respond(verdict):
            self._unmark_blocked(wh)
            self._respond(wh, req_id, True, verdict)

        rec.throttle_waiters.append((threshold, respond))

    def _cmd_stream_next(self, payload):
        task_id_bytes, index, fut = payload[:3]
        blocking = payload[3] if len(payload) > 3 else True
        self._async_stream_next(task_id_bytes, index, fut, blocking)
        return _ASYNC

    def _req_stream_next(self, wh, req_id: int, payload):
        task_id_bytes, index = payload[:2]
        blocking = payload[2] if len(payload) > 2 else True
        self._mark_blocked(wh)

        def done(result):
            self._unmark_blocked(wh)
            self._respond(wh, req_id, True, result)

        fut = concurrent.futures.Future()
        fut.add_done_callback(lambda f: done(f.result()))
        self._async_stream_next(task_id_bytes, index, fut, blocking)

    def _release_stream(self, task_id_bytes: bytes):
        """Consumer dropped its generator handle: release interim holders on
        unconsumed items and stop the producer. A PENDING producer is
        cancelled outright; a RUNNING one is stopped COOPERATIVELY — its next
        throttle checkpoint answers "stop" and the worker abandons the
        generator and returns to the idle pool (the reference cancels
        generator tasks similarly without killing the worker; a SIGKILL here
        would pay a process respawn on every `take()`/early loop exit)."""
        tid = TaskID(task_id_bytes)
        rec = self.tasks.get(tid)
        if rec is None:
            return False
        rec.stream_released = True
        self._wake_throttled(rec, flush_all=True)
        gh = self._gen_holder(tid)
        for m in list(rec.stream_metas):
            self._rel_holder(m.object_id.binary(), gh)
        if rec.state == "PENDING" and rec.spec.actor_id is None:
            self._cmd_cancel((tid, False))
        return True

    # ------------------------------------------------------------------ objects
    def _seal_object(self, meta: ObjectMeta):
        key = meta.object_id.binary()
        old = self.object_table.get(key)
        if old is not None:
            # Reseal (reconstruction / error overwrite): retire the old copy's
            # accounting before the new one takes over.
            self._retire_meta_accounting(old)
        self.object_table[key] = meta
        if meta.segment and meta.node_id and meta.owns_payload and not meta.spilled:
            nid = NodeID(meta.node_id)
            self.node_usage[nid] = self.node_usage.get(nid, 0) + meta.size
        if meta.contained_ids:
            for child in meta.contained_ids:
                self._pin(child)
            self.contained_pins[key] = list(meta.contained_ids)
        waiters = self.object_waiters.pop(key, None)
        if waiters:
            for cb in waiters:
                cb(meta)
        reconstructing = self._reconstructing.pop(key, None)
        if reconstructing:
            for respond in reconstructing:
                respond(True, meta)
        # Ownership forward: the submitting process keeps the record of truth
        # for its objects — hand it the sealed meta so its gets resolve
        # in-process. Put objects skip this (the putter delivered locally):
        # a worker-side put shares its creating TASK's id prefix, so the
        # rec lookup would hit that task's record and forward a frame its
        # owner never expected. The put bit is the u32 index's high bit
        # (little-endian -> top bit of the key's last byte).
        if meta.object_id._binary[-1] < 0x80:
            rec = self.tasks.get(meta.object_id.task_id)
            if rec is not None and rec.owner:
                self._forward_to_owner(rec.owner, meta)
        # The seal itself may be the last event keeping a dropped object alive.
        self._maybe_free(key)

    def _forward_to_owner(self, owner: str, meta: ObjectMeta) -> None:
        """Route a sealed meta to its owner's OwnershipTable: the in-process
        driver by direct (thread-safe) call, remote owners as coalesced
        ("own_meta", meta) frames on their existing control connections."""
        if owner == self._INPROC_DRIVER:
            sink = self.inproc_meta_sink
            if sink is not None:
                sink(meta)
            return
        wh = self._workers_by_id.get(owner)
        if wh is not None:
            self._send_to(wh, ("own_meta", meta))
            return
        dh = self._holder_to_driver.get(owner)
        if dh is not None:
            self._send_to(dh, ("own_meta", meta))

    # --- refcounting core ---
    def _add_holder(self, key: bytes, holder: str):
        self.holders.setdefault(key, set()).add(holder)

    def _rel_holder(self, key: bytes, holder: str):
        hs = self.holders.get(key)
        if hs is not None:
            hs.discard(holder)
            if not hs:
                del self.holders[key]
        self._maybe_free(key)

    def _pin(self, key: bytes, n: int = 1):
        self.pins[key] = self.pins.get(key, 0) + n

    def _unpin(self, key: bytes):
        n = self.pins.get(key, 0) - 1
        if n <= 0:
            self.pins.pop(key, None)
            self._maybe_free(key)
        else:
            self.pins[key] = n

    def _register_return_holders(self, return_ids: List[ObjectID], holder: str):
        for oid in return_ids:
            self._add_holder(oid.binary(), holder)

    def _release_task_pins(self, rec: TaskRecord):
        if rec.pins_released:
            return
        rec.pins_released = True
        for d in rec.dep_ids:
            self._unpin(d)

    def _release_actor_creation_pins(self, ar: "ActorRecord"):
        rec = self.tasks.get(ar.creation_req.spec.task_id)
        if rec is not None:
            self._release_task_pins(rec)
        if ar.state == "DEAD":
            # A dead actor's creation record has no return objects to trigger
            # lineage GC from: try directly (no-op if restarts remain).
            self._maybe_gc_lineage_task(ar.creation_req.spec.task_id)

    def _maybe_free(self, key: bytes):
        if key in self.holders or self.pins.get(key, 0) > 0:
            return
        if key in self._reconstructing or key in self.object_waiters:
            return
        meta = self.object_table.pop(key, None)
        if meta is None:
            # Bytes may already be gone (e.g. a failed reconstruction popped
            # the stale meta): the creating record can still become GC-able
            # now that the last holder dropped.
            self._maybe_gc_lineage(ObjectID(key))
            return
        self._retire_meta_accounting(meta)
        self._delete_segment(meta)
        self._purge_replicas(key, meta)
        self._maybe_gc_lineage(meta.object_id)

    def _gc_eligible(self, oid: ObjectID):
        return self._gc_eligible_task(oid.task_id)

    def _gc_eligible_task(self, task_id):
        """The record for `task_id`, iff it can be evicted: terminal, not an
        actor-creation replay source (while the actor can restart), every
        return fully freed, and no retained record consumes a return as a
        dep."""
        rec = self.tasks.get(task_id)
        if rec is None or rec.state not in ("FINISHED", "FAILED", "CANCELLED"):
            return None
        if rec.spec.is_actor_creation:
            # Restarts replay the creation task while the actor can come
            # back; once it is DEAD (or unknown) the record is GC-able like
            # any other — otherwise actor churn leaks records forever.
            ar = self.actors.get(rec.spec.actor_id)
            if ar is not None and ar.state != "DEAD":
                return None
        for rid in rec.return_ids:
            k = rid.binary()
            if (
                k in self.object_table
                or k in self.holders
                or self.pins.get(k, 0) > 0
                or k in self._reconstructing
                or k in self.object_waiters
                or self.lineage_consumers.get(k, 0) > 0
            ):
                return None
        return rec

    def _maybe_gc_lineage(self, oid: ObjectID):
        """Drop the creating task's record once (a) every return object is
        fully freed — reconstruction of them can never be requested — AND
        (b) no retained record lists a return among its deps — re-executing
        such a consumer would need the return's value, which needs THIS
        record. Dropping a record releases its own dep references, which may
        cascade-free upstream records. The reference bounds lineage with
        footprint accounting (`core_worker/task_manager.h:543-553`); without
        eviction the task table grows forever on long-running drivers."""
        self._maybe_gc_lineage_task(oid.task_id)

    def _maybe_gc_lineage_task(self, task_id):
        rec = self._gc_eligible_task(task_id)
        if rec is None:
            return
        # Cascade via an explicit worklist (a sequential chain of thousands of
        # records would blow Python recursion limits inside the event thread).
        worklist = [rec]
        self.tasks.pop(rec.spec.task_id, None)
        while worklist:
            dropped = worklist.pop()
            self._gc_task_summaries.append(self._task_summary(dropped))
            for d in dropped.dep_ids:
                n = self.lineage_consumers.get(d, 0) - 1
                if n <= 0:
                    self.lineage_consumers.pop(d, None)
                    # The dep may now be the last thing holding ITS record.
                    if d in self.object_table or d in self.holders:
                        continue
                    upstream = self._gc_eligible(ObjectID(d))
                    if upstream is not None:
                        self.tasks.pop(upstream.spec.task_id, None)
                        worklist.append(upstream)
                else:
                    self.lineage_consumers[d] = n

    def _retire_meta_accounting(self, meta: ObjectMeta):
        key = meta.object_id.binary()
        if meta.segment and meta.node_id and meta.owns_payload and not meta.spilled:
            nid = NodeID(meta.node_id)
            self.node_usage[nid] = max(0, self.node_usage.get(nid, 0) - meta.size)
        for child in self.contained_pins.pop(key, []):
            self._unpin(child)

    def _delete_segment(self, meta: ObjectMeta):
        if not meta.segment or not meta.owns_payload:
            return
        if meta.arena_offset is None:
            # Dependency-error metas alias their parent's segment; only the
            # object that actually owns the file (segments are named by
            # creator id) may unlink it. (Arena allocations are per-object by
            # construction, so the guard only applies to file segments.)
            if os.path.basename(meta.segment) != meta.object_id.hex():
                return
        # Daemons and client drivers both honor ("delete_object", path, off)
        # on their connections; head-local (virtual-node) segments free here.
        source = self._pull_sources.get(meta.node_id or b"")
        if source is not None:
            # Coalesced: a release burst (e.g. a dropped dataset) deletes in
            # a handful of frames instead of one write per object.
            self._send_to(source, ("delete_object", meta.segment, meta.arena_offset))
        elif meta.arena_offset is not None:
            from ray_tpu_torch._private.object_store import get_node_arena

            arena = get_node_arena(os.path.dirname(meta.segment))
            if arena is not None:
                arena.free(meta.arena_offset)
        else:
            try:
                os.unlink(meta.segment)
            except OSError:
                pass

    def _drop_holder_everywhere(self, holder: str):
        """A process died or disconnected: release every ref it held."""
        for key in [k for k, hs in self.holders.items() if holder in hs]:
            self._rel_holder(key, holder)
        # Streams whose consumer was this process: release interim gen holders
        # (the consumer can never ask for the items now).
        for rec in [r for r in self.tasks.values() if r.stream_owner == holder]:
            if rec.spec.returns_mode is not None and not rec.stream_released:
                self._release_stream(rec.spec.task_id.binary())

    def _apply_ref_ops(self, ops: List[Tuple[str, bytes]], holder: str):
        for op, key in ops:
            if op == "add":
                self._add_holder(key, holder)
            elif op == "genrel":
                # Consumer took its own reference to a streamed item (the "add"
                # precedes this op in the same FIFO batch): drop the interim
                # generator holder.
                self._rel_holder(key, self._gen_holder(ObjectID(key).task_id))
            elif op == "srel":
                # Consumer dropped its ObjectRefGenerator handle (key is the
                # producer TASK id): release unconsumed items, cancel if live.
                self._release_stream(key)
            else:
                self._rel_holder(key, holder)

    def _check_capacity(self, meta: ObjectMeta) -> Optional[Exception]:
        """Enforce Config.object_store_memory for explicit puts (task returns are
        allowed to overshoot — the work is already done, as in the reference's
        fallback allocation)."""
        if not meta.segment or not meta.node_id:
            return None
        from ray_tpu_torch.exceptions import ObjectStoreFullError

        nid = NodeID(meta.node_id)
        cap = self.config.object_store_memory
        usage = self.node_usage.get(nid, 0)
        if usage + meta.size > cap:
            return ObjectStoreFullError(
                f"object store on node {nid.hex()[:8]} is full: "
                f"{usage + meta.size} > capacity {cap} bytes. Free ObjectRefs "
                "(del / let them go out of scope) or raise object_store_memory."
            )
        return None

    @property
    def _spill_dir(self) -> str:
        session = os.path.basename(self.session_dir.rstrip("/"))
        base = self.config.object_spill_dir
        if base:
            # Always a per-session SUBDIR of the configured path: shutdown may
            # rmtree it without touching the user's other files or another
            # live session's spilled objects.
            return os.path.join(base, session + "_spill")
        import tempfile

        return os.path.join(tempfile.gettempdir(), session + "_spill")

    def _try_spill_new(self, meta: ObjectMeta) -> bool:
        """Relocate a just-written object to the disk spill dir (plasma's
        fallback-allocation analogue, `plasma_allocator.cc` fallback path).

        ONLY safe pre-seal: the meta has not been published, so no reader can
        hold the old location — readers always fetch current metas from the
        object table (get_metas / dispatch-time arg resolution). Mutates the
        meta in place to point at the spill file."""
        if not self.config.object_spilling or not meta.segment:
            return False
        if not os.path.exists(meta.segment):
            return False  # segment not on this filesystem: cannot relocate
        # NOTE: the byte copy runs on the scheduler's dispatch thread — a
        # multi-GB spill stalls other RPCs for its duration. Acceptable while
        # spills are the at-capacity slow path; the next step if profiles
        # disagree is relocating via the owning node's daemon (the channel
        # deletes already use) and applying only the meta update here.
        spill_dir = self._spill_dir
        dst = os.path.join(spill_dir, meta.object_id.hex())
        try:
            os.makedirs(spill_dir, exist_ok=True)
            if meta.arena_offset is not None:
                from ray_tpu_torch._private.object_store import get_node_arena

                arena = get_node_arena(os.path.dirname(meta.segment))
                if arena is None:
                    return False
                view = arena.view(meta.arena_offset, meta.size)
                with open(dst, "wb") as f:
                    f.write(view)
                arena.free(meta.arena_offset)
            else:
                import shutil

                # Cross-device (shm -> disk): copy + unlink, not rename.
                shutil.copyfile(meta.segment, dst)
                os.unlink(meta.segment)
        except OSError:
            try:
                os.unlink(dst)
            except OSError:
                pass
            return False
        meta.segment = dst
        meta.arena_offset = None
        meta.spilled = True
        self.telemetry.spill_ops += 1
        self.telemetry.spilled_bytes += meta.size
        self._emit_event(
            "object_spilled",
            f"object {meta.object_id.hex()[:8]} ({meta.size} B) spilled to "
            "disk (store at capacity)",
            object_id=meta.object_id.hex(), bytes=meta.size,
        )
        return True

    def _alias_error_meta(self, oid: ObjectID, err: ObjectMeta) -> ObjectMeta:
        """A dependent's error result aliasing the failed dependency's payload.
        The alias copies the full location (segment/arena_offset/node_id) so
        remote and arena-stored errors read correctly, owns_payload=False so
        freeing stays the owner's job, and contained_ids pins the owner so the
        payload cannot be recycled while the alias is referenced."""
        return ObjectMeta(
            object_id=oid,
            size=err.size,
            inband=err.inband,
            inline_buffers=err.inline_buffers,
            segment=err.segment,
            buffer_layout=err.buffer_layout,
            is_error=True,
            node_id=err.node_id,
            arena_offset=err.arena_offset,
            owns_payload=err.segment is None,
            contained_ids=[err.object_id.binary()] if err.segment else None,
        )

    def _store_error_results(self, rec: TaskRecord, err: Exception):
        sv = serialization.serialize(err)

        def err_meta(oid: ObjectID) -> ObjectMeta:
            return ObjectMeta(
                object_id=oid,
                size=sv.total_size,
                inband=sv.inband,
                inline_buffers=[bytes(b) for b in sv.buffers],
                is_error=True,
            )

        if rec.spec.returns_mode == "streaming":
            # Don't clobber already-streamed items (reference streaming-
            # generator error semantics).
            self._seal_stream_error(rec, err_meta)
        elif rec.spec.returns_mode == "dynamic":
            # The outer handle ref carries the error; partial items are dropped.
            self._seal_object(err_meta(rec.return_ids[0]))
        else:
            for oid in rec.return_ids:
                self._seal_object(err_meta(oid))
        rec.state = lifecycle.step("task", rec.state, "FAILED")
        self.telemetry.failed += 1
        if self.jobs is not None:
            # Universal error seal — also the satellite hygiene fix: a task
            # sealed while still PENDING (owner died, cancel) closes its
            # open queue-wait accrual here instead of leaking it. Idempotent
            # pop in the ledger: cancel paths that already recorded a
            # "cancelled" terminal are not double-counted.
            self.jobs.task_terminal(rec.spec.task_id, "failed", time.time())
        self._release_task_pins(rec)
        self._record_event(rec.spec, "FAILED", rec=rec)
        if rec.spec.returns_mode is not None:
            self._finalize_stream(rec)

    # The in-process driver's holder identity for refcounting.
    _INPROC_DRIVER = "driver0"

    @staticmethod
    def _holder_of(wh) -> str:
        return wh.holder_id if isinstance(wh, DriverHandle) else wh.worker_id.hex()

    # ------------------------------------------------------------------ commands (driver API)
    def _cmd_submit(self, payload):
        rec: TaskRecord = payload
        rec.owner = self._INPROC_DRIVER
        self._register_return_holders(rec.return_ids, self._INPROC_DRIVER)
        if rec.spec.returns_mode is not None:
            rec.stream_owner = self._INPROC_DRIVER
        self._register_task(rec)
        return [oid for oid in rec.return_ids]

    def _cmd_submit_fast(self, payload):
        """In-process submit carrying (spec, return_ids, func_blob,
        dispatch_key) instead of a built TaskRecord: record construction
        happens HERE on the loop thread — which burst coalescing keeps out
        of the submitting thread's timing window — instead of inside
        `.remote()`."""
        spec, return_ids, func_blob, dispatch_key = payload
        rec = fast_task_record(
            spec, (), {}, return_ids, func_blob, spec.max_retries, dispatch_key
        )
        if failpoints.ENABLED and failpoints.fire("sched.cmd.submit"):
            # The fast path is still a submit: a schedule armed on the
            # canonical name must hit both entry points.
            raise failpoints.FailpointInjected("sched.cmd.submit")
        return self._cmd_submit(rec)

    def _cmd_put_meta(self, meta: ObjectMeta):
        err = self._check_capacity(meta)
        if err is not None and not self._try_spill_new(meta):
            raise err
        self._add_holder(meta.object_id.binary(), self._INPROC_DRIVER)
        self._seal_object(meta)
        return True

    def _cmd_ref_ops(self, payload):
        ops, holder = payload
        self._apply_ref_ops(ops, holder or self._INPROC_DRIVER)
        return True

    def _cmd_get_metas(self, payload):
        ids, fut = payload
        self._async_get_metas(ids, fut)
        return _ASYNC

    def _cmd_peek_metas(self, ids: List[bytes]):
        return {i: self.object_table.get(i) for i in ids if i in self.object_table}

    def _cmd_wait(self, payload):
        ids, num_returns, fut = payload
        self._async_wait(ids, num_returns, fut)
        return _ASYNC

    def _cmd_free(self, ids: List[bytes]):
        """Force-free objects regardless of outstanding references (the unsafe
        `ray._private.internal_api.free` analogue)."""
        freed = []
        for i in ids:
            meta = self.object_table.pop(i, None)
            if meta is not None:
                self._retire_meta_accounting(meta)
                if meta.segment:
                    freed.append(meta)
                self._delete_segment(meta)
        return freed

    def _cmd_create_actor(self, payload, holder: Optional[str] = None):
        ar, info, name = payload
        # Validate BEFORE registering: raising after the table inserts would
        # leak a ghost PENDING record that pins its creator worker forever
        # (_owns_live_actors).
        if name and name in self.gcs.named_actors:
            raise ValueError(f"Actor name '{name}' already taken")
        self.actors[ar.actor_id] = ar
        self.gcs.actors[ar.actor_id] = info
        if not ar.detached:
            # Owned actor: the creator's death kills it (reference ownership
            # rules, `gcs_actor_manager.h:281`). Detached actors have no owner.
            ar.owner_holder = holder or self._INPROC_DRIVER
        if name:
            self.gcs.named_actors[name] = ar.actor_id
        if ar.detached or name:
            # Detached actors AND named owned actors persist: a head restart
            # under --persist replays their creation so get_actor(name) keeps
            # working (reference: GcsActorManager restores the actor table
            # from Redis, gcs_actor_manager.h:281).
            self._persist_detached(ar, name)
        self._register_return_holders(
            ar.creation_req.return_ids, holder or self._INPROC_DRIVER
        )
        self._try_start_actor(ar)
        return True

    # --------------------------------------------------------- detached actors
    def _persist_detached(self, ar: ActorRecord, name: Optional[str]) -> None:
        """Record a detached actor in the GCS so head --persist can restart
        it after a head restart (reference: Redis-backed GcsActorManager
        recovery). Only restorable records are kept: creation args must be
        inline (segment payloads and ObjectRefs die with the session)."""
        entries = list(
            getattr(ar.creation_req, "_saved_arg_entries", None) or []
        ) + list(
            (getattr(ar.creation_req, "_saved_kwarg_entries", None) or {}).values()
        )
        restorable = all(
            kind == "meta" and m.segment is None and not m.contained_ids
            for kind, m in entries
        )
        if not restorable:
            return
        info = self.gcs.actors.get(ar.actor_id)
        blob = serialization.dumps({
            "creation_req": ar.creation_req,
            "resources": ar.resources,
            "max_restarts": ar.max_restarts,
            "name": name,
            "class_name": info.class_name if info else "Actor",
            "actor_id": ar.actor_id,
            "detached": ar.detached,
        })
        self.gcs.detached_actors[ar.actor_id.binary()] = blob

    def _drop_detached(self, actor_id: ActorID) -> None:
        self.gcs.detached_actors.pop(actor_id.binary(), None)

    def _drop_actor_name(self, actor_id: ActorID) -> None:
        """Free a DEAD actor's registered name for reuse — every terminal
        transition must do this or create-with-name rejects the name forever
        while get_actor() already returns nothing."""
        for name, aid in list(self.gcs.named_actors.items()):
            if aid == actor_id:
                del self.gcs.named_actors[name]

    def _cmd_restore_detached_actor(self, blob: bytes):
        """Head restart with --persist: re-create a persisted detached actor
        (fresh state — the creation task replays, like an actor restart)."""
        from ray_tpu_torch._private.gcs import ActorInfo

        rec = serialization.loads(blob)
        actor_id = rec["actor_id"]
        if actor_id in self.actors:
            return False
        # DELIBERATE divergence from the reference: it never restarts owned
        # actors on GCS recovery because their worker processes SURVIVE a GCS
        # restart (raylets reconnect). Here a head restart kills every
        # worker, so name-reachability after restart requires creation
        # replay. Restored owned actors come back OWNERLESS (the owner died
        # with the old head) and live until killed explicitly.
        ar = ActorRecord(
            actor_id=actor_id,
            creation_req=rec["creation_req"],
            resources=rec["resources"],
            max_restarts=rec["max_restarts"],
            detached=bool(rec.get("detached", True)),
        )
        info = ActorInfo(
            actor_id=actor_id,
            name=rec["name"],
            class_name=rec["class_name"],
            max_restarts=rec["max_restarts"],
        )
        name = rec["name"]
        if name and name in self.gcs.named_actors:
            # A client raced the restore window and took the name: the live
            # actor wins; drop the stale record instead of clobbering.
            self.gcs.detached_actors.pop(actor_id.binary(), None)
            return False
        self.actors[actor_id] = ar
        self.gcs.actors[actor_id] = info
        if name:
            self.gcs.named_actors[name] = actor_id
        self.gcs.detached_actors[actor_id.binary()] = blob
        self._try_start_actor(ar)
        return True

    def _fail_tasks_of_dead_owner(self, holder: str) -> None:
        """Owner process died: its unresolved task results can never be
        accounted (the record of truth lived with the owner), so dependent
        gets must raise typed OwnerDiedError instead of hanging. PENDING
        tasks are dropped and sealed with the error; lease-queued (pipelined,
        not yet executing) tasks are cancelled on their workers; a task
        already executing runs to completion — its seal is still valid, and
        the dropped holder frees the result if nobody else borrows it."""
        from ray_tpu_torch.exceptions import OwnerDiedError

        for rec in list(self.tasks.values()):
            if rec.owner != holder or rec.state not in ("PENDING", "RUNNING"):
                continue
            name = rec.spec.name or rec.spec.func.name
            err = OwnerDiedError(
                f"Owner of task {name} ({holder[:12]}) died before its "
                "result resolved."
            )
            if rec.state == "PENDING":
                self.pending.remove(rec)
                if self.jobs is not None:
                    # Hygiene: the dead driver's still-queued task closes
                    # its queue-wait accrual NOW, as "cancelled" — the seal
                    # below would otherwise label it a failure (and nothing
                    # would close it at all pre-PR; see test_jobs).
                    self.jobs.task_terminal(
                        rec.spec.task_id, "cancelled", time.time()
                    )
                self._store_error_results(rec, err)
                rec.state = lifecycle.step("task", rec.state, "CANCELLED")
                continue
            node = self.nodes.get(rec.node)
            wh = node.workers.get(rec.worker) if node else None
            if (
                wh is not None
                and wh.current_task != rec.spec.task_id
                and rec.spec.task_id in wh.inflight_tasks
            ):
                wh.inflight_tasks.remove(rec.spec.task_id)
                self._send_to(wh, ("cancel_queued", rec.spec.task_id.binary()))
                if self.jobs is not None:
                    self.jobs.task_terminal(
                        rec.spec.task_id, "cancelled", time.time()
                    )
                self._store_error_results(rec, err)
                rec.state = lifecycle.step("task", rec.state, "CANCELLED")

    def _kill_actors_owned_by(self, holder: str) -> None:
        """An owner (driver/worker) died: its owned actors die with it;
        detached actors survive."""
        for ar in list(self.actors.values()):
            if ar.owner_holder == holder and ar.state != "DEAD":
                self._cmd_kill_actor((ar.actor_id, True))

    def _owns_live_actors(self, worker_hex: str) -> bool:
        return any(
            ar.owner_holder == worker_hex and ar.state != "DEAD"
            for ar in self.actors.values()
        )

    def _cmd_submit_actor_task(self, payload):
        req: ExecRequest = payload
        self._register_return_holders(req.return_ids, self._INPROC_DRIVER)
        return self._submit_actor_task(req)

    def _cmd_get_actor_by_name(self, name: str):
        actor_id = self.gcs.named_actors.get(name)
        if actor_id is None:
            return None
        info = self.gcs.actors.get(actor_id)
        if info is None or info.state == "DEAD":
            return None
        return actor_id

    def _cmd_kill_actor(self, payload):
        from ray_tpu_torch.exceptions import RayActorError

        actor_id, no_restart = payload
        ar = self.actors.get(actor_id)
        if ar is None:
            return False
        was_pending = ar.state in ("PENDING", "RESTARTING")
        if no_restart:
            ar.max_restarts = ar.num_restarts  # no more restarts
            ar.state = lifecycle.step("actor", ar.state, "DEAD")
            ar.death_cause = "ray_tpu_torch.kill"
            info = self.gcs.actors.get(actor_id)
            if info:
                info.state = lifecycle.step("actor", info.state, "DEAD")
                info.death_cause = "ray_tpu_torch.kill"
            self._release_actor_creation_pins(ar)
        if was_pending and no_restart:
            # The creation task may still be queued: drop it and fail the backlog,
            # or _on_actor_created would resurrect a killed actor.
            crec = self.tasks.get(ar.creation_req.spec.task_id)
            if crec is not None and crec.state == "PENDING":
                crec.state = lifecycle.step("task", crec.state, "CANCELLED")
            err = RayActorError("Actor was killed before creation completed.")
            for req in ar.backlog:
                rec = self.tasks.get(req.spec.task_id)
                if rec is not None:
                    self._store_error_results(rec, err)
            ar.backlog.clear()
            self._release_actor_resources(ar)
        if ar.worker is not None:
            node = self.nodes.get(ar.node)
            wh = node.workers.get(ar.worker) if node else None
            if wh is not None:
                try:
                    wh.process.terminate()
                except Exception:
                    pass
                self._on_worker_death(wh)
        if ar.state == "DEAD":
            # Drop the name so it can be reused.
            self._drop_actor_name(actor_id)
            self._drop_detached(actor_id)
        return True

    def _cmd_register_function(self, payload):
        function_id, blob = payload
        self.gcs.function_table[function_id] = blob
        return True

    def _cmd_kv(self, payload):
        op, args = payload
        if (
            self.obs is not None
            and op == "put"
            and args
            and args[0][:9] == b"metrics::"
        ):
            # Every per-process registry flush already lands here — folding
            # it into the time-series store makes history free of extra
            # protocol traffic (the ingestion cadence IS the flush cadence).
            self.obs.ingest_kv(args[0], args[1])
        if (
            self.jobs is not None
            and op == "event"
            and args
            and args[0]
            and args[0][0] == "serve_deploy"
        ):
            # The controller's deploy event carries the app -> owning-job
            # mapping (the deploy ran as the calling driver's actor task, so
            # the controller knew the job); proxy request counters re-key
            # through it at snapshot-ingest time.
            data = args[0][4] or {}
            if data.get("app") and data.get("job"):
                self.jobs.register_serve_app(data["app"], data["job"])
        return getattr(self.gcs, "kv_" + op)(*args)

    def _cmd_create_pg(self, payload):
        pg: PGRecord = payload
        self.pgs[pg.pg_id] = pg
        self.pending_pgs.append(pg)
        return True

    def _cmd_pg_ready(self, payload):
        pg_id, fut = payload
        pg = self.pgs.get(pg_id)
        if pg is None:
            fut.set_exception(ValueError("no such placement group"))
            return _ASYNC
        if pg.state == "CREATED":
            fut.set_result(True)
        else:
            pg.ready_futures.append(fut)
        return _ASYNC

    def _cmd_remove_pg(self, pg_id: PlacementGroupID):
        pg = self.pgs.pop(pg_id, None)
        if pg is None:
            return False
        if pg in self.pending_pgs:
            self.pending_pgs.remove(pg)
        for b in pg.bundles:
            if b.node is not None:
                node = self.nodes.get(b.node)
                if node is not None:
                    # Return only what the bundle still holds unused.
                    _release(node.available, b.available)
        pg.state = lifecycle.step("placement_group", pg.state, "REMOVED")
        return True

    def _cmd_cancel(self, payload):
        task_id, force = payload
        from ray_tpu_torch.exceptions import TaskCancelledError

        rec = self.tasks.get(task_id)
        if rec is None:
            return False

        def note_cancelled():
            # Label the terminal "cancelled" ahead of the error seal (whose
            # own hook says "failed"); ledger pop-idempotency gives the
            # first caller precedence.
            if self.jobs is not None:
                self.jobs.task_terminal(task_id, "cancelled", time.time())

        if rec.state == "PENDING":
            self.pending.remove(rec)
            note_cancelled()
            self._store_error_results(rec, TaskCancelledError("Task was cancelled."))
            rec.state = lifecycle.step("task", rec.state, "CANCELLED")
            return True
        if rec.state == "RUNNING" and rec.spec.actor_id is None:
            # Pipelined-but-not-started (queued behind a leased worker's
            # current task): cancel cleanly without touching the worker's
            # running task — tell the worker to skip it when popped.
            node = self.nodes.get(rec.node)
            wh = node.workers.get(rec.worker) if node else None
            if (
                wh is not None
                and wh.current_task != task_id
                and task_id in wh.inflight_tasks
            ):
                wh.inflight_tasks.remove(task_id)
                self._send_to(wh, ("cancel_queued", task_id.binary()))
                note_cancelled()
                self._store_error_results(rec, TaskCancelledError("Task was cancelled."))
                rec.state = lifecycle.step("task", rec.state, "CANCELLED")
                return True
        if rec.state == "RUNNING" and force and rec.spec.actor_id is None:
            node = self.nodes.get(rec.node)
            wh = node.workers.get(rec.worker) if node else None
            if wh is not None:
                rec.retries_left = 0
                try:
                    wh.process.terminate()
                except Exception:
                    pass
                note_cancelled()
                self._release_task_resources(rec)
                self._store_error_results(rec, TaskCancelledError("Task was cancelled."))
                rec.state = lifecycle.step("task", rec.state, "CANCELLED")
                # Death handler will see FAILED results already sealed.
                self.tasks.pop(task_id, None)
                self._on_worker_death(wh)
                self.tasks[task_id] = rec
            return True
        return False

    def _cmd_task_events(self, _):
        return self.gcs.task_event_list()

    def _cmd_task_latency(self, _):
        """p50/p95 queue-wait + exec rollups computed over the event ring IN
        the scheduler process: summarize()/the dashboard poll this, and
        shipping up to ring-cap TaskEvents per poll just to reduce them to
        two percentile dicts would stall the loop on serialization."""
        queue_waits: List[float] = []
        exec_times: List[float] = []
        for (_tid, _name, st, _ts, stages) in self.gcs.task_events:
            if st not in ("FINISHED", "FAILED") or not stages:
                continue
            q0, q1 = stages.get("queued"), stages.get("lease_granted")
            if q0 is not None and q1 is not None:
                queue_waits.append(max(0.0, q1 - q0))
            e0, e1 = stages.get("exec_start"), stages.get("exec_end")
            if e0 is not None and e1 is not None:
                exec_times.append(max(0.0, e1 - e0))
        out = {}
        for key, vals in (("queue_wait_s", queue_waits), ("exec_s", exec_times)):
            if vals:
                vals.sort()
                n = len(vals)
                out[key] = {
                    "p50": vals[n // 2],
                    "p95": vals[min(n - 1, int(n * 0.95))],
                    "max": vals[-1],
                    "samples": n,
                }
        return out

    @staticmethod
    def _task_summary(rec: TaskRecord) -> dict:
        return {
            "task_id": rec.spec.task_id.hex(),
            "job_id": rec.spec.task_id.actor_id.job_id.hex(),
            "name": rec.spec.name or rec.spec.func.name,
            "state": rec.state,
            "actor_id": rec.spec.actor_id.hex() if rec.spec.actor_id else None,
            "node_id": rec.node.hex() if rec.node else None,
            "retries_left": rec.retries_left,
            "submitted_at": rec.submitted_at,
            "stages": {
                "submit": getattr(rec.spec, "submitted_ts", rec.submitted_at),
                **rec.stage_ts,
            },
        }

    def _cmd_list_tasks(self, payload):
        # Payload: None = defaults; int = limit (legacy shape); dict =
        # {"limit", "job"} (job: hex filter on the embedded job id).
        job = None
        if isinstance(payload, dict):
            job = payload.get("job")
            payload = payload.get("limit")
        # None = default; 0 is a real limit (the dashboard accepts ?limit=0)
        # and must return nothing, not fall back to 1000.
        limit = 1000 if payload is None else int(payload)
        if limit <= 0:
            return []
        if job is not None:
            # Filter BEFORE the tail slice: a limit'd listing of one job
            # must not be hollowed out by other jobs' newer records.
            live = [
                rec for rec in self.tasks.values()
                if rec.spec.task_id.actor_id.job_id.hex() == job
            ][-limit:]
            out = [self._task_summary(rec) for rec in live]
            if len(out) < limit:
                need = limit - len(out)
                out = [
                    dict(s) for s in list(self._gc_task_summaries)
                    if s.get("job_id") == job
                ][-need:] + out
            return out
        # Live records keep dict insertion (submission) order; only the tail
        # slices materialize. GC'd history (older by construction) fills any
        # remaining budget in front.
        live = list(self.tasks.values())[-limit:]
        out = [self._task_summary(rec) for rec in live]
        if len(out) < limit:
            need = limit - len(out)
            out = [dict(s) for s in list(self._gc_task_summaries)[-need:]] + out
        return out

    def _cmd_autoscaler_state(self, _):
        """Demand + supply snapshot for the autoscaler (the analogue of the
        GCS monitor endpoint the reference autoscaler polls,
        `gcs/gcs_server/gcs_monitor_server.h` / `load_metrics.py`)."""
        now = time.time()
        pending = [dict(rec.spec.resources) for rec in self.pending.records() if rec.state == "PENDING"]
        pending_bundles = [
            dict(b.resources)
            for pg in self.pending_pgs
            for b in pg.bundles
            if b.node is None
        ]
        nodes = []
        for n in self.nodes.values():
            busy = sum(1 for w in n.workers.values() if w.state in ("busy", "blocked"))
            actors = sum(1 for w in n.workers.values() if w.actor_id is not None)
            # The idle clock starts when the node last held work: actors,
            # busy workers or reserved resources (a placement group's
            # bundle). Dispatch alone would date it from the last task or
            # actor start, and a node whose long-lived actor just exited
            # would read idle for that actor's whole life.
            if busy or actors or any(n.available.get(k, 0.0) < v - 1e-9
                                     for k, v in n.resources.items()):
                n.last_active = now
            nodes.append(
                {
                    "node_id": n.node_id.hex(),
                    "resources": dict(n.resources),
                    "available": dict(n.available),
                    "labels": dict(n.labels),
                    "alive": n.alive,
                    "busy_workers": busy,
                    "actors": actors,
                    "idle_s": max(0.0, now - n.last_active),
                    "is_daemon": n.daemon is not None,
                }
            )
        return {
            "pending_tasks": pending,
            "pending_bundles": pending_bundles,
            "nodes": nodes,
        }

    def _cmd_list_objects(self, payload):
        limit = 1000 if payload is None else int(payload)
        if limit <= 0:
            return []
        out = []
        for key, meta in list(self.object_table.items())[-limit:]:
            out.append(
                {
                    "object_id": meta.object_id.hex(),
                    "size": meta.size,
                    "in_shm": meta.segment is not None,
                    "node_id": meta.node_id.hex() if meta.node_id else None,
                    "holders": sorted(self.holders.get(key, ())),
                    "pins": self.pins.get(key, 0),
                    "is_error": meta.is_error,
                }
            )
        return out

    # How many per-object rows memory_summary ships (aggregates always cover
    # the WHOLE table; only the detailed listing truncates, largest-first).
    _MEMORY_SUMMARY_TOP = 200

    def _cmd_memory_summary(self, payload=None):
        """`ray memory` analogue over the ownership tables: every object's
        holders/pins/location/size joined with the on-disk store state,
        grouped by creation site, with leak suspects. Payload: optional
        {"job": hex} narrows the detailed object listing to one tenant
        (aggregates stay cluster-wide; `by_job` is the per-tenant rollup).

        Two leak classes:
         - table-level: objects whose every holder is a dead process and
           that no live task pins (reached via a holder/pin/containment
           mark-sweep from the live-process roots) — the "owner died with
           borrowed refs outstanding" case;
         - bytes-level (store scan, introspection.scan_store_dir): segment
           files no live meta references — e.g. results a worker stored
           right before crashing, whose done message never arrived.
        """
        from ray_tpu_torch._private import introspection

        live_holders = {self._INPROC_DRIVER}
        live_holders.update(self._workers_by_id)
        live_holders.update(dh.holder_id for dh in self._conn_to_driver.values())

        # Mark: objects directly held by a live process, or pinned as a
        # dependency of a task whose pins are still held.
        reachable: set = set()
        for key, hs in self.holders.items():
            for h in hs:
                # Interim "gen:<task>" holders are the scheduler's own and
                # are swept with their stream: treat as live roots.
                if h in live_holders or h.startswith("gen:"):
                    reachable.add(key)
                    break
        for rec in self.tasks.values():
            if not rec.pins_released:
                reachable.update(rec.dep_ids)
        # Sweep containment: a reachable container keeps its children alive.
        stack = list(reachable)
        while stack:
            k = stack.pop()
            for child in self.contained_pins.get(k, ()):
                if child not in reachable:
                    reachable.add(child)
                    stack.append(child)

        job_filter = payload.get("job") if isinstance(payload, dict) else None
        objects = []
        shm_bytes = inline_bytes = spilled_bytes = 0
        by_site: Dict[str, Dict[str, float]] = {}
        by_job: Dict[str, Dict[str, float]] = {}
        known_segments: set = set()
        known_oids: set = set()
        for key, meta in self.object_table.items():
            if meta.segment and meta.owns_payload:
                if meta.spilled:
                    spilled_bytes += meta.size
                else:
                    shm_bytes += meta.size
            elif meta.segment is None:
                inline_bytes += meta.size
            if meta.segment:
                known_segments.add(os.path.basename(meta.segment))
            known_oids.add(meta.object_id.hex())
            rec = self.tasks.get(meta.object_id.task_id)
            site = (
                rec.spec.name or rec.spec.func.name
                if rec is not None else "(driver put / GC'd task)"
            )
            agg = by_site.setdefault(site, {"count": 0, "bytes": 0})
            agg["count"] += 1
            agg["bytes"] += meta.size
            job = meta.object_id.task_id.actor_id.job_id.hex()
            jagg = by_job.setdefault(job, {"count": 0, "bytes": 0})
            jagg["count"] += 1
            jagg["bytes"] += meta.size
            if job_filter is not None and job != job_filter:
                continue
            objects.append(
                {
                    "object_id": meta.object_id.hex(),
                    "job_id": job,
                    "size": meta.size,
                    "in_shm": meta.segment is not None,
                    "spilled": meta.spilled,
                    "node_id": meta.node_id.hex() if meta.node_id else None,
                    "holders": sorted(self.holders.get(key, ())),
                    "pins": self.pins.get(key, 0),
                    "is_error": meta.is_error,
                    "site": site,
                    "leak_suspect": key not in reachable,
                }
            )
        objects.sort(key=lambda o: o["size"], reverse=True)
        leak_suspects = [o for o in objects if o["leak_suspect"]]
        top_sites = dict(
            sorted(by_site.items(), key=lambda kv: kv[1]["bytes"],
                   reverse=True)[:20]
        )
        # On-disk join for the head's store dir (every non-daemon node
        # shares it). Daemon nodes' bytes are covered by node_usage; their
        # file-level scan would need a daemon round trip — out of scope.
        scan = introspection.scan_store_dir(
            os.path.join(self.session_dir, "shm"), known_segments, known_oids
        )
        return {
            "num_objects": len(self.object_table),
            "objects": objects[: self._MEMORY_SUMMARY_TOP],
            "by_site": top_sites,
            "by_job": by_job,
            "shm_bytes": shm_bytes,
            "inline_bytes": inline_bytes,
            "spilled_bytes": spilled_bytes,
            # The value ray_tpu_object_store_bytes reports; shm_bytes is the
            # per-object reconstruction of the same quantity — the two must
            # agree (the acceptance bar is >= 95%).
            "gauge_bytes": float(sum(self.node_usage.values())),
            "node_usage": {
                nid.hex(): usage for nid, usage in self.node_usage.items()
            },
            "leak_suspects": leak_suspects,
            "store_scan": scan,
        }

    def _cmd_list_actors(self, payload=None):
        job = payload.get("job") if isinstance(payload, dict) else None
        out = []
        for a in self.gcs.actors.values():
            if job is not None and a.actor_id.job_id.hex() != job:
                continue
            ar = self.actors.get(a.actor_id)
            out.append({
                "actor_id": a.actor_id.hex(),
                "job_id": a.actor_id.job_id.hex(),
                "name": a.name,
                "class_name": a.class_name,
                "state": a.state,
                "num_restarts": a.num_restarts,
                # What the actor holds while it lives (its GPU share among
                # them) and the device ids its CUDA_VISIBLE_DEVICES names.
                "resources": dict(ar.acquired) if ar is not None else {},
                "gpu_ids": list(ar.gpu_ids) if ar is not None else [],
            })
        return out

    # ------------------------------------------------------------------ worker requests
    def _req_submit(self, wh: WorkerHandle, req_id: int, payload):
        rec: TaskRecord = payload
        rec.owner = self._holder_of(wh)
        if rec.func_blob is not None:
            self.gcs.function_table.setdefault(rec.spec.func.function_id, rec.func_blob)
        self._register_return_holders(rec.return_ids, self._holder_of(wh))
        if rec.spec.returns_mode is not None:
            rec.stream_owner = self._holder_of(wh)
        self._register_task(rec)
        self._respond(wh, req_id, True, True)

    def _req_submit_actor_task(self, wh: WorkerHandle, req_id: int, payload):
        req: ExecRequest = payload
        self._register_return_holders(req.return_ids, self._holder_of(wh))
        self._submit_actor_task(req, owner=self._holder_of(wh))
        self._respond(wh, req_id, True, True)

    def _req_put_meta(self, wh: WorkerHandle, req_id: int, meta: ObjectMeta):
        err = self._check_capacity(meta)
        if err is not None and not self._try_spill_new(meta):
            self._respond(wh, req_id, False, err)
            return
        self._add_holder(meta.object_id.binary(), self._holder_of(wh))
        self._seal_object(meta)
        # A spilled meta was relocated: hand the owner its current location
        # (the owner-side table would otherwise point at an unlinked file).
        self._respond(wh, req_id, True, meta if meta.spilled else True)

    def _req_get_metas(self, wh: WorkerHandle, req_id: int, ids: List[bytes]):
        self._mark_blocked(wh)

        def done(metas):
            self._unmark_blocked(wh)
            self._respond(wh, req_id, True, metas)

        fut = concurrent.futures.Future()
        fut.add_done_callback(lambda f: done(f.result()))
        self._async_get_metas(ids, fut)

    def _req_peek_metas(self, wh: WorkerHandle, req_id: int, ids: List[bytes]):
        self._respond(wh, req_id, True, self._cmd_peek_metas(ids))

    def _req_wait(self, wh: WorkerHandle, req_id: int, payload):
        ids, num_returns = payload
        self._mark_blocked(wh)

        def done(result):
            self._unmark_blocked(wh)
            self._respond(wh, req_id, True, result)

        fut = concurrent.futures.Future()
        fut.add_done_callback(lambda f: done(f.result()))
        self._async_wait(ids, num_returns, fut)

    def _req_fetch_function(self, wh: WorkerHandle, req_id: int, function_id: str):
        blob = self.gcs.function_table.get(function_id)
        if blob is None:
            self._respond(wh, req_id, False, KeyError(f"unknown function {function_id}"))
        else:
            wh.known_functions.add(function_id)
            self._respond(wh, req_id, True, blob)

    def _req_create_actor(self, wh: WorkerHandle, req_id: int, payload):
        self._cmd_create_actor(payload, holder=self._holder_of(wh))
        self._respond(wh, req_id, True, True)

    def _req_get_actor_by_name(self, wh: WorkerHandle, req_id: int, name: str):
        self._respond(wh, req_id, True, self._cmd_get_actor_by_name(name))

    def _req_kv(self, wh: WorkerHandle, req_id: int, payload):
        self._respond(wh, req_id, True, self._cmd_kv(payload))

    def _req_kill_actor(self, wh: WorkerHandle, req_id: int, payload):
        self._respond(wh, req_id, True, self._cmd_kill_actor(payload))

    def _req_create_pg(self, wh: WorkerHandle, req_id: int, payload):
        self._respond(wh, req_id, True, self._cmd_create_pg(payload))

    def _req_remove_pg(self, wh: WorkerHandle, req_id: int, pg_id):
        # A worker that made a placement group removes it (a Trainer run as
        # a Tune trial removes its gang's when it ends).
        self._respond(wh, req_id, True, self._cmd_remove_pg(pg_id))

    def _req_pg_ready(self, wh: WorkerHandle, req_id: int, pg_id):
        self._mark_blocked(wh)

        def done(result):
            self._unmark_blocked(wh)
            self._respond(wh, req_id, True, result)

        fut = concurrent.futures.Future()
        fut.add_done_callback(lambda f: done(f.result()))
        self._cmd_pg_ready((pg_id, fut))

    def _req_available_resources(self, wh: WorkerHandle, req_id: int, _):
        self._respond(wh, req_id, True, self._cmd_available_resources(None))

    def _req_cluster_resources(self, wh: WorkerHandle, req_id: int, _):
        self._respond(wh, req_id, True, self._cmd_cluster_resources(None))

    # Simple synchronous commands a client-mode driver may invoke over its
    # connection (the in-process driver calls _cmd_* directly).
    _DRIVER_CMDS = frozenset(
        {
            "free", "register_function", "remove_pg", "cancel", "task_events",
            "task_latency", "list_actors", "list_tasks", "list_objects",
            "get_nodes", "add_node", "remove_node", "autoscaler_state",
            "memory_summary", "transfer_stats", "serve_directory",
            "serve_actor_inflight", "query_series", "cluster_events",
            "list_alerts", "obs_stats", "spans_list", "list_jobs",
            "job_report",
        }
    )

    def _req_driver_cmd(self, wh, req_id: int, payload):
        name, arg = payload
        if name not in self._DRIVER_CMDS:
            self._respond(wh, req_id, False, ValueError(f"not a driver command: {name}"))
            return
        self._respond(wh, req_id, True, getattr(self, "_cmd_" + name)(arg))

    # ------------------------------------------------------------------ object pulls
    def _locate_object(self, object_key: bytes):
        """(meta, [(node_id, data_address), ...]): where an object's bytes
        live — the owner first, then replica nodes holding a pulled copy.
        Readers dial an address and stream the bytes PEER-DIRECT
        (object_transfer.py; reference: the object directory feeding
        peer-to-peer chunk transfer, `ownership_based_object_directory.h` +
        `object_manager.cc`). An address of None means that holder has no
        data server and only the head relay can serve it."""
        meta = self.object_table.get(object_key)
        if meta is None:
            raise KeyError("object not sealed")
        locations: List[Tuple[bytes, Optional[str]]] = []
        if meta.segment is not None and meta.node_id:
            node = self.nodes.get(NodeID(meta.node_id))
            if node is not None and node.alive:
                locations.append((meta.node_id, node.data_address))
            for nid in self.object_replicas.get(object_key, ()):
                if nid == meta.node_id:
                    continue
                rnode = self.nodes.get(NodeID(nid))
                if rnode is not None and rnode.alive and rnode.data_address:
                    locations.append((nid, rnode.data_address))
        return meta, locations

    def _cmd_locate_object(self, object_key: bytes):
        return self._locate_object(object_key)

    @loop_thread_only
    def _on_locate_object(self, handle, token: int, keys: List[bytes]) -> None:
        """Answer a batched ("locate_object", token, keys) directory query;
        the reply coalesces with whatever else this loop iteration sends."""
        out = {}
        for key in keys:
            try:
                out[key] = self._locate_object(key)
            except KeyError:
                pass  # unsealed/freed: absent from the reply
        self._send_to(handle, ("object_locations", token, out))

    def _cmd_object_replica(self, payload):
        """A puller cached an object's bytes in its node's store: register the
        node as a replica so later locates offer it as an alternate source
        (and mid-stream owner death has somewhere to fail over to)."""
        object_key, node_id = payload
        if not node_id:
            return False
        meta = self.object_table.get(object_key)
        if meta is None:
            # Freed before this (async) registration arrived: the puller's
            # cache file is already an orphan _purge_replicas will never
            # see — delete it now instead of leaking node shm.
            node = self.nodes.get(NodeID(node_id))
            if node is not None:
                self._delete_replica_file(node, object_key.hex())
            return False
        if node_id == meta.node_id:
            return False
        node = self.nodes.get(NodeID(node_id))
        if node is None or not node.alive:
            return False  # node gone: its store (and the file) died with it
        # Register even when the holder can't SERVE peers (no data server,
        # e.g. the head's push listener failed to start): the entry is what
        # lets _purge_replicas delete the cache file on free — skipping it
        # leaks the bytes for the session. _locate_object re-checks
        # data_address before offering the node as a pull source.
        fresh = node_id not in self.object_replicas.get(object_key, ())
        self.object_replicas.setdefault(object_key, set()).add(node_id)
        if self.jobs is not None and fresh:
            # Peer-direct pull completed (the replica registration is its
            # only head-visible trace): meta.size bytes moved for the
            # owning job.
            self.jobs.transfer_bytes(meta.object_id, meta.size or 0)
        return True

    def _req_object_replica(self, wh, req_id: Optional[int], payload):
        # Rides the one-way "cmd" path from workers/client drivers.
        self._respond(wh, req_id, True, self._cmd_object_replica(payload))

    def _purge_replicas(self, object_key: bytes, meta: ObjectMeta) -> None:
        """The object was freed: delete its cached copies everywhere (the
        owner's segment goes through _delete_segment; replicas are plain
        cache files named by object id in each holder node's store dir)."""
        nodes = self.object_replicas.pop(object_key, None)
        if not nodes:
            return
        cache_name = meta.object_id.hex()
        for nid in nodes:
            node = self.nodes.get(NodeID(nid))
            if node is not None:
                self._delete_replica_file(node, cache_name)

    def _delete_replica_file(self, node: "NodeState", cache_name: str) -> None:
        path = os.path.join(node.shm_dir, cache_name)
        if node.daemon is not None:
            self._send_to(node.daemon, ("delete_object", path))
        else:
            try:
                os.unlink(path)
            except OSError:
                pass

    def _drop_node_replicas(self, node_id: bytes) -> None:
        """A node died: its cached copies are gone — stop offering them."""
        for key in [k for k, s in self.object_replicas.items() if node_id in s]:
            s = self.object_replicas[key]
            s.discard(node_id)
            if not s:
                del self.object_replicas[key]

    # --------------------------------------------------- observability queries
    def _cmd_spans_push(self, payload):
        """Append one process's trace-span flush batch to the GCS ring —
        O(new spans) per flush; the ring bound (`trace_spans_cap`) is the
        retention policy. Always accepted: the SENDER is gated by the
        tracing knob (a disabled runtime never flushes), so an empty-ring
        head costs nothing."""
        return self.gcs.append_trace_spans(payload or ())

    def _req_spans_push(self, wh, req_id: Optional[int], payload):
        # Rides the one-way "cmd" path from workers/client drivers.
        self._respond(wh, req_id, True, self._cmd_spans_push(payload))

    def _cmd_spans_list(self, payload):
        """Trace-span readout (tracing.collect_spans / state.list_traces /
        /api/traces / CLI). payload: optional {trace_id, since, limit}."""
        p = dict(payload or {})
        return self.gcs.trace_span_list(
            trace_id=p.get("trace_id"), since=p.get("since"),
            limit=p.get("limit"),
        )

    def _cmd_query_series(self, payload):
        """Time-series readout (state.query_series / /api/series / CLI).
        Raises when the obs layer is off — a silent empty answer would read
        as "no traffic", which is the opposite of the truth."""
        if self.obs is None:
            raise RuntimeError(
                "time-series store disabled "
                "(enable_metrics=False or enable_obs=False)"
            )
        return self.obs.query(payload)

    def _cmd_cluster_events(self, payload):
        """Cluster event log (state.list_cluster_events / /api/events / CLI).
        Served from the GCS ring regardless of the metrics knob: restored
        history from --persist stays readable even in a metrics-off boot."""
        return self.gcs.cluster_event_list(**(payload or {}))

    def _cmd_list_alerts(self, _):
        if self.obs is None:
            return []
        return self.obs.engine.payload()

    def _cmd_obs_stats(self, _):
        if self.obs is None:
            return {"enabled": False}
        out = self.obs.stats()
        out["enabled"] = True
        return out

    def _cmd_transfer_stats(self, _):
        """Data-plane introspection: cumulative relay/locality counters (the
        zero-head-bytes contract is `relay_pulls == 0` for peer-served
        workloads) plus the head's own transfer-manager totals."""
        from ray_tpu_torch._private import object_transfer

        out = dict(self._transfer_stats)
        out["replica_entries"] = sum(
            len(s) for s in self.object_replicas.values()
        )
        out["head_transfer"] = dict(object_transfer._STATS)
        if self.jobs is not None:
            # Per-tenant attribution of the same traffic (job hex -> bytes).
            out["per_job_bytes"] = self.jobs.transfer_rollup()
        return out

    def _cmd_list_jobs(self, _):
        """Tenant ledger readout (state.list_jobs / /api/jobs / CLI). Raises
        when accounting is off — same contract as _cmd_query_series: a
        silent empty answer would read as "nobody is using the cluster"."""
        if self.jobs is None:
            raise RuntimeError(
                "job accounting disabled "
                "(enable_metrics=False or enable_obs=False)"
            )
        return self.jobs.list_jobs()

    def _cmd_job_report(self, job):
        if self.jobs is None:
            raise RuntimeError(
                "job accounting disabled "
                "(enable_metrics=False or enable_obs=False)"
            )
        return self.jobs.job_report(str(job))

    def _req_pull_object(self, wh, req_id: int, object_key: bytes):
        """A reader is missing a sealed object's segment locally and could not
        (or may not) pull it peer-direct: relay the bytes from whichever node
        (daemon or client driver) holds them. Since the peer-to-peer data
        plane (object_transfer.py) this is the FALLBACK route — owners
        without a data server (client drivers), dead peer links, and
        peer-transfer-disabled runs."""

        def respond(ok: bool, payload):
            self._respond(wh, req_id, ok, payload)

        self._pull_object(object_key, respond)

    def _cmd_pull_object(self, payload):
        object_key, fut = payload

        def respond(ok: bool, result):
            if fut.done():
                return
            if ok:
                fut.set_result(result)
            else:
                fut.set_exception(result if isinstance(result, BaseException) else OSError(str(result)))

        self._pull_object(object_key, respond)
        return _ASYNC

    def _pull_object(self, object_key: bytes, respond: Callable[[bool, Any], None]):
        meta = self.object_table.get(object_key)
        if meta is None:
            respond(False, KeyError("object is not sealed in the object table"))
            return
        if meta.segment is None:
            respond(True, (meta, None))
            return
        source = self._pull_sources.get(meta.node_id or b"")
        if source is not None and self.config.disable_pull_relay:
            # Test/ops guard: when the owner HAS a data server, cross-node
            # bytes must ride the peer-direct plane; a relay request means
            # that path failed. Owners without one (client drivers) have no
            # alternative — the relay stays allowed for them.
            owner = self.nodes.get(NodeID(meta.node_id)) if meta.node_id else None
            if owner is not None and owner.data_address:
                respond(False, RuntimeError(
                    "head relay is disabled (disable_pull_relay); peer-direct "
                    "pull from the owning daemon failed or was bypassed"
                ))
                return
        if source is None:
            # Head-local: virtual nodes and the head node share the head's
            # shm dir, so the segment is directly readable here. The transfer
            # manager's coalescing read pool does it off-thread (a multi-GB
            # read must not stall the scheduling loop) and folds concurrent
            # pulls of the same key into ONE read — the old ad-hoc
            # "pull-read" thread per request did neither. Responders are
            # @any_thread by construction (_respond / future settles).
            self._transfer_stats["local_reads"] += 1
            self._transfer.read_local(meta, respond)
            return
        # Remote relay: coalesce concurrent pulls of one key into a single
        # read_object round trip; every waiter shares the reply.
        waiters = self._relay_waiters.get(object_key)
        if waiters is not None:
            waiters.append(respond)
            return
        self._relay_waiters[object_key] = [respond]
        self._transfer_stats["relay_pulls"] += 1
        self._pull_token += 1
        token = self._pull_token
        self._pending_pulls[token] = (object_key, meta)
        if session_monitor.ENABLED:
            session_monitor.expect("read_object", token)
        if not source.send(
            ("read_object", token, meta.segment, meta.arena_offset, meta.size)
        ):
            self._pending_pulls.pop(token, None)
            if session_monitor.ENABLED:
                session_monitor.forget("read_object", token)
            for r in self._relay_waiters.pop(object_key, []):
                r(False, ConnectionError("object source node is unreachable"))

    def _finish_pull(self, token: int, ok: bool, data):
        if session_monitor.ENABLED:
            session_monitor.resolve("object_data", token)
        ent = self._pending_pulls.pop(token, None)
        if ent is None:
            return
        key, meta = ent
        waiters = self._relay_waiters.pop(key, [])
        if ok:
            self._transfer_stats["relay_bytes"] += len(data) if data else 0
            if self.jobs is not None and data:
                self.jobs.transfer_bytes(meta.object_id, len(data))
            for respond in waiters:
                respond(True, (meta, data))
        else:
            for respond in waiters:
                respond(False, OSError(f"remote segment read failed: {data}"))

    # ------------------------------------------------------------------ introspection
    # Cluster-wide "what is every process doing RIGHT NOW" (the `ray stack` /
    # per-worker profiling surface): the loop thread broadcasts
    # dump_stacks/profile_stop with per-target tokens, replies fill an
    # _Introspection, and the loop's deadline tick escalates silent workers
    # to the out-of-band SIGUSR1 faulthandler path (daemon-relayed for
    # remote workers, a helper thread for head-local ones) before marking
    # the rest "unavailable: <reason>".

    # Extra window after the in-band deadline for the SIGUSR1 dump + tail.
    _OOB_WINDOW_S = 1.5

    def _introspect_targets(self) -> List[tuple]:
        """(key, handle, descriptor) for every connected peer process."""
        out: List[tuple] = []
        for wh in self._workers_by_id.values():
            if wh.conn is not None:
                out.append((f"worker:{wh.worker_id.hex()}", wh, ("worker", wh)))
        for daemon in self._conn_to_daemon.values():
            out.append(
                (f"daemon:{daemon.node_id.hex()}", daemon, ("daemon", daemon))
            )
        return out

    def _introspect_token_for(self, coll: _Introspection, key: str) -> int:
        """Allocate a reply token routing back to (collection, target)."""
        self._introspect_token += 1
        self._introspect_pending[self._introspect_token] = (coll, key)
        if session_monitor.ENABLED:
            # OOB-relayed dumps still answer with the stacks_data tag, so
            # the conceptual request for monitor pairing is dump_stacks.
            session_monitor.expect(
                "dump_stacks" if coll.kind == "stacks" else "profile_stop",
                self._introspect_token,
            )
        return self._introspect_token

    def _start_stack_collection(self, respond: Callable[[dict], None],
                                timeout_s=None, targets=None) -> None:
        from ray_tpu_torch._private import introspection

        timeout_s = float(timeout_s or self.config.introspection_timeout_s)
        coll = _Introspection("stacks", respond, time.time() + timeout_s)
        if targets is None:
            # Full-cluster dump: include this (head) process directly — its
            # threads ARE the control plane (scheduler loop, acceptors,
            # driver API threads). lookup_lines=False: this runs ON the loop
            # thread, which must not do per-frame linecache file reads.
            coll.results["head"] = introspection.thread_stacks(
                extra={"role": "head"}, lookup_lines=False
            )
            targets = self._introspect_targets()
        for key, handle, desc in targets:
            coll.pending[key] = desc
            self._send_to(
                handle, ("dump_stacks", self._introspect_token_for(coll, key))
            )
        self.telemetry.stack_dump_requests += len(coll.pending)
        if coll.pending:
            self._introspections.append(coll)
        else:
            respond(coll.results)

    def _start_profile_collection(self, respond: Callable[[dict], None]) -> None:
        from ray_tpu_torch._private import profiler

        timeout_s = float(self.config.introspection_timeout_s)
        coll = _Introspection("profile", respond, time.time() + timeout_s)
        coll.results["head"] = profiler.stop()
        for key, handle, desc in self._introspect_targets():
            coll.pending[key] = desc
            self._send_to(
                handle, ("profile_stop", self._introspect_token_for(coll, key))
            )
        if coll.pending:
            self._introspections.append(coll)
        else:
            respond(coll.results)

    @loop_thread_only
    def _on_introspect_reply(self, token: int, payload) -> None:
        ent = self._introspect_pending.pop(token, None)
        if ent is None:
            return  # late reply for a finished/abandoned collection
        coll, key = ent
        if key not in coll.pending:
            return  # already resolved (e.g. in-band answer beat the OOB one)
        del coll.pending[key]
        coll.results[key] = payload
        if coll.kind == "stacks":
            transport = (
                payload.get("transport", "inband")
                if isinstance(payload, dict) else "inband"
            )
            if transport == "oob":
                self.telemetry.stack_dumps_oob += 1
            elif transport == "unavailable":
                self.telemetry.stack_dumps_unavailable += 1
            else:
                self.telemetry.stack_dumps_inband += 1
        self._maybe_finish_introspection(coll)

    def _maybe_finish_introspection(self, coll: _Introspection) -> None:
        if coll.pending:
            return
        if coll in self._introspections:
            self._introspections.remove(coll)
        # GC tokens still pointing here (e.g. the in-band token of a worker
        # that was answered out-of-band).
        stale = [t for t, (c, _k) in self._introspect_pending.items() if c is coll]
        for t in stale:
            del self._introspect_pending[t]
            if session_monitor.ENABLED:
                session_monitor.forget(
                    "dump_stacks" if coll.kind == "stacks" else "profile_stop", t
                )
        try:
            coll.respond(coll.results)
        except Exception:  # noqa: BLE001 — a dead requester must not kill the loop
            pass

    @loop_thread_only
    def _tick_introspection(self, now: float) -> None:
        for coll in list(self._introspections):
            if now < coll.deadline:
                continue
            if coll.kind == "stacks" and not coll.oob_fired:
                # In-band deadline passed: escalate silent WORKERS to the
                # SIGUSR1 faulthandler path (a wedged interpreter can't run
                # its reader thread, but faulthandler's C handler still
                # dumps). Daemons have no out-of-band channel — they go
                # straight to "unavailable" below if the window lapses too.
                coll.oob_fired = True
                fired = False
                for key, desc in list(coll.pending.items()):
                    fired = self._fire_oob_dump(coll, key, desc) or fired
                if fired:
                    coll.deadline = now + self._OOB_WINDOW_S
                    continue
            for key in list(coll.pending):
                del coll.pending[key]
                coll.results[key] = {
                    "transport": "unavailable",
                    "error": "no reply before the introspection deadline "
                             "(process wedged, stopped, or gone)",
                }
                if coll.kind == "stacks":
                    self.telemetry.stack_dumps_unavailable += 1
            self._maybe_finish_introspection(coll)

    def _fire_oob_dump(self, coll: _Introspection, key: str, desc) -> bool:
        kind, obj = desc
        if kind != "worker":
            return False
        wh: WorkerHandle = obj
        node = self.nodes.get(wh.node_id)
        if node is None:
            return False
        if node.daemon is not None:
            # Remote worker: the daemon owns the pid and the shared stack
            # file — it signals and tails back.
            self._send_to(
                node.daemon,
                (
                    "dump_worker_oob",
                    self._introspect_token_for(coll, key),
                    wh.worker_id.hex(),
                ),
            )
            return True
        # Head-local worker: signal + tail on a helper thread (the settle
        # wait must not stall the loop); the result re-enters through the
        # command queue like any off-thread event.
        from ray_tpu_torch._private import introspection

        token = self._introspect_token_for(coll, key)
        pid = wh.process.pid
        path = introspection.stack_file_path(node.shm_dir, wh.worker_id.hex())

        def _dump():
            payload = introspection.oob_dump_worker(pid, path)
            payload["worker_id"] = wh.worker_id.hex()
            try:
                self.call_nowait("stacks_oob_result", (token, payload))
            except RuntimeError:
                pass  # scheduler stopped
        threading.Thread(target=_dump, daemon=True, name="oob-dump").start()
        return True

    def _cmd_stacks_oob_result(self, payload):
        token, data = payload
        self._on_introspect_reply(token, data)

    def _store_node_flight_recorder(self, node: NodeState, fr: dict) -> None:
        """A node's flight-recorder capture resolved — possibly AFTER the
        node was declared DEAD and postmortem'd (a short grace can lapse
        while the capture window is still open). The dump must land on the
        postmortem entry too, or the placeholder hides a capture we have."""
        node.flight_recorder = fr
        node_hex = node.node_id.hex()
        for p in self._node_postmortems:
            if p["node_id"] == node_hex:
                p["flight_recorder"] = fr

    def _capture_flight_recorder(self, key: str, handle, desc,
                                 store: Callable[[dict], None]) -> None:
        """SUSPECT-transition hook: single-target stack collection whose
        result lands on the worker/node entry instead of a caller."""
        def respond(results: dict) -> None:
            store({
                "trigger": "SUSPECT",
                "captured_at": time.time(),
                "dump": results.get(key),
            })

        self._start_stack_collection(
            respond,
            timeout_s=min(float(self.config.introspection_timeout_s), 3.0),
            targets=[(key, handle, desc)],
        )

    def _cmd_dump_stacks(self, payload):
        timeout_s, inner = payload
        self._start_stack_collection(inner.set_result, timeout_s)
        return _ASYNC

    def _req_dump_stacks(self, wh, req_id: int, timeout_s):
        self._start_stack_collection(
            lambda res: self._respond(wh, req_id, True, res), timeout_s
        )

    def _cmd_profile_start(self, hz):
        if not self.config.enable_profiler:
            raise RuntimeError(
                "the sampling profiler is disabled (enable_profiler=False)"
            )
        from ray_tpu_torch._private import profiler

        hz = float(hz or self.config.profiler_hz)
        profiler.start(hz)  # the head process profiles itself too
        self.telemetry.profile_sessions += 1
        for _key, handle, _desc in self._introspect_targets():
            self._send_to(handle, ("profile_start", hz))
        return True

    def _req_profile_start(self, wh, req_id: int, hz):
        self._respond(wh, req_id, True, self._cmd_profile_start(hz))

    def _cmd_profile_collect(self, inner):
        if not self.config.enable_profiler:
            raise RuntimeError(
                "the sampling profiler is disabled (enable_profiler=False)"
            )
        self._start_profile_collection(inner.set_result)
        return _ASYNC

    def _req_profile_collect(self, wh, req_id: int, _):
        if not self.config.enable_profiler:
            raise RuntimeError(
                "the sampling profiler is disabled (enable_profiler=False)"
            )
        self._start_profile_collection(
            lambda res: self._respond(wh, req_id, True, res)
        )

    # ------------------------------------------------------------------ reconstruction
    def _req_reconstruct_object(self, wh, req_id: int, object_key: bytes):
        # Release the requester's CPU while it waits (like get/wait): the
        # reconstructed task may need this very slot to run.
        self._mark_blocked(wh)

        def respond(ok: bool, payload):
            self._unmark_blocked(wh)
            self._respond(wh, req_id, ok, payload)

        self._reconstruct_object(object_key, respond)

    def _cmd_reconstruct_object(self, payload):
        object_key, fut = payload

        def respond(ok: bool, result):
            if fut.done():
                return
            if ok:
                fut.set_result(result)
            else:
                fut.set_exception(result if isinstance(result, BaseException) else OSError(str(result)))

        self._reconstruct_object(object_key, respond)
        return _ASYNC

    def _reconstruct_object(self, object_key: bytes, respond: Callable[[bool, Any], None]):
        """Lineage reconstruction: a sealed object's bytes were lost — re-execute
        the task that created it, recursively re-creating lost dependencies
        (reference: `core_worker/object_recovery_manager.h:41`,
        `task_manager.h:74 ResubmitTask`). Responds with the fresh meta once the
        object reseals (an error meta if the re-execution fails)."""
        from ray_tpu_torch.exceptions import ObjectLostError

        waiters = self._reconstructing.get(object_key)
        if waiters is not None:
            waiters.append(respond)
            return
        oid = ObjectID(object_key)
        if oid.is_put:
            respond(
                False,
                ObjectLostError(
                    f"Object {oid.hex()} was created by ray_tpu_torch.put() and its bytes "
                    "are lost; put objects have no lineage to re-execute."
                ),
            )
            return
        rec = self.tasks.get(oid.task_id)
        if rec is None:
            respond(False, ObjectLostError(f"No lineage retained for object {oid.hex()}."))
            return
        if rec.owner and rec.owner in self._dead_holders:
            from ray_tpu_torch.exceptions import OwnerDiedError

            # Owner-survives-only rule: re-executing a dead owner's task
            # would produce results whose record of truth is gone.
            respond(
                False,
                OwnerDiedError(
                    f"Object {oid.hex()} cannot be reconstructed: its owner "
                    "process died (lineage re-execution requires a live owner)."
                ),
            )
            return
        if rec.spec.actor_id is not None:
            respond(
                False,
                ObjectLostError(
                    f"Object {oid.hex()} came from an actor task; actor state makes "
                    "re-execution unsafe (matches the reference's constraint)."
                ),
            )
            return
        self._reconstructing[object_key] = [respond]
        # Retire the stale meta (segment bytes are gone).
        stale = self.object_table.pop(object_key, None)
        if stale is not None:
            self._retire_meta_accounting(stale)
        if rec.state == "PENDING" or rec.state == "RUNNING":
            return  # already (re)executing; seal will answer the waiters
        clone = TaskRecord(
            spec=rec.spec,
            arg_entries=rec.arg_entries,
            kwarg_entries=rec.kwarg_entries,
            return_ids=rec.return_ids,
            func_blob=rec.func_blob,
            retries_left=self.config.task_max_retries,
        )
        # Generator tasks: carry the stream state over, so the replayed items
        # take the reseal branch of _on_stream_item (no duplicate return-id
        # appends, no fresh gen holders on an already-consumed stream).
        clone.stream_metas = rec.stream_metas
        clone.stream_total = rec.stream_total
        clone.stream_owner = rec.stream_owner
        clone.stream_released = rec.stream_released
        # Recursively restore lost dependencies first (lineage chain). A dep
        # that cannot be reconstructed fails THIS object's waiters immediately
        # instead of leaving them to hit the pull timeout. Deps whose
        # reconstruction is already in flight get the same failure hook
        # appended to their waiter list.
        failed = {"v": False}

        def dep_result(ok: bool, payload):
            if not ok:
                failed["v"] = True
                self._fail_reconstruction(object_key, payload)

        for kind, v in list(rec.arg_entries) + list(rec.kwarg_entries.values()):
            if kind != "id" or v in self.object_table:
                continue
            if v in self._reconstructing:
                self._reconstructing[v].append(dep_result)
            else:
                self._reconstruct_object(v, dep_result)
        if failed["v"]:
            # Waiters already answered with ObjectLostError; don't register a
            # clone that would wait on a dependency that can never exist.
            return
        self._register_task(clone)

    def _fail_reconstruction(self, object_key: bytes, cause):
        waiters = self._reconstructing.pop(object_key, [])
        from ray_tpu_torch.exceptions import ObjectLostError

        err = (
            cause
            if isinstance(cause, BaseException)
            else ObjectLostError(str(cause))
        )
        for respond in waiters:
            respond(False, ObjectLostError(f"dependency unreconstructable: {err}"))

    def _mark_blocked(self, wh: WorkerHandle, kind: str = "dep"):
        """Release the CPU held by the task running on `wh` while it blocks in
        get/wait, so dependent tasks can run (prevents pool deadlock; mirrors the
        reference's resource release on blocking `ray.get`).

        kind="dep": blocked on work that may need a REPLACEMENT worker to
        make progress (get/wait/stream-consume) — excluded from the pool cap.
        kind="throttle": a generator paused by consumer backpressure — nothing
        downstream needs a new worker, and excluding it would let a wide
        throttled read fan-out spawn one replacement per paused producer
        (a worker storm, each spawn ~1s on small hosts)."""
        if wh.state == "busy" and wh.current_task is not None:
            rec = self.tasks.get(wh.current_task)
            node = self.nodes.get(wh.node_id)
            if rec is not None and node is not None and rec.acquired.get("CPU"):
                _release(node.available, {"CPU": rec.acquired["CPU"]})
                rec.acquired["CPU"] = 0.0
            # Evacuate lease-queued tasks: the head may be blocked on work
            # that sits BEHIND it in this very queue (a child pipelined while
            # the head was still running) — a self-deadlock no timeout
            # breaks. Recall everything not yet started; the class queue
            # re-places it on a live worker.
            if len(wh.inflight_tasks) > 1:
                queued, wh.inflight_tasks = wh.inflight_tasks[1:], wh.inflight_tasks[:1]
                for tid in queued:
                    self._send_to(wh, ("cancel_queued", tid.binary()))
                    qrec = self.tasks.get(tid)
                    if qrec is not None and qrec.state == "RUNNING":
                        qrec.state = lifecycle.step("task", qrec.state, "PENDING")
                        qrec.worker = None
                        qrec.node = None
                        qrec.acquired = {}
                        self.pending.push(qrec)
        if wh.state == "busy":
            wh.state = lifecycle.step("worker", wh.state, "blocked")
            wh.blocked_kind = kind

    def _unmark_blocked(self, wh: WorkerHandle):
        if wh.state == "blocked":
            wh.state = lifecycle.step("worker", wh.state, "busy")

    # ------------------------------------------------------------------ async get/wait
    def _async_get_metas(self, ids: List[bytes], fut: concurrent.futures.Future):
        missing = [i for i in ids if i not in self.object_table]
        if not missing:
            fut.set_result([self.object_table[i] for i in ids])
            return
        remaining = {"n": len(set(missing))}

        def on_ready(_meta):
            remaining["n"] -= 1
            if remaining["n"] == 0 and not fut.done():
                fut.set_result([self.object_table[i] for i in ids])

        for i in set(missing):
            self.object_waiters.setdefault(i, []).append(on_ready)

    def _async_wait(self, ids: List[bytes], num_returns: int, fut: concurrent.futures.Future):
        def ready_now():
            return [i for i in ids if i in self.object_table]

        if len(ready_now()) >= num_returns:
            fut.set_result(ready_now())
            return

        def on_ready(_meta):
            if not fut.done() and len(ready_now()) >= num_returns:
                fut.set_result(ready_now())

        for i in ids:
            if i not in self.object_table:
                self.object_waiters.setdefault(i, []).append(on_ready)

    # ------------------------------------------------------------------ task registration & scheduling
    def _register_task(self, rec: TaskRecord):
        # Re-registration (lineage reconstruction clones) replaces the record
        # under the same task id: its lineage_consumers increments are already
        # accounted (GC decrements exactly once per task id).
        fresh = rec.spec.task_id not in self.tasks
        self.tasks[rec.spec.task_id] = rec
        if rec.func_blob is not None:
            self.gcs.function_table.setdefault(rec.spec.func.function_id, rec.func_blob)
        rec.stage_ts["queued"] = time.time()
        self.telemetry.submitted += 1
        if self.jobs is not None:
            self.jobs.task_submitted(rec.spec.task_id, rec.stage_ts["queued"])
        self._record_event(rec.spec, "SUBMITTED")
        if rec.spec.actor_id is not None and not rec.spec.is_actor_creation:
            # Actor call path (should come through _submit_actor_task).
            raise ValueError("actor tasks must use submit_actor_task")
        # Pin dependencies for the task's lifetime so they cannot be freed
        # between submission and execution.
        if not rec.dep_ids:
            rec.dep_ids = [v for (k, v) in rec.arg_entries if k == "id"] + [
                v for (k, v) in rec.kwarg_entries.values() if k == "id"
            ]
        for d in rec.dep_ids:
            self._pin(d)
        # Inline arg metas may themselves contain refs (e.g. a list of refs
        # passed by value): pin those too, released with the task.
        for kind, m in list(rec.arg_entries) + list(rec.kwarg_entries.values()):
            if kind == "meta" and m.contained_ids:
                rec.dep_ids.extend(m.contained_ids)
                for child in m.contained_ids:
                    self._pin(child)
        if fresh:
            # AFTER all dep additions, so GC's per-dep decrement is symmetric.
            for d in rec.dep_ids:
                self.lineage_consumers[d] = self.lineage_consumers.get(d, 0) + 1
        # Lease fast path: a no-arg task whose dispatch class already holds a
        # pipelined lease goes straight onto that worker — the steady-state
        # submit skips the pending queue and the whole scheduling pass
        # (classes walk, dep scan, node pick). Misses take the normal path.
        if not self._fast_pipeline_dispatch(rec):
            self.pending.push(rec)

    def _fast_pipeline_dispatch(self, rec: TaskRecord) -> bool:
        spec = rec.spec
        if (
            rec.arg_entries
            or rec.kwarg_entries
            or spec.is_actor_creation
            or spec.scheduling_strategy == "SPREAD"
        ):
            return False
        depth = self.config.worker_pipeline_depth
        if depth <= 1 or not self._leases:
            return False
        # Idle workers keep dispatch priority: piling onto a busy lease while
        # an idle worker could run the task NOW would serialize it behind the
        # lease head's (possibly long) current task. The full path's
        # env-hash/eviction logic decides whether an idle worker actually
        # fits; this guard only preserves the idle-first ordering.
        for node in self.nodes.values():
            if node.alive and node.idle:
                return False
        # The dispatch itself is exactly the pipelined push (ONE copy of the
        # lease-accounting contract); this wrapper only adds the no-arg and
        # idle-first guards that make it safe to run at submit time.
        return self._try_pipeline(rec, [], {})

    def _submit_actor_task(self, req: ExecRequest, owner: Optional[str] = None):
        from ray_tpu_torch.exceptions import RayActorError

        spec = req.spec
        rec = TaskRecord(
            spec=spec,
            arg_entries=[],
            kwarg_entries={},
            return_ids=list(req.return_ids),
            func_blob=None,
        )
        rec.owner = owner or self._INPROC_DRIVER
        if spec.returns_mode is not None:
            rec.stream_owner = owner or self._INPROC_DRIVER
        # Pin dependencies (and refs nested in by-value args) until terminal.
        entries = list(getattr(req, "_arg_entries", None) or []) + list(
            (getattr(req, "_kwarg_entries", None) or {}).values()
        )
        for kind, v in entries:
            if kind == "id":
                rec.dep_ids.append(v)
                self._pin(v)
            elif kind == "meta" and v.contained_ids:
                rec.dep_ids.extend(v.contained_ids)
                for child in v.contained_ids:
                    self._pin(child)
        if spec.task_id not in self.tasks:
            for d in rec.dep_ids:
                self.lineage_consumers[d] = self.lineage_consumers.get(d, 0) + 1
        self.tasks[spec.task_id] = rec
        rec.stage_ts["queued"] = time.time()
        self.telemetry.submitted += 1
        if self.jobs is not None:
            self.jobs.task_submitted(spec.task_id, rec.stage_ts["queued"])
        self._record_event(spec, "SUBMITTED")
        ar = self.actors.get(spec.actor_id)
        if ar is None or ar.state == "DEAD":
            cause = ar.death_cause if ar else "actor not found"
            self._store_error_results(rec, RayActorError(f"Actor is dead: {cause}"))
            return False
        # Resolve dependencies before dispatch (actor args may be refs).
        self._resolve_then(req, lambda: self._route_actor_call(ar, req))
        return True

    def _route_actor_call(self, ar: ActorRecord, req: ExecRequest):
        if ar.state == "ALIVE" and ar.worker is not None:
            self._dispatch_actor_call(ar, req)
        elif ar.state == "DEAD":
            from ray_tpu_torch.exceptions import RayActorError

            rec = self.tasks.get(req.spec.task_id)
            if rec is not None:
                self._store_error_results(rec, RayActorError("Actor is dead."))
        else:
            ar.backlog.append(req)

    def _dispatch_actor_call(self, ar: ActorRecord, req: ExecRequest):
        node = self.nodes.get(ar.node)
        wh = node.workers.get(ar.worker) if node else None
        if wh is None:
            ar.backlog.append(req)
            return
        rec = self.tasks.get(req.spec.task_id)
        if rec is not None:
            rec.state = lifecycle.step("task", rec.state, "RUNNING")
            rec.worker = wh.worker_id
            rec.node = wh.node_id
            self._note_dispatch(rec, time.time())
        ar.inflight[req.spec.task_id] = None
        self._record_event(req.spec, "RUNNING")
        # Coalesced: an async actor-call burst dispatches as one frame per
        # worker. Send failure routes to the worker-death path at flush.
        self._send_to(wh, ("exec", req))

    def _resolve_then(self, req: ExecRequest, then: Callable[[], None]):
        """Resolve ("id", ...) placeholders in an ExecRequest's args to metas, then
        invoke `then`. Error deps propagate immediately."""
        # ExecRequests built by the worker facade carry entries in arg_metas slots
        # as tuples; normalize here.
        entries = getattr(req, "_arg_entries", None)
        kwentries = getattr(req, "_kwarg_entries", None)
        if entries is None:
            then()
            return
        if not entries and not kwentries:
            # No-arg call (the dominant burst shape): nothing to resolve.
            req.arg_metas = []
            req.kwarg_metas = {}
            req._arg_entries = None
            req._kwarg_entries = None
            then()
            return
        needed = {v for (k, v) in entries if k == "id"} | {
            v for (k, v) in kwentries.values() if k == "id"
        }
        missing = [i for i in needed if i not in self.object_table]

        def finish():
            arg_metas = []
            for kind, v in entries:
                arg_metas.append(self.object_table[v] if kind == "id" else v)
            kw = {}
            for key, (kind, v) in kwentries.items():
                kw[key] = self.object_table[v] if kind == "id" else v
            # Propagate dependency errors without running.
            err_meta = next((m for m in list(arg_metas) + list(kw.values()) if m.is_error), None)
            rec = self.tasks.get(req.spec.task_id)
            if err_meta is not None and rec is not None:
                for oid in rec.return_ids:
                    self._seal_object(self._alias_error_meta(oid, err_meta))
                rec.state = lifecycle.step("task", rec.state, "FAILED")
                self._release_task_pins(rec)
                return
            req.arg_metas = arg_metas
            req.kwarg_metas = kw
            req._arg_entries = None
            req._kwarg_entries = None
            then()

        if not missing:
            finish()
            return
        remaining = {"n": len(set(missing))}

        def on_ready(_):
            remaining["n"] -= 1
            if remaining["n"] == 0:
                finish()

        for i in set(missing):
            self.object_waiters.setdefault(i, []).append(on_ready)

    # --- placement groups ---
    def _try_schedule_pgs(self):
        for pg in list(self.pending_pgs):
            if self._try_reserve_pg(pg):
                self.pending_pgs.remove(pg)
                pg.state = lifecycle.step("placement_group", pg.state, "CREATED")
                for fut in pg.ready_futures:
                    if not fut.done():
                        fut.set_result(True)
                pg.ready_futures.clear()

    def _try_reserve_pg(self, pg: PGRecord) -> bool:
        """Bundle placement policies, the analogue of the reference's
        `bundle_scheduling_policy.cc` PACK/SPREAD/STRICT_PACK/STRICT_SPREAD,
        and GPU_SLICE (one NVLink domain, `_plan_gpu_slice`)."""
        nodes = [self.nodes[nid] for nid in self.node_order if self.nodes[nid].alive]
        unplaced = [b for b in pg.bundles if b.node is None]
        if not unplaced:
            return True
        plan: List[Tuple[Bundle, NodeState]] = []
        scratch = {n.node_id: dict(n.available) for n in nodes}

        def place(b: Bundle, n: NodeState) -> bool:
            if _fits(scratch[n.node_id], b.resources):
                _acquire(scratch[n.node_id], b.resources)
                plan.append((b, n))
                return True
            return False

        strategy = pg.strategy
        if strategy in ("STRICT_PACK", "PACK"):
            ok = False
            for n in nodes:
                # try to fit ALL unplaced bundles on this node
                t = dict(n.available)
                fits_all = True
                for b in unplaced:
                    if _fits(t, b.resources):
                        _acquire(t, b.resources)
                    else:
                        fits_all = False
                        break
                if fits_all:
                    for b in unplaced:
                        place(b, n)
                    ok = True
                    break
            if not ok:
                if strategy == "STRICT_PACK":
                    return False
                # PACK falls back to best-effort spread.
                plan.clear()
                scratch = {n.node_id: dict(n.available) for n in nodes}
                for b in unplaced:
                    if not any(place(b, n) for n in nodes):
                        return False
        elif strategy in ("GPU_SLICE", "STRICT_SPREAD"):
            from ray_tpu_torch.util.gpu_topology_policy import DOMAIN_LABEL

            used = {b.node for b in pg.bundles if b.node is not None}

            def place_spread() -> bool:
                for b in unplaced:
                    placed_ids = {p[1].node_id for p in plan}
                    cand = [
                        n for n in nodes
                        if n.node_id not in used and n.node_id not in placed_ids
                    ]
                    if not any(place(b, n) for n in cand):
                        return False
                return True

            # A gang that lost some of its hosts re-places their bundles on
            # hosts it does not hold: in the domain it holds when it was
            # placed in one (waiting until a host there fits), else by
            # STRICT_SPREAD's rule, as it was first placed.
            pinned = pg.domain if used else None
            chosen = (
                self._plan_gpu_slice(unplaced, nodes, scratch, used, pinned)
                if strategy == "GPU_SLICE" and (pinned is not None or not used)
                else None
            )
            # NVLink-domain-aware: the gang's hosts come from one domain
            # (util/gpu_topology_policy.py), so its collectives never cross
            # the network between domains. Falls back to STRICT_SPREAD
            # placement when no labelled domain can host the gang (clusters
            # without labels, heterogeneous bundles, too few hosts).
            if chosen is not None:
                for b, n in zip(unplaced, chosen):
                    if not place(b, n):  # cannot happen: pre-validated
                        return False
            elif pinned is not None or not place_spread():
                return False
            if strategy == "GPU_SLICE" and not used:
                pg.domain = None if chosen is None else chosen[0].labels[DOMAIN_LABEL]
        else:  # SPREAD (best-effort round robin)
            for i, b in enumerate(unplaced):
                order = nodes[i % len(nodes):] + nodes[: i % len(nodes)] if nodes else []
                if not any(place(b, n) for n in order):
                    return False
        for b, n in plan:
            _acquire(n.available, b.resources)
            b.node = n.node_id
            b.available = dict(b.resources)
        return True

    def _plan_gpu_slice(self, unplaced: List[Bundle], nodes: List[NodeState], scratch,
                        used, pinned: Optional[str]):
        """Choose distinct hosts of one NVLink domain for the bundles; None ->
        no domain can take them (the caller falls back to plain spread
        placement unless the gang is pinned).

        Hosts are grouped by their `gpu_nvlink_domain` label and listed in the
        order they joined. Every bundle is checked against every host of a
        domain before the domain counts as feasible, so a heterogeneous gang
        either fits every chosen host or falls back. `used` are the hosts that
        hold the gang's placed bundles, never chosen again; `pinned` is their
        domain, the only one considered."""
        from ray_tpu_torch.util.gpu_topology_policy import DOMAIN_LABEL, choose_domain_hosts

        domains: Dict[str, List[NodeState]] = {}
        for n in nodes:
            domain = n.labels.get(DOMAIN_LABEL)
            if domain and all(_fits(scratch[n.node_id], b.resources) for b in unplaced):
                domains.setdefault(domain, []).append(n)
        chosen = choose_domain_hosts(
            {d: [n.node_id.binary() for n in members] for d, members in domains.items()},
            len(unplaced),
            exclude=[nid.binary() for nid in used],
            domain=pinned,
        )
        if chosen is None:
            return None
        by_id = {n.node_id.binary(): n for n in nodes}
        return [by_id[i] for i in chosen]

    # --- main scheduling pass ---
    @loop_thread_only
    def _schedule(self):
        self._try_schedule_pgs()
        if not self.pending:
            return
        # Dispatches coalesce per worker in the loop-wide outbound buffer
        # (_send_to), flushed on threshold / end of iteration.
        self._schedule_classes()

    def _schedule_classes(self):
        # Per dispatch class: drain head-first until the first resource
        # failure (same key => same feasibility), so a wakeup costs
        # O(classes + dispatched), not O(pending). Dep-unresolved records
        # park; the object-ready callback re-queues them.
        for key in self.pending.classes():
            while True:
                rec = self.pending.head(key)
                if rec is None:
                    break
                if rec.state != "PENDING":
                    self.pending.pop_head(key)
                    continue  # cancelled or already failed while queued
                if self._try_dispatch(rec):
                    self.pending.pop_head(key)
                    continue
                self.pending.pop_head(key)
                if rec.unresolved:
                    self.pending.park(rec)
                    continue  # a waiting head must not block its class
                # Resource/worker failure: whole class waits for capacity.
                self.pending.push(rec, front=True)
                break

    def _pick_node(self, rec: TaskRecord) -> Optional[NodeState]:
        """Hybrid policy: prefer the first (head) node until its utilization crosses
        the spread threshold, then least-utilized feasible node (reference:
        `hybrid_scheduling_policy.cc`). Node/PG affinity strategies override."""
        strategy = rec.spec.scheduling_strategy
        if rec.spec.placement_group_id is not None:
            pg = self.pgs.get(rec.spec.placement_group_id)
            if pg is None or pg.state not in ("CREATED",):
                return None
            idx = rec.spec.placement_group_bundle_index
            if idx >= len(pg.bundles):
                self._store_error_results(
                    rec,
                    ValueError(
                        f"placement_group_bundle_index {idx} out of range for a "
                        f"{len(pg.bundles)}-bundle placement group"
                    ),
                )
                return None
            candidates = pg.bundles if idx < 0 else [pg.bundles[idx]]
            for b in candidates:
                if b.node is not None and _fits(b.available, rec.spec.resources):
                    node = self.nodes.get(b.node)
                    if node is not None and node.alive:
                        rec.acquired_pg = (pg.pg_id, b.index)
                        return node
            return None
        if strategy is not None and getattr(strategy, "node_id", None) is not None:
            node = self.nodes.get(NodeID.from_hex(strategy.node_id))
            if node is not None and node.alive and _fits(node.available, rec.spec.resources):
                return node
            if strategy.soft:
                pass  # fall through to default policy
            else:
                return None
        if strategy == "SPREAD":
            alive = [self.nodes[nid] for nid in self.node_order if self.nodes[nid].alive]
            feasible = [n for n in alive if _fits(n.available, rec.spec.resources)]
            if not feasible:
                return None
            self._rr_counter += 1
            return feasible[self._rr_counter % len(feasible)]
        # Data locality WEIGHED WITHIN the hybrid policy (reference:
        # `lease_policy.h:56 LocalityAwareLeasePolicy` picks which raylet the
        # lease request goes to, and that raylet's hybrid policy packs onto
        # itself only while under the spread threshold, else spills). Here:
        # argument-holding nodes go FIRST in the hybrid traversal, ranked by
        # resident bytes — so locality wins while the holder is under the
        # threshold, and a saturated magnet node yields to less-utilized
        # nodes instead of starving them. Small args don't drive placement
        # (scheduler_locality_min_bytes).
        loc = self._locality_bytes(rec)
        order = list(self.node_order)
        if loc:
            ranked = sorted(
                (nid for nid in order if loc.get(nid.binary())),
                key=lambda nid: -loc[nid.binary()],
            )
            ranked_set = set(ranked)
            order = ranked + [nid for nid in order if nid not in ranked_set]
        threshold = self.config.scheduler_spread_threshold
        best: Optional[NodeState] = None
        for nid in order:
            node = self.nodes[nid]
            if not node.alive or not _fits(node.available, rec.spec.resources):
                continue
            if node.utilization() < threshold:
                return node  # pack onto first under-threshold feasible node
            if best is None or node.utilization() < best.utilization():
                best = node
        return best

    def _note_locality(self, loc: Dict[bytes, int], node: NodeState) -> None:
        """Locality-placement outcome counters (ray_tpu_locality_hits_total):
        a hit means a task with byte-heavy args landed on a node already
        holding some of them, so those transfers never happen."""
        if not loc:
            return
        key = "locality_hits" if loc.get(node.node_id.binary()) else "locality_misses"
        self._transfer_stats[key] += 1

    def _locality_bytes(self, rec: TaskRecord) -> Dict[bytes, int]:
        """Per-node resident bytes of this task's object arguments."""
        out: Dict[bytes, int] = {}
        min_b = self.config.scheduler_locality_min_bytes
        for kind, v in list(rec.arg_entries) + list(rec.kwarg_entries.values()):
            if kind != "id":
                continue
            meta = self.object_table.get(v)
            if (
                meta is not None
                and meta.segment is not None
                and meta.node_id
                and meta.size >= min_b
            ):
                out[meta.node_id] = out.get(meta.node_id, 0) + meta.size
        return out

    def _try_dispatch(self, rec: TaskRecord) -> bool:
        # 1) dependencies
        needed = {v for (k, v) in rec.arg_entries if k == "id"} | {
            v for (k, v) in rec.kwarg_entries.values() if k == "id"
        }
        missing = [i for i in needed if i not in self.object_table]
        if missing:
            if rec.unresolved == 0:
                rec.unresolved = 1
                remaining = {"n": len(set(missing))}

                def on_ready(_):
                    remaining["n"] -= 1
                    if remaining["n"] == 0:
                        rec.unresolved = 0
                        # Back into the class queue (the record parked when
                        # its deps were missing); next pass dispatches.
                        if self.pending.unpark(rec):
                            self.pending.push(rec)

                for i in set(missing):
                    self.object_waiters.setdefault(i, []).append(on_ready)
            return False
        # Propagate dependency errors.
        metas = [self.object_table[v] if k == "id" else v for k, v in rec.arg_entries]
        kw = {key: (self.object_table[v] if k == "id" else v) for key, (k, v) in rec.kwarg_entries.items()}
        err = next((m for m in list(metas) + list(kw.values()) if m.is_error), None)
        if err is not None:
            if rec.spec.returns_mode == "streaming":
                # Dependency error surfaces as the first (and only) stream item.
                self._seal_stream_error(rec, lambda oid: self._alias_error_meta(oid, err))
            elif rec.spec.returns_mode == "dynamic":
                self._seal_object(self._alias_error_meta(rec.return_ids[0], err))
            else:
                for oid in rec.return_ids:
                    self._seal_object(self._alias_error_meta(oid, err))
            rec.state = lifecycle.step("task", rec.state, "FAILED")
            self._release_task_pins(rec)
            if rec.spec.returns_mode is not None:
                self._finalize_stream(rec)
            return True
        # 2) actor creation: dedicated worker + resources
        if rec.spec.is_actor_creation:
            return self._try_dispatch_actor_creation(rec, metas, kw)
        # 3) node + resources — or pipeline onto an existing class lease.
        node = self._pick_node(rec)
        if node is None:
            return self._try_pipeline(rec, metas, kw)
        # 4) worker — idle reuse is per runtime-env hash (plain tasks reuse
        # plain workers; pip/working_dir tasks get/reuse provisioned workers).
        from ray_tpu_torch._private.runtime_env import env_hash as _renv_hash

        want_hash = _renv_hash(rec.spec.runtime_env)
        wh = None
        for wid in list(node.idle):
            cand = node.workers.get(wid)
            # Liveness probing per dispatch costs a subprocess-poll syscall
            # (~13% of loop samples under task load): probe only workers
            # still in their connect-back window — a connected worker's
            # death surfaces through conn EOF / the send-failure path, which
            # requeues the task.
            if cand is None or (cand.conn is None and not cand.process.is_alive()):
                node.idle.remove(wid)
                continue
            if cand.env_hash == want_hash:
                node.idle.remove(wid)
                wh = cand
                break
        if wh is None:
            max_workers = int(node.resources.get("CPU", 1)) + self.config.maximum_startup_concurrency
            # Actor workers don't count against the stateless pool cap — but
            # only THIS node's actors (a cluster-wide count would inflate every
            # node's cap by every other node's actors). BLOCKED workers don't
            # count either: a worker parked in ray.get released its CPU, and
            # its dependency chain needs replacement workers to make progress
            # — capping them in would deadlock deep nesting (the reference
            # raylet likewise starts replacements for blocked workers).
            node_actors = sum(1 for w in node.workers.values() if w.actor_id is not None)
            node_blocked = sum(
                1
                for w in node.workers.values()
                if w.state == "blocked" and w.blocked_kind == "dep"
            )
            if len(node.workers) >= max_workers + node_actors + node_blocked:
                # At cap with no matching worker: evict an idle worker of a
                # different env hash to make room (the reference raylet kills
                # idle workers to admit dedicated-env workers) — otherwise a
                # pool full of mismatched-env workers deadlocks this task.
                victim = None
                for wid in node.idle:
                    cand = node.workers.get(wid)
                    if (
                        cand is not None
                        and cand.env_hash != want_hash
                        # Never evict a worker that owns live actors: its
                        # death would kill them (ownership semantics) while
                        # callers still hold working handles.
                        and not self._owns_live_actors(cand.worker_id.hex())
                    ):
                        victim = cand
                        break
                if victim is None:
                    return self._try_pipeline(rec, metas, kw)
                try:
                    victim.process.terminate()
                except Exception:
                    pass
                self._on_worker_death(victim)
            wh = self._spawn_worker(node, runtime_env=rec.spec.runtime_env)
            node.idle.remove(wh.worker_id)
        # 5) acquire + dispatch
        if rec.acquired_pg is not None:
            pg = self.pgs[rec.acquired_pg[0]]
            bundle = pg.bundles[rec.acquired_pg[1]]
            _acquire(bundle.available, rec.spec.resources)
        else:
            _acquire(node.available, rec.spec.resources)
        rec.acquired = dict(rec.spec.resources)
        rec.state = lifecycle.step("task", rec.state, "RUNNING")
        rec.running_since = time.time()
        rec.worker = wh.worker_id
        rec.node = node.node_id
        node.last_active = time.time()
        wh.state = lifecycle.step("worker", wh.state, "busy")
        wh.current_task = rec.spec.task_id
        wh.lease_key = _PendingQueue.key_of(rec)
        wh.inflight_tasks = [rec.spec.task_id]
        self._leases.setdefault(wh.lease_key, []).append(wh)
        self._note_dispatch(rec, rec.running_since)
        self._record_event(rec.spec, "RUNNING")
        self._send_exec(wh, rec, metas, kw)
        return True

    def _note_dispatch(self, rec: TaskRecord, now: float) -> None:
        """Stamp the lease_granted stage + dispatch telemetry (plain ints —
        materialized at loop-tick cadence). The ONE locality-counting point:
        every dispatch path (fresh lease, pipelined push, actor creation)
        lands here exactly once per task, so the hit rate counts placement
        OUTCOMES — never _pick_node probes repeated across scheduler ticks
        for a task stuck behind the worker cap."""
        rec.stage_ts["lease_granted"] = now
        if self.jobs is not None:
            # Queue-wait closes, CPU lease opens. acquired is {} for
            # pipelined pushes and actor calls — the lease head / the actor
            # record carries those resources (and their accounting).
            self.jobs.task_dispatched(
                rec.spec.task_id, rec.acquired.get("CPU", 0.0), now
            )
        node = self.nodes.get(rec.node)
        if node is not None:
            self._note_locality(self._locality_bytes(rec), node)
        tel = self.telemetry
        tel.dispatched += 1
        if tel.enabled:
            queued = rec.stage_ts.get("queued")
            if queued is not None:
                tel.dispatch_waits.append(now - queued)

    def _send_exec(self, wh: WorkerHandle, rec: TaskRecord, metas, kw) -> None:
        req = ExecRequest.__new__(ExecRequest)
        req.spec = rec.spec
        req.arg_metas = metas
        req.kwarg_metas = kw
        req.func_blob = None
        req.return_ids = rec.return_ids
        nbytes = 320
        if rec.spec.func.function_id not in wh.known_functions:
            req.func_blob = self.gcs.function_table.get(rec.spec.func.function_id, rec.func_blob)
            wh.known_functions.add(rec.spec.func.function_id)
            if req.func_blob is not None:
                nbytes += len(req.func_blob)
        if metas or kw:
            nbytes = None  # inline arg bytes: let the estimator walk them
        # Coalesced per worker in the loop-wide outbound buffer; a send
        # failure at flush runs worker-death handling, which retries or seals
        # an error for every in-flight record itself.
        self._send_to(wh, ("exec", req), nbytes=nbytes)

    def _remove_from_lease_index(self, wh: WorkerHandle) -> None:
        if wh.lease_key is not None:
            lst = self._leases.get(wh.lease_key)
            if lst is not None:
                try:
                    lst.remove(wh)
                except ValueError:
                    pass
                if not lst:
                    self._leases.pop(wh.lease_key, None)

    def _drop_lease(self, wh: WorkerHandle) -> None:
        self._remove_from_lease_index(wh)
        wh.lease_key = None
        wh.inflight_tasks = []

    def _try_pipeline(self, rec: TaskRecord, metas, kw) -> bool:
        """Queue a resource-starved task onto a busy worker already leased to
        its dispatch class (reference: lease reuse + pipelined pushes,
        `direct_task_transport.h:75`). Called from _try_dispatch after node
        pick / worker-pool admission failed — dependencies are resolved and
        error-free, and `metas`/`kw` are the arg metas it already built."""
        spec = rec.spec
        if spec.is_actor_creation:
            return False
        if spec.scheduling_strategy == "SPREAD":
            return False  # concentrating on one worker defeats SPREAD
        depth = self.config.worker_pipeline_depth
        if depth <= 1:
            return False
        for wh in self._leases.get(_PendingQueue.key_of(rec), ()):
            if wh.state != "busy" or len(wh.inflight_tasks) >= depth:
                continue
            # The running head of the lease holds the resources; accounting
            # transfers on its completion (_on_task_done).
            rec.acquired = {}
            rec.acquired_pg = None
            rec.state = lifecycle.step("task", rec.state, "RUNNING")
            rec.running_since = time.time()
            rec.worker = wh.worker_id
            rec.node = wh.node_id
            wh.inflight_tasks.append(spec.task_id)
            node = self.nodes.get(wh.node_id)
            if node is not None:
                node.last_active = time.time()
            self._note_dispatch(rec, rec.running_since)
            self._record_event(spec, "RUNNING")
            self._send_exec(wh, rec, metas, kw)
            return True
        return False

    def _try_dispatch_actor_creation(self, rec: TaskRecord, metas, kw) -> bool:
        ar = self.actors.get(rec.spec.actor_id)
        if ar is None or ar.state == "DEAD":
            self._release_task_pins(rec)
            return True  # dropped (e.g. killed while pending)
        node = self._pick_node(rec)
        if node is None:
            return False
        num_gpus = rec.spec.resources.get("GPU", 0)
        if num_gpus and not node.can_assign_gpu_ids(num_gpus):
            # Admitted by the totals but no id is free: wait for a release.
            rec.acquired_pg = None
            return False
        if rec.acquired_pg is not None:
            pg = self.pgs[rec.acquired_pg[0]]
            bundle = pg.bundles[rec.acquired_pg[1]]
            _acquire(bundle.available, rec.spec.resources)
            ar.acquired_pg = rec.acquired_pg
        else:
            _acquire(node.available, rec.spec.resources)
        ar.acquired = dict(rec.spec.resources)
        if self.jobs is not None:
            # Actors hold their resources for their whole lifetime: the
            # lease accrues creation -> _release_actor_resources.
            self.jobs.actor_lease_opened(
                ar.actor_id, ar.acquired.get("CPU", 0.0), time.time()
            )
        node.last_active = time.time()
        env_vars = dict(rec.spec.env_vars)
        # GPU visibility: give the actor specific device ids, so that two
        # GPU actors on one node never share a device, and an actor that
        # holds no GPU sees none (the reference's resource allocator). Tasks
        # get no visibility setting.
        if num_gpus:
            ar.gpu_ids = node.assign_gpu_ids(num_gpus)
        env_vars.setdefault("CUDA_VISIBLE_DEVICES", ",".join(ar.gpu_ids))
        wh = self._spawn_worker(
            node, actor_id=ar.actor_id, env_vars=env_vars,
            runtime_env=rec.spec.runtime_env,
        )
        ar.worker = wh.worker_id
        ar.node = node.node_id
        rec.state = lifecycle.step("task", rec.state, "RUNNING")
        rec.worker = wh.worker_id
        rec.node = node.node_id
        ar.inflight[rec.spec.task_id] = None
        self._note_dispatch(rec, time.time())
        self._record_event(rec.spec, "RUNNING")
        req = ExecRequest(
            spec=rec.spec,
            arg_metas=metas,
            kwarg_metas=kw,
            func_blob=self.gcs.function_table.get(rec.spec.func.function_id, rec.func_blob),
            return_ids=rec.return_ids,
        )
        wh.known_functions.add(rec.spec.func.function_id)
        # Send failure at flush runs actor death handling, which restarts or
        # fails the actor itself; the creation record is never re-queued here.
        self._send_to(wh, ("exec", req))
        return True

    def _try_start_actor(self, ar: ActorRecord):
        """(Re)run the creation task for a PENDING/RESTARTING actor."""
        req = ar.creation_req
        rec = TaskRecord(
            spec=req.spec,
            arg_entries=getattr(req, "_saved_arg_entries", [("meta", m) for m in req.arg_metas]),
            kwarg_entries=getattr(req, "_saved_kwarg_entries", {k: ("meta", m) for k, m in req.kwarg_metas.items()}),
            return_ids=req.return_ids,
            func_blob=req.func_blob,
        )
        # Through _register_task so creation-arg refs get pinned like any
        # task's. Pin ordering matters on restart: the clone pins BEFORE the
        # replaced record releases, so creation args can never hit refcount
        # zero in between (they must stay alive for the actor's whole life —
        # restarts replay the creation task, and put() args have no lineage).
        old = self.tasks.get(req.spec.task_id)
        self._register_task(rec)
        if old is not None and old is not rec:
            self._release_task_pins(old)

    # ------------------------------------------------------------------ resources
    def _release_task_resources(self, rec: TaskRecord):
        if rec.acquired_pg is not None:
            pg = self.pgs.get(rec.acquired_pg[0])
            if pg is not None and pg.state == "CREATED":
                _release(pg.bundles[rec.acquired_pg[1]].available, rec.acquired)
            else:
                # PG was removed while this task ran: its bundle reservation is
                # gone, so the in-use share goes straight back to the node.
                node = self.nodes.get(rec.node)
                if node is not None:
                    _release(node.available, rec.acquired)
            rec.acquired_pg = None
        elif rec.node is not None:
            node = self.nodes.get(rec.node)
            if node is not None:
                _release(node.available, rec.acquired)
        rec.acquired = {}

    def _release_actor_resources(self, ar: ActorRecord):
        if ar.gpu_ids:
            node = self.nodes.get(ar.node)
            if node is not None:
                node.return_gpu_ids(ar.gpu_ids, ar.acquired.get("GPU", 0.0))
            ar.gpu_ids = []
        if self.jobs is not None:
            # Idempotent (pop): restarts re-open at the next creation.
            self.jobs.actor_lease_closed(ar.actor_id, time.time())
        if ar.acquired_pg is not None:
            pg = self.pgs.get(ar.acquired_pg[0])
            if pg is not None and pg.state == "CREATED":
                _release(pg.bundles[ar.acquired_pg[1]].available, ar.acquired)
            else:
                node = self.nodes.get(ar.node)
                if node is not None:
                    _release(node.available, ar.acquired)
            ar.acquired_pg = None
        elif ar.node is not None:
            node = self.nodes.get(ar.node)
            if node is not None:
                _release(node.available, ar.acquired)
        ar.acquired = {}

    # ------------------------------------------------------------------ misc
    def _record_event(self, spec: TaskSpec, state: str,
                      rec: Optional[TaskRecord] = None):
        if not self.config.enable_timeline:
            return
        stages = None
        if rec is not None and rec.stage_ts:
            # Terminal events carry the full per-stage pipeline: the "submit"
            # stamp from the caller-side spec plus scheduler- and
            # worker-side stages accumulated on the record.
            stages = {"submit": getattr(spec, "submitted_ts", rec.submitted_at),
                      **rec.stage_ts}
        # Tuple form, not TaskEvent: this runs up to 3x per task on the loop
        # thread (gcs.record_event_tuple documents the shape).
        self.gcs.record_event_tuple(
            (spec.task_id.hex(), spec.name or spec.func.name, state,
             time.time(), stages)
        )


_ASYNC = object()
