"""Core worker facade: the process-local object behind the public API
(`ray_tpu_torch.init/get/put/wait/remote/kill/...`).

This is the analogue of the reference's `python/ray/_private/worker.py` (module-level
`global_worker`, `init:1115`, `get:2424`, `put:2551`, `wait:2613`) fused with the
Cython `CoreWorker` facade (`_raylet.pyx:1521`). Two bindings exist:
 - DriverContext: in the driver process, calls the Scheduler directly (it lives in
   the same process).
 - WorkerProcContext: in worker processes, speaks the pipe protocol to the driver.
Both sit on top of the same LocalObjectStore for zero-copy payload access.
"""

from __future__ import annotations

import atexit
import concurrent.futures
import hashlib
import os
import shutil
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.config import Config, get_config, set_config
from ray_tpu_torch._private.gcs import GCS
from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, TaskID
from ray_tpu_torch._private.object_store import LocalObjectStore, ObjectMeta
from ray_tpu_torch._private.ownership import OwnershipTable
from ray_tpu_torch._private.protocol import ExecRequest, FunctionDescriptor, TaskSpec
from ray_tpu_torch._private.scheduler import (
    ActorRecord,
    Scheduler,
    TaskRecord,
    fast_task_record,
)

DRIVER_MODE = "driver"
WORKER_MODE = "worker"


class _RefTracker:
    """Process-local ObjectRef reference counts, the client half of ownership
    refcounting (`src/ray/core_worker/reference_count.h:59`).

    Every live ObjectRef in this process counts here; ops (first-ref "add",
    zero-transition "rel") queue IN ORDER and are flushed to the control plane
    in batches. Order matters: a ref deserialized out of a container is added
    to the queue before the container's release can be, so the scheduler never
    frees a child whose borrower registration is still in flight."""

    def __init__(self):
        import collections

        self._lock = threading.Lock()
        self._counts: Dict[bytes, int] = {}
        self._ops: List[Tuple[str, bytes]] = []
        # decref() must be safe to run from ObjectRef.__del__, which the GC can
        # fire at ANY allocation point — including while this thread already
        # holds self._lock. So __del__ only does a lock-free deque append
        # (atomic in CPython); the bookkeeping happens later in drain().
        self._dead: "collections.deque[bytes]" = collections.deque()
        # Same GC-safety constraint for ObjectRefGenerator.__del__: stream
        # releases queue lock-free and ride the next ref-ops flush instead of
        # making a blocking RPC from GC context (which could deadlock on the
        # connection's non-reentrant locks or the scheduler event thread).
        self._dead_streams: "collections.deque[bytes]" = collections.deque()

    def incref(self, key: bytes) -> None:
        with self._lock:
            n = self._counts.get(key, 0)
            self._counts[key] = n + 1
            if n == 0:
                self._ops.append(("add", key))

    def decref(self, key: bytes) -> None:
        # GC-safe: no lock, no dict mutation (see __init__ comment).
        self._dead.append(key)

    def _apply_dead_locked(self) -> None:
        while True:
            try:
                key = self._dead.popleft()
            except IndexError:
                return
            n = self._counts.get(key, 0) - 1
            if n <= 0:
                self._counts.pop(key, None)
                self._ops.append(("rel", key))
            else:
                self._counts[key] = n

    def gen_release(self, key: bytes) -> None:
        """Queue a release of the scheduler's interim generator holder for a
        streamed item, AFTER this process's own incref in the same FIFO batch
        (so the object is never holderless in between)."""
        with self._lock:
            self._ops.append(("genrel", key))

    def stream_release(self, task_id_bytes: bytes) -> None:
        # GC-safe: no lock (see _dead_streams in __init__).
        self._dead_streams.append(task_id_bytes)

    def drain(self) -> List[Tuple[str, bytes]]:
        with self._lock:
            self._apply_dead_locked()
            while True:
                try:
                    self._ops.append(("srel", self._dead_streams.popleft()))
                except IndexError:
                    break
            ops, self._ops = self._ops, []
        # Zero-transition releases also retire the owner-side table entry
        # (outside self._lock: the table has its own lock).
        if ops:
            table = global_worker.ownership
            for op, key in ops:
                if op == "rel":
                    table.forget(key)
        return ops

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._ops.clear()
            self._dead.clear()
            self._dead_streams.clear()


_ref_tracker = _RefTracker()


# Serializes drain+send so concurrent flushes (background flusher, put(), task
# completion) cannot reorder batches — the add-before-rel queue order must
# survive onto the wire.
_flush_lock = threading.Lock()


def flush_ref_ops() -> None:
    """Queue drained refcount ops into the control plane (called by the
    background flusher, at task completion, and by tests for determinism).
    Both destinations are FIFO and non-blocking: connection-backed contexts
    enqueue into the connection's batch buffer (ops piggyback on the next
    outbound batch — a done, a submit, or the sub-ms flush timer), the
    in-process driver into the scheduler's command queue. drain+enqueue is
    atomic under _flush_lock so the add-before-rel queue order survives onto
    the wire."""
    t = _ref_tracker
    if not t._ops and not t._dead and not t._dead_streams:
        # Lock-free emptiness peek (safe in CPython): the per-task-completion
        # call is almost always a no-op, and a racing enqueue just rides the
        # NEXT flush — delivery stays eventual and ordered.
        return
    with _flush_lock:
        ops = _ref_tracker.drain()
        if not ops:
            return
        ctx = global_worker.context
        if ctx is None:
            return
        try:
            ctx.ref_ops(ops)
        except Exception:
            pass  # control plane gone (shutdown); counts die with it


def _start_ref_flusher() -> None:
    gen = global_worker._session_gen

    def loop():
        while global_worker.mode is not None and global_worker._session_gen == gen:
            time.sleep(0.1)
            flush_ref_ops()

    threading.Thread(target=loop, daemon=True, name="ref-flusher").start()


class ObjectRef:
    """A reference to a (possibly pending) object (reference: `ObjectRef` in
    `_raylet.pyx`). Picklable: rebinds to the receiving process's worker, which
    registers itself as a borrower via the ref tracker."""

    __slots__ = ("_id",)

    def __init__(self, object_id: ObjectID):
        self._id = object_id
        _ref_tracker.incref(object_id._binary)

    def __del__(self):
        try:
            _ref_tracker.decref(self._id.binary())
        except Exception:
            pass  # interpreter teardown

    def binary(self) -> bytes:
        return self._id.binary()

    def hex(self) -> str:
        return self._id.hex()

    @property
    def task_id(self) -> TaskID:
        return self._id.task_id

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self.hex()})"

    def __reduce__(self):
        serialization.note_contained_ref(self._id.binary())
        return (ObjectRef, (self._id,))

    def future(self) -> concurrent.futures.Future:
        """A concurrent.futures view of this ref (driver only)."""
        fut: concurrent.futures.Future = concurrent.futures.Future()

        def _poll():
            try:
                fut.set_result(get(self))
            except Exception as e:  # noqa: BLE001
                fut.set_exception(e)

        threading.Thread(target=_poll, daemon=True).start()
        return fut

    def __await__(self):
        """Allow `await ref` inside async actors."""
        import asyncio

        loop = asyncio.get_event_loop()
        return loop.run_in_executor(None, lambda: get(self)).__await__()


class DynamicObjectRefGenerator:
    """The value a `num_returns="dynamic"` task resolves to: a picklable,
    re-iterable sequence of the refs the task yielded (reference:
    `python/ray/_raylet.pyx:174 DynamicObjectRefGenerator`)."""

    def __init__(self, refs: List["ObjectRef"]):
        self._refs = list(refs)

    def __iter__(self):
        return iter(self._refs)

    def __len__(self) -> int:
        return len(self._refs)

    def __getitem__(self, i):
        return self._refs[i]

    def __repr__(self):
        return f"DynamicObjectRefGenerator({len(self._refs)} refs)"


class ObjectRefGenerator:
    """Caller-side handle for a `num_returns="streaming"` generator task:
    `next()` blocks until the worker seals the next yielded item, before the
    task finishes (reference: `_raylet.pyx ObjectRefGenerator` /
    `StreamingObjectRefGenerator`). Owner-only: not serializable."""

    def __init__(self, task_id: TaskID):
        self._task_id = task_id
        self._index = 0
        self._total: Optional[int] = None
        self._released = False

    @property
    def task_id(self) -> TaskID:
        return self._task_id

    def __iter__(self):
        return self

    def __next__(self) -> "ObjectRef":
        return self._next_internal(timeout=None)

    def _next_internal(self, timeout: Optional[float], blocking: bool = True) -> "ObjectRef":
        if self._total is not None and self._index >= self._total:
            raise StopIteration
        ctx = global_worker.context
        if ctx is None:
            raise RuntimeError("ray_tpu_torch is not initialized")
        kind, payload = ctx.stream_next(
            self._task_id.binary(), self._index, timeout, blocking
        )
        if kind == "pending":
            raise exceptions.GetTimeoutError("stream item not produced yet")
        if kind == "eof":
            self._total = payload
            if self._index >= self._total:
                raise StopIteration
            # Items exist but we were answered eof (record raced away): re-ask.
            kind, payload = ctx.stream_next(self._task_id.binary(), self._index, timeout)
            if kind == "eof":
                raise StopIteration
        meta: ObjectMeta = payload
        ref = ObjectRef(meta.object_id)
        # Take over from the scheduler's interim holder (ordered after our add).
        _ref_tracker.gen_release(meta.object_id.binary())
        self._index += 1
        return ref

    def next_ready(self, timeout: Optional[float] = None) -> "ObjectRef":
        """`__next__` with a timeout; raises GetTimeoutError if no item is
        available in time. timeout=0 is a pure non-blocking probe (one control
        round-trip, no waiter parked)."""
        if timeout is not None and timeout <= 0:
            return self._next_internal(timeout=5.0, blocking=False)
        return self._next_internal(timeout)

    def completed(self) -> bool:
        return self._total is not None and self._index >= self._total

    def close(self) -> None:
        """Release unconsumed items and stop the producer: a queued task is
        cancelled, a running one stops cooperatively at its next backpressure
        checkpoint (every streaming task has a window by default). The release
        rides the ref-ops queue (flushed within ~0.1s); an explicit close()
        also flushes immediately."""
        if self._released:
            return
        self._released = True
        _ref_tracker.stream_release(self._task_id.binary())
        flush_ref_ops()

    def __del__(self):
        # GC context: queue only — a blocking RPC here can deadlock on the
        # connection locks or the scheduler event thread (see _RefTracker).
        if not self._released:
            self._released = True
            try:
                _ref_tracker.stream_release(self._task_id.binary())
            except Exception:
                pass  # interpreter teardown

    def __reduce__(self):
        raise TypeError(
            "ObjectRefGenerator is owner-only and cannot be serialized; pass "
            "the individual ObjectRefs it yields instead."
        )


class _WorkerState:
    """Module-global state for whichever process we are in."""

    def __init__(self):
        self.mode: Optional[str] = None
        self.job_id: Optional[JobID] = None
        self.store: Optional[LocalObjectStore] = None
        # Owner-side record of truth for objects this process created
        # (_private/ownership.py): metas resolve here without a head trip.
        self.ownership = OwnershipTable()
        # Peer-to-peer data-plane manager for this process's pulls
        # (object_transfer.ObjectTransferManager); None until init/connect.
        self.transfer = None
        self.context = None  # DriverContext | WorkerProcContext
        # Per-THREAD: threaded actors run concurrent calls, each with its own
        # current task (put-ID minting and lineage attribution key off it).
        self._task_tls = threading.local()
        self.current_actor_id: Optional[ActorID] = None
        self.session_dir: Optional[str] = None
        self.node = None  # driver only: the Node object
        self._put_counter = 0
        self._task_counter = 0
        # Cached id-minting bases (next_task_id/next_put_id are hot-path).
        self._pseudo_actor: Optional[ActorID] = None
        self._driver_task_id: Optional[TaskID] = None
        self._lock = threading.Lock()
        self.namespace: str = "default"
        self._client_tmp_dir: Optional[str] = None
        # Bumped on every init() so stale ref-flusher threads from a previous
        # session exit instead of flushing into the new one.
        self._session_gen: int = 0

    @property
    def current_task_id(self) -> Optional[TaskID]:
        return getattr(self._task_tls, "task_id", None)

    @current_task_id.setter
    def current_task_id(self, value: Optional[TaskID]) -> None:
        self._task_tls.task_id = value

    def _driver_pseudo_actor(self) -> ActorID:
        # Cached per job: minting ids is on the `.remote()`/put() hot path.
        actor = self._pseudo_actor
        if actor is None or actor.job_id != (self.job_id or JobID.from_int(0)):
            actor = ActorID(
                b"\x00" * 12 + (self.job_id or JobID.from_int(0)).binary()
            )
            self._pseudo_actor = actor
        return actor

    def next_put_id(self) -> ObjectID:
        with self._lock:
            self._put_counter += 1
            idx = self._put_counter
        base = self.current_task_id
        if base is None:
            base = self._driver_task_id
            if base is None:
                base = self._driver_task_id = TaskID.for_driver(
                    self.job_id or JobID.from_int(0)
                )
        return ObjectID.for_put(base, idx)

    def next_task_id(self) -> TaskID:
        return TaskID.for_task(
            self.current_actor_id or self._driver_pseudo_actor()
        )


global_worker = _WorkerState()


def _set_current_actor_id(actor_id: ActorID):
    global_worker.current_actor_id = actor_id


# --------------------------------------------------------------------------- contexts
class DriverContext:
    def __init__(self, scheduler: Scheduler):
        self.scheduler = scheduler

    def note_owner_wait(self, delta: int) -> None:
        self.scheduler.note_owner_wait(delta)

    def submit(self, rec: TaskRecord):
        # Fire-and-forget: pipelined `.remote()` bursts drain in one scheduler
        # wakeup. Errors surface through the return refs, never the submit.
        self.scheduler.call_nowait("submit", rec)

    def submit_fast(self, spec, return_ids, func_blob, dispatch_key):
        # No-arg fast-path submit: the loop builds the TaskRecord itself
        # (burst coalescing keeps that off the submitting thread's clock).
        self.scheduler.call_nowait(
            "submit_fast", (spec, return_ids, func_blob, dispatch_key)
        )

    def submit_actor_task(self, req: ExecRequest):
        self.scheduler.call_nowait("submit_actor_task", req)

    def create_actor(self, payload):
        self.scheduler.call("create_actor", payload).result()

    def get_metas(self, ids: List[bytes], timeout: Optional[float]) -> List[ObjectMeta]:
        inner: concurrent.futures.Future = concurrent.futures.Future()
        self.scheduler.call("get_metas", (ids, inner)).result()
        try:
            return inner.result(timeout=timeout)
        except concurrent.futures.TimeoutError:
            raise exceptions.GetTimeoutError(
                f"get() timed out after {timeout}s waiting for {len(ids)} object(s)"
            ) from None

    def wait(self, ids: List[bytes], num_returns: int, timeout: Optional[float]) -> List[bytes]:
        inner: concurrent.futures.Future = concurrent.futures.Future()
        self.scheduler.call("wait", (ids, num_returns, inner)).result()
        try:
            return inner.result(timeout=timeout)
        except concurrent.futures.TimeoutError:
            ready = self.scheduler.call("peek_metas", ids).result()
            return list(ready.keys())

    def put_meta(self, meta: ObjectMeta):
        if meta.segment is None and get_config().control_plane_batching:
            # Inline objects can never fail the capacity check (no segment
            # bytes), so the registration needs no ack. The scheduler's FIFO
            # command queue keeps every later get/wait/submit ordered after
            # it — identical observable semantics, no round trip.
            self.scheduler.call_nowait("put_meta", meta)
            return None
        # In-process: the scheduler mutates THIS meta object on spill, so the
        # caller's copy is always current.
        self.scheduler.call("put_meta", meta).result()
        return None

    def kv(self, op: str, *args):
        return self.scheduler.call("kv", (op, args)).result()

    def get_actor_by_name(self, name: str):
        return self.scheduler.call("get_actor_by_name", name).result()

    def kill_actor(self, actor_id: ActorID, no_restart: bool):
        return self.scheduler.call("kill_actor", (actor_id, no_restart)).result()

    def register_function(self, function_id: str, blob: bytes):
        self.scheduler.call("register_function", (function_id, blob)).result()

    def create_pg(self, pg_record):
        return self.scheduler.call("create_pg", pg_record).result()

    def pg_ready(self, pg_id, timeout: Optional[float]) -> bool:
        inner: concurrent.futures.Future = concurrent.futures.Future()
        self.scheduler.call("pg_ready", (pg_id, inner)).result()
        try:
            return inner.result(timeout=timeout)
        except concurrent.futures.TimeoutError:
            return False

    def remove_pg(self, pg_id):
        return self.scheduler.call("remove_pg", pg_id).result()

    def available_resources(self):
        return self.scheduler.call("available_resources", None).result()

    def cluster_resources(self):
        return self.scheduler.call("cluster_resources", None).result()

    def nodes(self, payload=None):
        return self.scheduler.call("get_nodes", payload).result()

    def serve_directory(self):
        return self.scheduler.call("serve_directory", None).result()

    def serve_actor_inflight(self, actor_id_bytes: bytes) -> int:
        return self.scheduler.call("serve_actor_inflight", actor_id_bytes).result()

    def serve_drain_actor(self, actor_id_bytes: bytes, timeout_s: float) -> dict:
        inner: concurrent.futures.Future = concurrent.futures.Future()
        self.scheduler.call(
            "serve_drain_actor", (actor_id_bytes, timeout_s, inner)
        ).result()
        try:
            return inner.result(timeout=timeout_s + 10.0)
        except concurrent.futures.TimeoutError:
            return {"ok": False, "inflight": -1}

    def dump_stacks(self, timeout_s=None):
        inner: concurrent.futures.Future = concurrent.futures.Future()
        self.scheduler.call("dump_stacks", (timeout_s, inner)).result()
        return inner.result(timeout=(timeout_s or 30.0) + 15.0)

    def profile_start(self, hz=None):
        return self.scheduler.call("profile_start", hz).result()

    def profile_collect(self):
        inner: concurrent.futures.Future = concurrent.futures.Future()
        self.scheduler.call("profile_collect", inner).result()
        return inner.result(timeout=60.0)

    def memory_summary(self, payload=None):
        return self.scheduler.call("memory_summary", payload).result()

    def task_events(self):
        return self.scheduler.call("task_events", None).result()

    def task_latency(self):
        return self.scheduler.call("task_latency", None).result()

    def push_spans(self, batch):
        # Fire-and-forget append into the head's trace-span ring: the 1 Hz
        # span flusher must never block on the loop.
        self.scheduler.call_nowait("spans_push", batch)

    def list_spans(self, payload=None):
        return self.scheduler.call("spans_list", payload).result()

    def query_series(self, payload):
        return self.scheduler.call("query_series", payload).result()

    def cluster_events(self, payload=None):
        return self.scheduler.call("cluster_events", payload).result()

    def list_alerts(self):
        return self.scheduler.call("list_alerts", None).result()

    def obs_stats(self):
        return self.scheduler.call("obs_stats", None).result()

    def list_actors(self, payload=None):
        return self.scheduler.call("list_actors", payload).result()

    def list_tasks(self, limit=1000):
        return self.scheduler.call("list_tasks", limit).result()

    def list_jobs(self):
        return self.scheduler.call("list_jobs", None).result()

    def job_report(self, job):
        return self.scheduler.call("job_report", job).result()

    def list_objects(self, limit=1000):
        return self.scheduler.call("list_objects", limit).result()

    def autoscaler_state(self):
        return self.scheduler.call("autoscaler_state", None).result()

    def free(self, ids: List[bytes]):
        return self.scheduler.call("free", ids).result()

    def cancel(self, task_id, force: bool):
        return self.scheduler.call("cancel", (task_id, force)).result()

    def ref_ops(self, ops):
        # Fire-and-forget: command-queue FIFO makes the releases visible to
        # any later capacity check / get without an ack round trip per flush.
        self.scheduler.call_nowait("ref_ops", (ops, None))

    def stream_next(self, task_id_bytes: bytes, index: int,
                    timeout: Optional[float] = None, blocking: bool = True):
        inner: concurrent.futures.Future = concurrent.futures.Future()
        self.scheduler.call(
            "stream_next", (task_id_bytes, index, inner, blocking)
        ).result()
        try:
            return inner.result(timeout=timeout)
        except concurrent.futures.TimeoutError:
            raise exceptions.GetTimeoutError(
                f"stream_next timed out after {timeout}s"
            ) from None

    def reconstruct_object(self, key: bytes) -> ObjectMeta:
        inner: concurrent.futures.Future = concurrent.futures.Future()
        self.scheduler.call("reconstruct_object", (key, inner)).result()
        return inner.result(timeout=get_config().object_pull_timeout_s)

    def transfer_stats(self):
        return self.scheduler.call("transfer_stats", None).result()

    def ensure_local(self, meta: ObjectMeta) -> ObjectMeta:
        from ray_tpu_torch._private.object_store import resolve_for_read

        def pull(key: bytes):
            # Segment lives on a daemon node of a different machine: pull
            # through the head into this process's store dir.
            inner: concurrent.futures.Future = concurrent.futures.Future()
            self.scheduler.call("pull_object", (key, inner)).result()
            try:
                return inner.result(timeout=get_config().object_pull_timeout_s)
            except concurrent.futures.TimeoutError:
                raise exceptions.GetTimeoutError(
                    f"object pull timed out after {get_config().object_pull_timeout_s}s"
                ) from None

        def locate(key: bytes):
            return self.scheduler.call("locate_object", key).result()

        def note_replica(key: bytes):
            self.scheduler.call_nowait(
                "object_replica", (key, global_worker.store.node_id)
            )

        return resolve_for_read(
            global_worker.store, meta, pull, get_config().force_object_pulls,
            locate_fn=locate, transfer=global_worker.transfer,
            replica_fn=note_replica,
        )


class RemoteDriverContext:
    """Driver in client mode: `init(address=...)` against a head server process
    (the analogue of connecting to an existing cluster in the reference,
    `_private/worker.py:1115` with address="auto"). Speaks the same req/resp
    protocol workers use, plus it serves "read_object" pulls for objects this
    driver put into its own store dir (remote-driver case)."""

    def __init__(self, wc, head_address: str):
        self.wc = wc  # worker_main.WorkerConnection over the TCP conn
        self.head_address = head_address
        wc.misc_handler = self._on_misc

    def _on_misc(self, msg):
        if msg[0] == "pub":
            _, channel, payload = msg
            if channel == "logs":
                _print_worker_log(payload)
            elif channel == "errors":
                _print_worker_error(payload)
        elif msg[0] == "own_meta":
            global_worker.ownership.deliver_owned(msg[1])
        elif msg[0] == "object_locations":
            from ray_tpu_torch._private import object_transfer

            object_transfer.deliver_locations(msg[1], msg[2])
        elif msg[0] == "read_object":
            # (token, path[, offset, length]) — offset/length arrive for
            # arena-backed objects (MESSAGE_GRAMMAR "read_object"). The old
            # 3-tuple unpack here crashed the reader thread on any arena
            # object pulled from this driver's store; rt-lint's arity check
            # now pins both ends to the grammar.
            _, token, path = msg[:3]
            offset = msg[3] if len(msg) > 3 else None
            length = msg[4] if len(msg) > 4 else None

            def _read():
                from ray_tpu_torch._private.object_store import read_segment

                try:
                    data = read_segment(path, offset, length)
                    self.wc.send(("object_data", token, True, data))
                except OSError as e:
                    self.wc.send(("object_data", token, False, repr(e)))

            threading.Thread(target=_read, daemon=True).start()
        elif msg[0] == "delete_object":
            arena_offset = msg[2] if len(msg) > 2 else None
            if arena_offset is not None:
                from ray_tpu_torch._private.object_store import get_node_arena

                arena = get_node_arena(os.path.dirname(msg[1]))
                if arena is not None:
                    arena.free(arena_offset)
            else:
                try:
                    os.unlink(msg[1])
                except OSError:
                    pass

    def close(self):
        # Deliver anything still coalesced (e.g. a submit enqueued just
        # before shutdown) before tearing the connection down.
        self.wc.batch.flush()
        self.wc.batch.close()
        try:
            self.wc.conn.close()
        except OSError:
            pass

    # --- core ops (worker-style req/resp) ---
    def submit(self, rec):
        # One-way + coalescable: pipelined `.remote()` bursts batch into one
        # frame; any blocking request flushes first (FIFO preserved).
        self.wc.send_async(("cmd", "submit", rec))

    def submit_fast(self, spec, return_ids, func_blob, dispatch_key):
        # Connection-backed contexts build the record here (the head's
        # _req_submit path takes TaskRecords); dispatch_key stays local —
        # the head recomputes it from the spec.
        rec = fast_task_record(
            spec, (), {}, return_ids, func_blob, spec.max_retries, None
        )
        self.wc.send_async(("cmd", "submit", rec))

    def submit_actor_task(self, req: ExecRequest):
        self.wc.send_async(("cmd", "submit_actor_task", req))

    def create_actor(self, payload):
        self.wc.request("create_actor", payload)

    def get_metas(self, ids, timeout):
        try:
            return self.wc.request("get_metas", ids, timeout=timeout)
        except TimeoutError:
            raise exceptions.GetTimeoutError(f"get() timed out after {timeout}s") from None

    def wait(self, ids, num_returns, timeout):
        try:
            return self.wc.request("wait", (ids, num_returns), timeout=timeout)
        except TimeoutError:
            peeked = self.wc.request("peek_metas", ids)
            return list(peeked.keys())

    def put_meta(self, meta):
        if meta.segment is None and get_config().control_plane_batching:
            # Inline puts cannot fail the capacity check: register without
            # an ack; connection FIFO orders any later get/submit after it.
            self.wc.send_async(("cmd", "put_meta", meta))
            return None
        # The head responds the relocated meta when it spilled the object
        # (our local copy would point at an unlinked segment otherwise).
        resp = self.wc.request("put_meta", meta)
        return resp if resp is not True else None

    def kv(self, op, *args):
        return self.wc.request("kv", (op, args))

    def get_actor_by_name(self, name):
        return self.wc.request("get_actor_by_name", name)

    def kill_actor(self, actor_id, no_restart):
        return self.wc.request("kill_actor", (actor_id, no_restart))

    def register_function(self, function_id, blob):
        return self.wc.request("driver_cmd", ("register_function", (function_id, blob)))

    def create_pg(self, pg_record):
        return self.wc.request("create_pg", pg_record)

    def pg_ready(self, pg_id, timeout):
        try:
            return self.wc.request("pg_ready", pg_id, timeout=timeout)
        except TimeoutError:
            return False

    def remove_pg(self, pg_id):
        return self.wc.request("driver_cmd", ("remove_pg", pg_id))

    def available_resources(self):
        return self.wc.request("available_resources", None)

    def cluster_resources(self):
        return self.wc.request("cluster_resources", None)

    def nodes(self, payload=None):
        return self.wc.request("driver_cmd", ("get_nodes", payload))

    def serve_directory(self):
        return self.wc.request("driver_cmd", ("serve_directory", None))

    def serve_actor_inflight(self, actor_id_bytes: bytes) -> int:
        return self.wc.request(
            "driver_cmd", ("serve_actor_inflight", actor_id_bytes)
        )

    def serve_drain_actor(self, actor_id_bytes: bytes, timeout_s: float) -> dict:
        try:
            return self.wc.request(
                "serve_drain_actor", (actor_id_bytes, timeout_s),
                timeout=timeout_s + 10.0,
            )
        except TimeoutError:
            return {"ok": False, "inflight": -1}

    def dump_stacks(self, timeout_s=None):
        return self.wc.request(
            "dump_stacks", timeout_s, timeout=(timeout_s or 30.0) + 15.0
        )

    def profile_start(self, hz=None):
        return self.wc.request("profile_start", hz)

    def profile_collect(self):
        return self.wc.request("profile_collect", None, timeout=60.0)

    def memory_summary(self, payload=None):
        return self.wc.request("driver_cmd", ("memory_summary", payload))

    def task_events(self):
        return self.wc.request("driver_cmd", ("task_events", None))

    def task_latency(self):
        return self.wc.request("driver_cmd", ("task_latency", None))

    def push_spans(self, batch):
        self.wc.send_async(("cmd", "spans_push", batch))

    def list_spans(self, payload=None):
        return self.wc.request("driver_cmd", ("spans_list", payload))

    def query_series(self, payload):
        return self.wc.request("driver_cmd", ("query_series", payload))

    def cluster_events(self, payload=None):
        return self.wc.request("driver_cmd", ("cluster_events", payload))

    def list_alerts(self):
        return self.wc.request("driver_cmd", ("list_alerts", None))

    def obs_stats(self):
        return self.wc.request("driver_cmd", ("obs_stats", None))

    def list_actors(self, payload=None):
        return self.wc.request("driver_cmd", ("list_actors", payload))

    def list_tasks(self, limit=1000):
        return self.wc.request("driver_cmd", ("list_tasks", limit))

    def list_jobs(self):
        return self.wc.request("driver_cmd", ("list_jobs", None))

    def job_report(self, job):
        return self.wc.request("driver_cmd", ("job_report", job))

    def list_objects(self, limit=1000):
        return self.wc.request("driver_cmd", ("list_objects", limit))

    def autoscaler_state(self):
        return self.wc.request("driver_cmd", ("autoscaler_state", None))

    def free(self, ids):
        return self.wc.request("driver_cmd", ("free", ids))

    def cancel(self, task_id, force: bool):
        return self.wc.request("driver_cmd", ("cancel", (task_id, force)))

    def add_node(self, payload):
        return self.wc.request("driver_cmd", ("add_node", payload))

    def remove_node(self, node_id):
        return self.wc.request("driver_cmd", ("remove_node", node_id))

    def ref_ops(self, ops):
        # Pure bookkeeping, never latency-critical: ride the next flush.
        self.wc.batch.buffer(("ref_ops", ops))

    def stream_next(self, task_id_bytes: bytes, index: int,
                    timeout=None, blocking: bool = True):
        try:
            return self.wc.request(
                "stream_next", (task_id_bytes, index, blocking), timeout=timeout
            )
        except TimeoutError:
            raise exceptions.GetTimeoutError(
                f"stream_next timed out after {timeout}s"
            ) from None

    def reconstruct_object(self, key: bytes) -> ObjectMeta:
        return self.wc.request(
            "reconstruct_object", key, timeout=get_config().object_pull_timeout_s
        )

    def transfer_stats(self):
        return self.wc.request("driver_cmd", ("transfer_stats", None))

    def ensure_local(self, meta: ObjectMeta) -> ObjectMeta:
        from ray_tpu_torch._private import object_transfer
        from ray_tpu_torch._private.object_store import resolve_for_read

        def pull(key: bytes):
            try:
                return self.wc.request(
                    "pull_object", key, timeout=get_config().object_pull_timeout_s
                )
            except TimeoutError:
                raise exceptions.GetTimeoutError(
                    f"object pull timed out after {get_config().object_pull_timeout_s}s"
                ) from None

        def locate(key: bytes):
            return object_transfer.locate_via(
                self.wc.send, [key],
                timeout=get_config().object_pull_timeout_s,
            ).get(key)

        def note_replica(key: bytes):
            self.wc.send_async(("cmd", "object_replica",
                                (key, global_worker.store.node_id)))

        return resolve_for_read(
            global_worker.store, meta, pull, get_config().force_object_pulls,
            locate_fn=locate, transfer=global_worker.transfer,
            replica_fn=note_replica,
        )


class WorkerProcContext:
    """Context bound inside a worker process; all ops go over the pipe."""

    def __init__(self, runtime):
        self.rt = runtime  # worker_main.WorkerRuntime

    def submit(self, rec: TaskRecord):
        # One-way + coalescable: nested submissions from tasks pipeline
        # without acks and batch into one frame.
        self.rt.wc.send_async(("cmd", "submit", rec))

    def submit_fast(self, spec, return_ids, func_blob, dispatch_key):
        rec = fast_task_record(
            spec, (), {}, return_ids, func_blob, spec.max_retries, None
        )
        self.rt.wc.send_async(("cmd", "submit", rec))

    def submit_actor_task(self, req: ExecRequest):
        self.rt.wc.send_async(("cmd", "submit_actor_task", req))

    def create_actor(self, payload):
        self.rt.wc.request("create_actor", payload)

    def get_metas(self, ids, timeout):
        try:
            return self.rt.wc.request("get_metas", ids, timeout=timeout)
        except TimeoutError:
            raise exceptions.GetTimeoutError(
                f"get() timed out after {timeout}s"
            ) from None

    def wait(self, ids, num_returns, timeout):
        try:
            return self.rt.wc.request("wait", (ids, num_returns), timeout=timeout)
        except TimeoutError:
            peeked = self.rt.wc.request("peek_metas", ids)
            return list(peeked.keys())

    def put_meta(self, meta):
        if meta.segment is None and get_config().control_plane_batching:
            self.rt.wc.send_async(("cmd", "put_meta", meta))
            return None
        resp = self.rt.wc.request("put_meta", meta)
        return resp if resp is not True else None

    def kv(self, op, *args):
        return self.rt.wc.request("kv", (op, args))

    def get_actor_by_name(self, name):
        return self.rt.wc.request("get_actor_by_name", name)

    def kill_actor(self, actor_id, no_restart):
        return self.rt.wc.request("kill_actor", (actor_id, no_restart))

    def register_function(self, function_id, blob):
        pass  # workers attach blobs to submits instead

    def create_pg(self, pg_record):
        return self.rt.wc.request("create_pg", pg_record)

    def pg_ready(self, pg_id, timeout):
        try:
            return self.rt.wc.request("pg_ready", pg_id, timeout=timeout)
        except TimeoutError:
            return False

    def remove_pg(self, pg_id):
        return self.rt.wc.request("remove_pg", pg_id)

    def available_resources(self):
        return self.rt.wc.request("available_resources", None)

    def cluster_resources(self):
        return self.rt.wc.request("cluster_resources", None)

    def nodes(self, payload=None):
        return self.rt.wc.request("driver_cmd", ("get_nodes", payload))

    def serve_directory(self):
        return self.rt.wc.request("driver_cmd", ("serve_directory", None))

    def serve_actor_inflight(self, actor_id_bytes: bytes) -> int:
        return self.rt.wc.request(
            "driver_cmd", ("serve_actor_inflight", actor_id_bytes)
        )

    def serve_drain_actor(self, actor_id_bytes: bytes, timeout_s: float) -> dict:
        try:
            return self.rt.wc.request(
                "serve_drain_actor", (actor_id_bytes, timeout_s),
                timeout=timeout_s + 10.0,
            )
        except TimeoutError:
            return {"ok": False, "inflight": -1}

    def dump_stacks(self, timeout_s=None):
        return self.rt.wc.request(
            "dump_stacks", timeout_s, timeout=(timeout_s or 30.0) + 15.0
        )

    def profile_start(self, hz=None):
        return self.rt.wc.request("profile_start", hz)

    def profile_collect(self):
        return self.rt.wc.request("profile_collect", None, timeout=60.0)

    def memory_summary(self, payload=None):
        return self.rt.wc.request("driver_cmd", ("memory_summary", payload))

    def task_events(self):
        return self.rt.wc.request("driver_cmd", ("task_events", None))

    def task_latency(self):
        return self.rt.wc.request("driver_cmd", ("task_latency", None))

    def push_spans(self, batch):
        self.rt.wc.send_async(("cmd", "spans_push", batch))

    def list_spans(self, payload=None):
        return self.rt.wc.request("driver_cmd", ("spans_list", payload))

    def query_series(self, payload):
        return self.rt.wc.request("driver_cmd", ("query_series", payload))

    def cluster_events(self, payload=None):
        return self.rt.wc.request("driver_cmd", ("cluster_events", payload))

    def list_alerts(self):
        return self.rt.wc.request("driver_cmd", ("list_alerts", None))

    def obs_stats(self):
        return self.rt.wc.request("driver_cmd", ("obs_stats", None))

    def list_actors(self, payload=None):
        return self.rt.wc.request("driver_cmd", ("list_actors", payload))

    def list_tasks(self, limit=1000):
        return self.rt.wc.request("driver_cmd", ("list_tasks", limit))

    def list_jobs(self):
        return self.rt.wc.request("driver_cmd", ("list_jobs", None))

    def job_report(self, job):
        return self.rt.wc.request("driver_cmd", ("job_report", job))

    def list_objects(self, limit=1000):
        return self.rt.wc.request("driver_cmd", ("list_objects", limit))

    def autoscaler_state(self):
        return self.rt.wc.request("driver_cmd", ("autoscaler_state", None))

    def transfer_stats(self):
        return self.rt.wc.request("driver_cmd", ("transfer_stats", None))

    def free(self, ids):
        return []

    def cancel(self, task_id, force: bool):
        return self.rt.wc.request("driver_cmd", ("cancel", (task_id, force)))

    def ref_ops(self, ops):
        # Pure bookkeeping, never latency-critical: ride the next flush.
        self.rt.wc.batch.buffer(("ref_ops", ops))

    def stream_next(self, task_id_bytes: bytes, index: int,
                    timeout=None, blocking: bool = True):
        try:
            return self.rt.wc.request(
                "stream_next", (task_id_bytes, index, blocking), timeout=timeout
            )
        except TimeoutError:
            raise exceptions.GetTimeoutError(
                f"stream_next timed out after {timeout}s"
            ) from None

    def reconstruct_object(self, key: bytes) -> ObjectMeta:
        return self.rt.wc.request(
            "reconstruct_object", key, timeout=get_config().object_pull_timeout_s
        )

    def ensure_local(self, meta: ObjectMeta) -> ObjectMeta:
        return self.rt.ensure_local(meta)


def _connect_worker_process(runtime):
    """Called by worker_main to bind the module API to this worker process."""
    global_worker.mode = WORKER_MODE
    global_worker.store = runtime.store
    global_worker.transfer = runtime.transfer
    global_worker.context = WorkerProcContext(runtime)
    global_worker.job_id = JobID.from_int(1)
    set_config(runtime.args.config)

    # Current task id stays in sync for put-id minting: _execute sets it on
    # global_worker directly (one hot-path function call cheaper than the
    # wrapper this used to monkeypatch in).


# --------------------------------------------------------------------------- helpers
def _serialize_arg_entries(
    args: Sequence[Any], kwargs: Dict[str, Any]
) -> Tuple[List[Tuple[str, Any]], Dict[str, Tuple[str, Any]]]:
    """Top-level ObjectRef args become dependencies; everything else is serialized
    into the object store now (zero-copy for large arrays)."""
    if not args and not kwargs:
        return [], {}
    cfg = get_config()
    store = global_worker.store
    entries: List[Tuple[str, Any]] = []
    for a in args:
        if isinstance(a, ObjectRef):
            entries.append(("id", a.binary()))
        else:
            oid = global_worker.next_put_id()
            meta = store.put(oid, a, cfg.max_direct_call_object_size)
            entries.append(("meta", meta))
    kwentries: Dict[str, Tuple[str, Any]] = {}
    for k, a in kwargs.items():
        if isinstance(a, ObjectRef):
            kwentries[k] = ("id", a.binary())
        else:
            oid = global_worker.next_put_id()
            meta = store.put(oid, a, cfg.max_direct_call_object_size)
            kwentries[k] = ("meta", meta)
    metas = [m for kind, m in entries + list(kwentries.values()) if kind == "meta"]
    inline = sum(m.size for m in metas if m.segment is None)
    if inline > cfg.max_direct_call_object_size:
        # The inline args ride together in the task's frame.
        try:
            serialization.check_frame(inline, "the task's inline arguments",
                                      serialization.FRAME_HEADROOM)
        except exceptions.FrameTooLargeError:
            for m in metas:
                if m.segment is not None:
                    store.free(m)
            raise
    return entries, kwentries


def function_id_of(blob: bytes) -> str:
    return hashlib.sha1(blob).hexdigest()


# --------------------------------------------------------------------------- public API
def is_initialized() -> bool:
    return global_worker.mode is not None


def _auto_init():
    if global_worker.mode is None:
        init()


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    resources: Optional[Dict[str, float]] = None,
    namespace: Optional[str] = None,
    ignore_reinit_error: bool = False,
    log_to_driver: Optional[bool] = None,
    _system_config: Optional[dict] = None,
    **kwargs,
):
    """Start the runtime (driver mode). The analogue of `ray.init`
    (`python/ray/_private/worker.py:1115`): brings up the control
    plane (GCS + scheduler, in-process here) and registers this machine as the head
    node with auto-detected CPU/GPU/memory resources. GPUs are counted
    without creating a CUDA context (`detect_num_gpus`); `num_gpus` overrides
    the count, and a node without GPUs has no `GPU` resource."""
    if global_worker.mode is not None:
        if ignore_reinit_error:
            return RuntimeContext()
        raise RuntimeError("ray_tpu_torch.init() called twice; use ignore_reinit_error=True")

    if address is not None:
        return _init_client_mode(
            address,
            namespace=namespace,
            log_to_driver=True if log_to_driver is None else log_to_driver,
        )

    from ray_tpu_torch.util import tracing

    tracing.refresh_env()  # honor RAY_TPU_TORCH_TRACING set before init
    cfg = Config().apply_overrides(_system_config)
    if log_to_driver is not None:
        # Explicit kwarg wins; otherwise RAY_TPU_TORCH_log_to_driver /
        # _system_config (applied above) governs.
        cfg.log_to_driver = bool(log_to_driver)
    set_config(cfg)

    from ray_tpu_torch._private.accelerators import gpu as gpu_accel

    if num_cpus is None:
        # Give a useful default level of parallelism even on tiny hosts.
        num_cpus = float(max(os.cpu_count() or 1, 4))
    if num_gpus is None:
        num_gpus = float(gpu_accel.detect_num_gpus())
    node_resources = {"CPU": float(num_cpus)}
    if num_gpus:
        node_resources["GPU"] = float(num_gpus)
    node_resources["memory"] = float(cfg.object_store_memory)
    node_resources.update(resources or {})

    session_dir = os.path.join(
        "/dev/shm", f"ray_tpu_torch_session_{os.getpid()}_{int(time.time() * 1000)}"
    )
    os.makedirs(os.path.join(session_dir, "shm"), exist_ok=True)

    gcs = GCS()
    scheduler = Scheduler(gcs, cfg, session_dir)
    scheduler.start()
    head_labels = {"head": "1", **gpu_accel.node_topology_labels(num_gpus)}
    gpu_ids = gpu_accel.visible_gpu_ids(int(num_gpus or 0))
    head_node_id = scheduler.call("add_node", (node_resources, head_labels, gpu_ids)).result()

    global_worker.mode = DRIVER_MODE
    global_worker.job_id = JobID.from_int(1)
    global_worker.session_dir = session_dir
    global_worker.store = LocalObjectStore(
        os.path.join(session_dir, "shm"), node_id=head_node_id.binary()
    )
    from ray_tpu_torch._private.object_transfer import ObjectTransferManager

    global_worker.transfer = ObjectTransferManager(
        global_worker.store.shm_dir, cfg=cfg, authkey=scheduler.authkey
    )
    global_worker.context = DriverContext(scheduler)
    # Ownership decentralization: the scheduler loop delivers sealed metas of
    # driver-owned objects straight into this process's table (thread-safe).
    scheduler.inproc_meta_sink = global_worker.ownership.deliver_owned
    global_worker.namespace = namespace or "default"
    global_worker.node = scheduler
    global_worker._session_gen += 1
    _ref_tracker.reset()
    global_worker.ownership.reset()
    _start_ref_flusher()

    if cfg.log_to_driver:
        # Worker prints + error pushes stream to this driver (reference:
        # log_monitor -> GCS pubsub -> driver; here the scheduler publishes
        # on the "logs"/"errors" channels).
        scheduler.call("subscribe", ("logs", _print_worker_log)).result()
        scheduler.call("subscribe", ("errors", _print_worker_error)).result()

    atexit.register(_atexit_shutdown)
    return RuntimeContext()


def _print_worker_log(payload: dict) -> None:
    """Render one worker log push like the reference driver output:
    `(task_name pid=123) line`."""
    try:
        prefix = f"({payload.get('task') or 'worker'} pid={payload.get('pid')})"
        out = sys.stderr
        for line in payload.get("lines", ()):
            out.write(f"{prefix} {line}\n")
        out.flush()
    except Exception:  # noqa: BLE001 — never let log rendering break anything
        pass


def _print_worker_error(payload: dict) -> None:
    try:
        sys.stderr.write(
            f"({payload.get('type', 'Error')}) task {payload.get('task')}: "
            f"{payload.get('message')}\n"
        )
        sys.stderr.flush()
    except Exception:  # noqa: BLE001
        pass


def _init_client_mode(address: str, namespace: Optional[str],
                      log_to_driver: bool = True):
    """Connect this driver to an existing head server over TCP (`head.py`).
    The head's authkey must be in RAY_TPU_TORCH_AUTHKEY_HEX (printed by the head on
    startup; `cluster_utils.Cluster(real=True)` wires it automatically)."""
    import tempfile

    from ray_tpu_torch._private.ids import NodeID
    from ray_tpu_torch._private.worker_main import WorkerConnection
    from ray_tpu_torch._private.worker_entry import dial

    if not address.startswith("tcp://"):
        address = "tcp://" + address
    authkey = bytes.fromhex(os.environ.get("RAY_TPU_TORCH_AUTHKEY_HEX", ""))
    conn = dial(address, authkey)
    pull_node_id = NodeID.from_random()
    conn.send_bytes(serialization.dumps(("driver", {
        "pull_node_id": pull_node_id.hex(),
        # The head prunes this process's metrics::/spans:: KV snapshots (and
        # its stored series) when the driver disconnects.
        "pid": os.getpid(),
    })))
    reply = serialization.loads(conn.recv_bytes())
    if reply[0] != "ok":
        raise ConnectionError(f"head rejected driver connection: {reply!r}")
    info = reply[1]
    set_config(info["config"])
    from ray_tpu_torch.util import tracing

    # Same contract as in-proc init: honor RAY_TPU_TORCH_TRACING set after import
    # and re-read the (now head-owned) tracing knobs — the cluster samples
    # at the HEAD's trace_sample_rate, not this client's env.
    tracing.refresh_env()

    wc = WorkerConnection(conn)
    ctx = RemoteDriverContext(wc, address)

    def _reader():
        wc.reader_loop()
        # Head connection gone: wake any getter parked on the ownership
        # table (its own_meta can never arrive) so it falls through to the
        # context and surfaces a connection error instead of hanging.
        global_worker.ownership.reset()

    reader = threading.Thread(target=_reader, daemon=True, name="driver-reader")
    reader.start()

    head_shm = info["shm_dir"]
    if os.path.isdir(head_shm):
        # Colocated with the head: write into the head node's store directly so
        # its workers read our objects zero-copy.
        store = LocalObjectStore(head_shm, node_id=bytes.fromhex(info["head_node_id"]) or None)
        own_dir = None
    else:
        # Remote driver: own store dir; head routes pulls back over this conn.
        own_dir = tempfile.mkdtemp(prefix="ray_tpu_torch_driver_")
        store = LocalObjectStore(own_dir, node_id=pull_node_id.binary())

    global_worker.mode = DRIVER_MODE
    # The head mints a job id per attaching driver ("job_id" in the attach
    # reply); every id this driver creates embeds it, which is how all of
    # its usage is attributed with no per-message tags. Legacy heads without
    # the field fall back to the shared job 1.
    job_hex = info.get("job_id")
    global_worker.job_id = (
        JobID.from_hex(job_hex) if job_hex else JobID.from_int(1)
    )
    global_worker.session_dir = None  # owned by the head, not us
    global_worker.store = store
    from ray_tpu_torch._private.object_transfer import ObjectTransferManager

    global_worker.transfer = ObjectTransferManager(store.shm_dir)
    global_worker.context = ctx
    global_worker.namespace = namespace or "default"
    global_worker.node = None
    global_worker._client_tmp_dir = own_dir
    global_worker._session_gen += 1
    _ref_tracker.reset()
    global_worker.ownership.reset()
    _start_ref_flusher()

    if log_to_driver:
        wc.request("subscribe", "logs")
        wc.request("subscribe", "errors")

    atexit.register(_atexit_shutdown)
    return RuntimeContext()


def _atexit_shutdown():
    try:
        shutdown()
    except Exception:
        pass


def shutdown():
    """Tear down the runtime and unlink all shared-memory segments."""
    if global_worker.mode is None:
        return
    from ray_tpu_torch._private import usage

    usage.flush()
    if global_worker.mode == DRIVER_MODE:
        ctx = global_worker.context
        if isinstance(ctx, RemoteDriverContext):
            # Client mode: leave the head (and its session dir) running.
            ctx.close()
            if global_worker.store is not None:
                global_worker.store.detach_all()
            tmp = getattr(global_worker, "_client_tmp_dir", None)
            if tmp:
                shutil.rmtree(tmp, ignore_errors=True)
        else:
            try:
                ctx.scheduler.stop()
            except Exception:
                pass
            if global_worker.store is not None:
                global_worker.store.detach_all()
            if global_worker.session_dir:
                # scheduler.stop() above removed the spill dir.
                shutil.rmtree(global_worker.session_dir, ignore_errors=True)
    if global_worker.transfer is not None:
        try:
            global_worker.transfer.close()
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass
    global_worker.mode = None
    global_worker.context = None
    global_worker.store = None
    global_worker.transfer = None
    global_worker.node = None
    global_worker.session_dir = None
    global_worker._put_counter = 0
    global_worker._driver_task_id = None
    global_worker._session_gen += 1  # stop this session's ref flusher
    _ref_tracker.reset()
    global_worker.ownership.reset()
    # Function-registration cache is per-session: a new init() must re-ship blobs.
    from ray_tpu_torch import remote_function

    with remote_function._sent_lock:
        remote_function._sent_functions.clear()


def put(value: Any) -> ObjectRef:
    """Store an object and return a reference (reference: `worker.py:2551`).
    Raises ObjectStoreFullError when the node's sealed-segment bytes would
    exceed Config.object_store_memory; dropping ObjectRefs frees space."""
    _auto_init()
    if isinstance(value, ObjectRef):
        raise TypeError("Calling put() on an ObjectRef is not allowed.")
    # Flush queued releases first so freed space is visible to the capacity
    # check (keeps tight put-loops under the cap deterministically).
    flush_ref_ops()
    cfg = get_config()
    oid = global_worker.next_put_id()
    meta = global_worker.store.put(oid, value, cfg.max_direct_call_object_size)
    try:
        meta = global_worker.context.put_meta(meta) or meta
    except exceptions.ObjectStoreFullError:
        global_worker.store.free(meta)
        raise
    # This process owns the object: record the meta so a local get() resolves
    # in-process (put_meta may have returned a relocated/spilled meta).
    global_worker.ownership.deliver(meta)
    return ObjectRef(oid)


def _recover_lost_object(ctx, meta: ObjectMeta, first_err: BaseException):
    """Lost-segment path: the object is sealed but its bytes are gone (node
    died, file deleted, arena segment lost under a reader). The shared
    recovery loop in `_private/retry.py` reconstructs from lineage with a
    configurable budget and surfaces a typed ObjectLostError on exhaustion."""
    from ray_tpu_torch._private import retry

    return retry.reconstruct_object_with_retry(
        get_config(), meta,
        ctx.reconstruct_object,
        lambda m: global_worker.store.get(ctx.ensure_local(m)),
        first_err,
    )


def _resolve_metas(ids: List[bytes], timeout: Optional[float]) -> List[ObjectMeta]:
    """Owner-first meta resolution: objects this process owns answer from the
    in-process OwnershipTable (resolved now, or parked on its condition until
    the seal forward arrives) — zero head round trips, zero scheduler-thread
    hops. Any id the table doesn't cover (borrowed refs, pre-decentralization
    paths) falls back to the head's object directory."""
    table = global_worker.ownership
    metas = table.try_get_all(ids)
    if metas is not None:
        return metas
    # BLOCKING waits park on the local table only in driver processes. A
    # WORKER blocked in get() must go through the head so its CPU lease is
    # released while it waits (recursive task graphs deadlock otherwise —
    # the nested task needs this worker's slot to run).
    if global_worker.mode == DRIVER_MODE and table.covers(ids):
        # Tell the in-process scheduler a thread is parked owner-side (burst
        # coalescing yields; remote contexts have no deferral to yield).
        hint = getattr(global_worker.context, "note_owner_wait", None)
        if hint is not None:
            hint(1)
        try:
            metas = table.wait_all(ids, timeout)
        finally:
            if hint is not None:
                hint(-1)
        if metas is not None:
            return metas
        # None means timeout OR the entries left the table under us (session
        # reset / client reader death): only a still-covered wait is a real
        # timeout — otherwise fall through so the context surfaces its own
        # error (e.g. a closed head connection), not a bogus timeout.
        if timeout is not None and table.covers(ids):
            raise exceptions.GetTimeoutError(
                f"get() timed out after {timeout}s waiting for {len(ids)} object(s)"
            )
    return global_worker.context.get_metas(ids, timeout)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]], *, timeout: Optional[float] = None):
    """Fetch object values, raising remote errors (reference: `worker.py:2424`)."""
    _auto_init()
    single = isinstance(refs, ObjectRef)
    ref_list = [refs] if single else list(refs)
    for r in ref_list:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"get() expects ObjectRef(s), got {type(r)}")
    ids = [r.binary() for r in ref_list]
    metas = _resolve_metas(ids, timeout)
    values = []
    ctx = global_worker.context
    for meta in metas:
        try:
            value = global_worker.store.get(ctx.ensure_local(meta))
        except exceptions.GetTimeoutError:
            raise
        except (OSError, ConnectionError) as lost:
            # Segment bytes lost: reconstruct from lineage under the unified
            # retry policy (reference: ObjectRecoveryManager).
            meta, value = _recover_lost_object(ctx, meta, lost)
        if meta.is_error:
            if isinstance(value, exceptions.RayTaskError):
                raise value.as_instanceof_cause()
            raise value
        values.append(value)
    return values[0] if single else values


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
    fetch_local: bool = True,
) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    """Split refs into (ready, not_ready) (reference: `worker.py:2613`)."""
    _auto_init()
    refs = list(refs)
    if len(set(refs)) != len(refs):
        raise ValueError("wait() requires a list of unique ObjectRefs.")
    if num_returns > len(refs):
        raise ValueError("num_returns cannot exceed the number of refs.")
    ids = [r.binary() for r in refs]
    # Owner-side fast path: enough locally-resolved objects answer without a
    # head round trip (the table resolves as seal forwards arrive).
    table = global_worker.ownership
    local_ready = [i for i in ids if table.get_local(i) is not None]
    if len(local_ready) >= num_returns:
        ready_ids = set(local_ready)
    else:
        ready_ids = set(global_worker.context.wait(ids, num_returns, timeout))
    # At most num_returns refs are reported ready; the remainder (including any
    # extra already-finished ones) go to not_ready, per the reference contract.
    ready = [r for r in refs if r.binary() in ready_ids][:num_returns]
    ready_set = set(ready)
    not_ready = [r for r in refs if r not in ready_set]
    return ready, not_ready


def kill(actor, *, no_restart: bool = True):
    from ray_tpu_torch.actor import ActorHandle

    if not isinstance(actor, ActorHandle):
        raise TypeError("kill() expects an ActorHandle")
    global_worker.context.kill_actor(actor._actor_id, no_restart)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True):
    """Best-effort cancellation of a pending task (reference: `worker.py:2674`).
    Pending tasks are dropped; running non-actor tasks are killed with
    force=True. Works from the driver and from inside tasks/actors."""
    global_worker.context.cancel(ref.task_id, force)


def get_actor(name: str, namespace: Optional[str] = None):
    from ray_tpu_torch.actor import ActorHandle

    _auto_init()
    actor_id = global_worker.context.get_actor_by_name(name)
    if actor_id is None:
        raise ValueError(f"Failed to look up actor with name '{name}'")
    return ActorHandle(actor_id)


def available_resources() -> Dict[str, float]:
    _auto_init()
    return global_worker.context.available_resources()


def cluster_resources() -> Dict[str, float]:
    _auto_init()
    return global_worker.context.cluster_resources()


def nodes() -> List[dict]:
    _auto_init()
    return global_worker.context.nodes()


class RuntimeContext:
    """Returned by init(); also `ray_tpu_torch.get_runtime_context()`."""

    @property
    def job_id(self):
        return global_worker.job_id

    @property
    def current_task_id(self):
        return global_worker.current_task_id

    @property
    def current_actor_id(self):
        return global_worker.current_actor_id

    @property
    def was_current_actor_reconstructed(self) -> bool:
        return False

    @property
    def namespace(self) -> str:
        return global_worker.namespace

    def get_node_id(self) -> str:
        ns = global_worker.context.nodes() if global_worker.mode == DRIVER_MODE else []
        return ns[0]["node_id"] if ns else ""

    def get(self):
        return {
            "job_id": self.job_id,
            "task_id": self.current_task_id,
            "actor_id": self.current_actor_id,
        }


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext()
