"""Worker process: executes tasks and hosts actors.

The analogue of the reference's `default_worker.py` + the C++ core-worker task
execution loop (`python/ray/_private/workers/default_worker.py`,
`core_worker.cc:2525 ExecuteTask`, `_raylet.pyx:1168 task_execution_handler`).

Thread model: a reader thread drains the duplex pipe from the driver, routing
"exec" messages to the task queue and "resp" messages to the blocked requester;
the main thread executes tasks sequentially (actor ordering falls out of this,
like the reference's `ActorSchedulingQueue`).
"""

from __future__ import annotations

import os
import queue
import sys
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import failpoints, serialization, session_monitor
from ray_tpu_torch._private.config import Config, set_config
from ray_tpu_torch._private.ids import ActorID, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.object_store import LocalObjectStore, ObjectMeta
from ray_tpu_torch._private.protocol import ExecRequest


@dataclass
class WorkerArgs:
    worker_id_hex: str
    node_id_hex: str
    shm_dir: str
    session_name: str
    config: Config
    env_vars: Dict[str, str]
    is_actor_worker: bool = False
    # Applied once at startup (pip/working_dir/py_modules; see
    # _private/runtime_env.py); failures surface as RuntimeEnvSetupError on
    # every task this worker is asked to run.
    runtime_env: Optional[Dict[str, Any]] = None
    # "host:port" of the head's TCP listener, exported as RAY_TPU_TORCH_ADDRESS so
    # subprocesses a task launches (e.g. job-submission entrypoints) can join
    # the cluster as client drivers.
    head_address: Optional[str] = None


# Hard-close for the failpoint "close" action and send-failure cleanup: the
# ONE implementation (dup-fd shutdown(SHUT_RDWR) so a blocked reader sees a
# real EOF) lives with the data plane, which needs the same teardown.
from ray_tpu_torch._private.object_transfer import (  # noqa: E402
    PRIORITY_TASK_ARGS,
    _abrupt_close,
)

# Lazily-bound runtime modules for the exec hot path: importing them at
# module top would close an import cycle (scheduler -> worker_main ->
# worker -> scheduler), and a per-task function-level import pays the
# sys.modules + fromlist machinery on every execution.
_worker_mod = None
_exceptions = None


def _runtime_mods():
    global _worker_mod, _exceptions
    if _worker_mod is None:
        from ray_tpu_torch import exceptions as _e
        from ray_tpu_torch._private import worker as _w

        _worker_mod = _w
        _exceptions = _e
    return _worker_mod, _exceptions


class WorkerConnection:
    """Request/response multiplexing over the driver pipe.

    Outbound traffic goes through a per-connection BatchedSender: one-way
    messages (cmd submits, dones, stream items, ref ops) coalesce into
    ("batch", [msgs]) frames; blocking requests flush first, so FIFO holds
    and get/wait latency never waits on the flush timer (batching.py)."""

    def __init__(self, conn):
        from ray_tpu_torch._private.batching import BatchedSender

        self.conn = conn
        self.batch = BatchedSender(
            conn.send_bytes, close_fn=lambda: _abrupt_close(conn)
        )
        self._req_lock = threading.Lock()
        self._next_req_id = 0
        self._pending: Dict[int, "queue.SimpleQueue"] = {}
        self.task_queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._closed = threading.Event()
        # Task ids the scheduler cancelled while they were lease-queued here:
        # the dispatch loop drops them unrun (the scheduler already sealed
        # their results; no "done" is expected). Insertion-ordered and bounded:
        # a cancel_queued can race a task this worker already popped and ran
        # (the scheduler's current_task view lags batched dones), in which case
        # the entry never matches and would otherwise pin memory forever —
        # task ids are unique, so evicting stale entries is always safe.
        # _cancelled_lock guards mutation from both the reader thread
        # (add + evict) and the dispatch loop (pop on match) — an unlocked
        # evict's next(iter(...)) can see the dict resize mid-iteration.
        self.cancelled: Dict[bytes, None] = {}
        self._cancelled_lock = threading.Lock()
        # Hook for message kinds beyond exec/resp/shutdown (e.g. a client-mode
        # driver serving "read_object" pulls for objects it put).
        self.misc_handler = None
        # Data-plane prefetch hook: called with each queued ExecRequest so
        # the transfer manager can start pulling its remote args at PREFETCH
        # priority while earlier tasks still run (reference: pull_manager.h
        # prefetch lane). Must never block the reader thread.
        self.prefetch_hook = None
        # Introspection hook: returns this process's all-thread stack payload
        # (worker_loop binds it with task annotations from the runtime). The
        # reader thread serves dump_stacks itself — it stays responsive while
        # the main thread runs user code, which is the whole point.
        self.introspect_fn = None
        # Back-reference to this process's WorkerRuntime (set by main()): the
        # serve_drain handler reaches the hosted actor instance through it.
        self.runtime = None
        # Worker processes die with their control connection: once the head is
        # unreachable nothing can collect results, and a task stuck in user code
        # (e.g. a long sleep) would otherwise outlive its node daemon forever.
        # Drivers leave this False — an EOF there surfaces as request errors.
        self.exit_on_eof = False

    def send(self, msg) -> None:
        """Ordered send: flushes buffered messages first (BatchedSender)."""
        self.batch.send(msg)

    def send_async(self, msg) -> None:
        """Coalescable fire-and-forget send."""
        self.batch.send_async(msg)

    def flush_batch(self) -> None:
        self.batch.flush()

    def send_done(self, payload: tuple, batch: bool = False,
                  nbytes: int | None = None) -> None:
        """Send (or buffer) one task-completion payload. Completion order
        must reach the scheduler in execution order (lease accounting
        transfers on each done); the shared batch buffer preserves it, and
        an immediate send flushes first by construction. batch=True defers
        to the dispatch loop's queue-empty flush (pure buffering): a
        pipelined run of N tasks pays one frame, not N. `nbytes` carries the
        result-payload size the executor already computed, skipping the
        generic message-size estimator on the completion hot path."""
        if batch:
            self.batch.buffer(("done",) + payload, nbytes=nbytes)
        else:
            self.send(("done",) + payload)

    def request(self, method: str, payload: Any, timeout: float | None = None) -> Any:
        """Blocking control-plane RPC to the driver (e.g. get/wait/submit)."""
        with self._req_lock:
            req_id = self._next_req_id
            self._next_req_id += 1
            q: "queue.SimpleQueue" = queue.SimpleQueue()
            self._pending[req_id] = q
        if session_monitor.ENABLED:
            session_monitor.expect("req", req_id)
        self.send(("req", req_id, method, payload))
        try:
            ok, result = q.get(timeout=timeout)
        except queue.Empty:
            with self._req_lock:
                self._pending.pop(req_id, None)
            if session_monitor.ENABLED:
                session_monitor.forget("req", req_id)
            raise TimeoutError(f"request {method} timed out after {timeout}s") from None
        if not ok:
            raise result
        return result

    def _dispatch(self, msg) -> bool:
        """Route one control message; False stops the reader (shutdown)."""
        kind = msg[0]
        if session_monitor.ENABLED:
            # One physical connection serves worker.dispatch tags and — for
            # client-mode drivers (misc_handler installed) — driver.misc ones.
            session_monitor.check_tag(
                ("worker.dispatch", "driver.misc") if self.misc_handler
                else "worker.dispatch", kind,
            )
        if kind == "exec":
            self.task_queue.put(msg[1])
            if self.prefetch_hook is not None:
                try:
                    self.prefetch_hook(msg[1])
                except Exception:  # noqa: BLE001 — prefetch is best-effort
                    pass
        elif kind == "own_meta":
            # Seal forward for an object THIS process owns (it submitted the
            # creating task): resolve it in the local ownership table so
            # get() answers without a head round trip.
            from ray_tpu_torch._private import worker as worker_mod

            worker_mod.global_worker.ownership.deliver_owned(msg[1])
        elif kind == "object_locations":
            from ray_tpu_torch._private import object_transfer

            object_transfer.deliver_locations(msg[1], msg[2])
        elif kind == "resp":
            _, req_id, ok, payload = msg
            if session_monitor.ENABLED:
                session_monitor.resolve("resp", req_id)
            with self._req_lock:
                q = self._pending.pop(req_id, None)
            if q is not None:
                q.put((ok, payload))
        elif kind == "dump_stacks":
            self.send(("stacks_data", msg[1], self._introspect_payload()))
        elif kind == "profile_start":
            from ray_tpu_torch._private import profiler

            profiler.start(msg[1])
        elif kind == "profile_stop":
            from ray_tpu_torch._private import profiler

            self.send(("profile_data", msg[1], profiler.stop()))
        elif kind == "serve_drain":
            self._begin_serve_drain(msg[1], msg[2])
        elif kind == "cancel_queued":
            with self._cancelled_lock:
                self.cancelled[msg[1]] = None
                while len(self.cancelled) > 1024:
                    self.cancelled.pop(next(iter(self.cancelled)), None)
        elif kind == "shutdown":
            self.task_queue.put(None)
            return False
        elif self.misc_handler is not None:
            self.misc_handler(msg)
        return True

    def _begin_serve_drain(self, token, deadline_s) -> None:
        """Graceful drain of the Serve actor hosted here, driven IN-BAND by
        the reader thread: the stop-accepting flag must be set ahead of any
        queued actor calls (an ordinary actor call would park behind the very
        requests being drained on a max_concurrency=1 replica). The wait for
        in-flight work happens on a side thread; the reader stays free."""
        rt = self.runtime
        inst = getattr(rt, "actor_instance", None) if rt is not None else None
        begin = getattr(inst, "_serve_begin_drain", None)
        gauge = getattr(inst, "_serve_inflight", None)
        if begin is not None:
            try:
                begin()
            except Exception:  # noqa: BLE001 — drain must still reply
                pass
        if gauge is None:
            # Nothing drainable hosted here: idle by definition.
            self.send(("serve_drained", token, True, 0))
            return

        def wait_drained():
            deadline = time.monotonic() + float(deadline_s)
            # Sample BEFORE the deadline loop: a zero/expired deadline must
            # report the true in-flight count, never a phantom clean drain.
            try:
                left = int(gauge())
            except Exception:  # noqa: BLE001 — treat as idle
                left = 0
            while left > 0 and time.monotonic() < deadline:
                time.sleep(0.02)
                try:
                    left = int(gauge())
                except Exception:  # noqa: BLE001 — treat as idle
                    left = 0
            try:
                self.send(("serve_drained", token, left <= 0, max(0, left)))
            except Exception:  # noqa: BLE001 — connection gone
                pass

        threading.Thread(
            target=wait_drained, daemon=True, name="serve-drain"
        ).start()

    def _introspect_payload(self):
        from ray_tpu_torch._private import introspection

        if self.introspect_fn is not None:
            try:
                return self.introspect_fn()
            except Exception as e:  # noqa: BLE001 — a dump must never kill the reader
                return {"transport": "inband", "error": repr(e),
                        "pid": os.getpid(), "threads": []}
        return introspection.thread_stacks()

    def reader_loop(self):
        try:
            while True:
                data = self.conn.recv_bytes()
                if failpoints.ENABLED and failpoints.inject_recv(
                    "conn.recv", lambda: _abrupt_close(self.conn)
                ) == "drop":
                    continue  # frame discarded by the failpoint
                msg = serialization.loads(data)
                if msg[0] == "batch":
                    # Coalesced frame: process every contained message before
                    # returning to the pipe (one wakeup per burst).
                    alive = True
                    for m in msg[1]:
                        alive = self._dispatch(m) and alive
                    if not alive:
                        return
                elif not self._dispatch(msg):
                    return
        except (EOFError, OSError):
            if self.exit_on_eof:
                os._exit(1)
        finally:
            self._closed.set()
            self.batch.close()
            self.task_queue.put(None)
            # Unblock anyone waiting on a response: the driver is gone.
            with self._req_lock:
                for q in self._pending.values():
                    q.put((False, ConnectionError("driver connection closed")))
                self._pending.clear()


def _serve_runtime():
    """This process's WorkerRuntime, or None outside a worker process (unit
    tests constructing serve actors in-proc have no control connection)."""
    from ray_tpu_torch._private import worker as worker_mod

    return getattr(worker_mod.global_worker.context, "rt", None)


def announce_serve_proxy(info: dict) -> bool:
    """Register this worker's Serve HTTP proxy in the head's service
    directory (the reference's per-node proxy set in http_state.py). The
    node id is filled in here — the proxy actor doesn't know where the
    controller placed it. Returns False outside a worker process."""
    rt = _serve_runtime()
    if rt is None:
        return False
    entry = dict(info)
    entry.setdefault("node_id", rt.args.node_id_hex)
    rt.wc.send(("serve_proxy_up", entry))
    return True


def withdraw_serve_proxy(proxy_id: str) -> bool:
    """Remove a proxy from the head's service directory (drain/stop)."""
    rt = _serve_runtime()
    if rt is None:
        return False
    rt.wc.send(("serve_proxy_down", proxy_id))
    return True


# Cumulative log lines dropped by this process's _LogShipper overflow path:
# a plain int on the hot printing path, exported as
# ray_tpu_log_lines_dropped_total by telemetry.ensure_logshipper_metrics.
_LOG_STATS = {"dropped": 0}


class _LogShipper:
    """Out-of-band line shipper: a bounded queue drained by a daemon thread.

    The task thread must NEVER write to the control pipe directly — while a
    task runs, the worker's reader thread is the only drainer of head->worker
    traffic, and a synchronous send from inside the task could deadlock
    against a scheduler blocked writing to this same worker. Overflow drops
    lines (counted in _LOG_STATS and surfaced both as a "...dropped" text
    line and the ray_tpu_log_lines_dropped_total counter) rather than
    blocking the printer.
    """

    MAX_LINES = 10_000

    def __init__(self, wc: "WorkerConnection", worker_id_hex: str):
        import collections

        self._wc = wc
        self._worker_id_hex = worker_id_hex
        self._q: "collections.deque" = collections.deque(maxlen=self.MAX_LINES)
        self._dropped = 0
        self._event = threading.Event()
        threading.Thread(target=self._drain, daemon=True, name="log-ship").start()

    def enqueue(self, stream: str, task_name: str, lines) -> None:
        if len(self._q) >= self.MAX_LINES:
            self._dropped += len(lines)
            _LOG_STATS["dropped"] += len(lines)
            return
        self._q.append((stream, task_name, lines))
        self._event.set()

    def _drain(self) -> None:
        while True:
            self._event.wait()
            self._event.clear()
            while self._q:
                try:
                    stream, task_name, lines = self._q.popleft()
                except IndexError:
                    break
                if self._dropped:
                    lines = lines + [f"... ({self._dropped} log lines dropped)"]
                    self._dropped = 0
                try:
                    self._wc.send(
                        (
                            "log",
                            self._worker_id_hex,
                            os.getpid(),
                            stream,
                            task_name,
                            lines,
                        )
                    )
                except Exception:  # noqa: BLE001 — head gone; logs die quietly
                    return


class _TeeStream:
    """stdout/stderr wrapper: lines keep flowing to the worker's log file AND
    stream to the head (via the out-of-band _LogShipper), which the scheduler
    publishes on the "logs" pubsub channel to subscribed drivers.

    Reference: `python/ray/_private/log_monitor.py:104` tails worker log
    files into GCS pubsub; the single-owner redesign ships lines up the
    control conn — no file tailing, no extra process.
    """

    MAX_TAIL = 8192  # newline-free output (progress bars) flushes in chunks

    def __init__(self, orig, shipper: _LogShipper, rt: "WorkerRuntime",
                 stream_name: str):
        self._orig = orig
        self._shipper = shipper
        self._rt = rt
        self._stream = stream_name
        self._tail = ""

    def write(self, data):
        n = self._orig.write(data)
        try:
            self._tail += data
            lines = []
            if "\n" in self._tail:
                *lines, self._tail = self._tail.split("\n")
            if len(self._tail) > self.MAX_TAIL:
                # No newline in sight (e.g. \r progress bars): ship the chunk
                # rather than growing without bound.
                lines.append(self._tail[: self.MAX_TAIL])
                self._tail = self._tail[self.MAX_TAIL:]
            lines = [l for l in lines if l.strip()]
            if lines:
                self._shipper.enqueue(
                    self._stream, self._rt.current_task_name, lines
                )
        except Exception:  # noqa: BLE001 — a print must never kill a task
            pass
        return n

    def writelines(self, lines):
        for line in lines:
            self.write(line)

    def flush(self):
        self._orig.flush()

    def __getattr__(self, name):
        return getattr(self._orig, name)


def _install_output_tee(wc: "WorkerConnection", rt: "WorkerRuntime",
                        worker_id_hex: str) -> None:
    shipper = _LogShipper(wc, worker_id_hex)
    sys.stdout = _TeeStream(sys.stdout, shipper, rt, "stdout")
    sys.stderr = _TeeStream(sys.stderr, shipper, rt, "stderr")
    if rt.args.config.enable_metrics:
        from ray_tpu_torch._private.telemetry import ensure_logshipper_metrics

        ensure_logshipper_metrics()


class WorkerRuntime:
    """Per-process runtime state: object store facade, function cache, actor."""

    def __init__(self, args: WorkerArgs, wc: WorkerConnection):
        from ray_tpu_torch._private.object_transfer import ObjectTransferManager

        self.args = args
        self.wc = wc
        self.store = LocalObjectStore(args.shm_dir, node_id=bytes.fromhex(args.node_id_hex))
        # Pull half of the peer-to-peer data plane: remote segments stream
        # straight from the holder node's data server into this node's store
        # cache (chunked, priority-admitted, deduped across concurrent
        # readers); the head relay is the fallback only.
        self.transfer = ObjectTransferManager(args.shm_dir, cfg=args.config)
        self.functions: Dict[str, Any] = {}
        self.actor_instance: Any = None
        self.actor_id: Optional[ActorID] = None
        self.current_task_id: Optional[TaskID] = None
        self.current_task_name: str = ""
        # thread ident -> task/method name executing there, for stack-dump
        # annotation (threaded actors run several at once; the map says which
        # thread carries which call).
        self.executing: Dict[int, str] = {}
        self._put_counter = 0
        # Threaded actors (max_concurrency > 1): calls drain through a bounded
        # pool of daemon threads, out of submission order (reference: threaded
        # actors, `transport/concurrency_group_manager.h`).
        self.concurrency: int = 1
        self._call_queue = None
        # Named concurrency groups: group name -> its own SimpleQueue, each
        # drained by that group's dedicated threads. Isolation is the point:
        # a saturated group must never block another group's calls
        # (reference: `transport/concurrency_group_manager.h`).
        self._group_queues: Dict[str, Any] = {}
        # Lazily-started event loop for `async def` actor methods (reference:
        # asyncio actors, `core_worker/fiber.h`).
        self._aio_loop = None
        self._aio_lock = threading.Lock()
        # Set when runtime_env provisioning failed: every task errors with it.
        self.setup_error: Optional[BaseException] = None
        # Per-task streamed-item count (generator tasks), keyed by task id
        # bytes: the error path seals the failure at the right stream index.
        # A dict (not a scalar) because threaded actors execute concurrently.
        self.stream_progress: Dict[bytes, int] = {}

    def next_put_index(self) -> int:
        self._put_counter += 1
        return self._put_counter

    def enable_concurrency(self, n: int, groups: Optional[Dict[str, int]] = None) -> None:
        self.concurrency = n
        if n > 1 or groups:
            # n daemon threads draining one queue: bounded concurrency without
            # spawning a thread per queued call, and the dispatch loop never
            # blocks (a stdlib ThreadPoolExecutor's non-daemon threads would
            # also stall interpreter exit while calls are parked in long polls).
            self._call_queue = self._start_pool("default", max(1, n))
            for gname, limit in (groups or {}).items():
                self._group_queues[gname] = self._start_pool(gname, max(1, int(limit)))

    def _start_pool(self, label: str, n: int) -> "queue.SimpleQueue":
        q: "queue.SimpleQueue" = queue.SimpleQueue()

        def drain():
            while True:
                fn = q.get()
                fn()

        for i in range(n):
            threading.Thread(
                target=drain, daemon=True, name=f"actor-call-{label}-{i}"
            ).start()
        return q

    def submit_call(self, fn, group: Optional[str] = None) -> None:
        # Unknown group names fall back to the default pool rather than
        # erroring inside the dispatch loop; the call still runs.
        q = self._group_queues.get(group, self._call_queue) if group else self._call_queue
        q.put(fn)

    def run_coroutine(self, coro):
        """Drive an async actor method to completion on this actor's event
        loop. Coroutines from concurrent calls interleave on the one loop.

        The CALLING thread's trace context (the task's execute span) rides
        along as the coroutine's ambient context: the loop thread's
        thread-local slot can't carry it, and each wrapped coroutine is its
        own asyncio task with its own contextvar copy, so concurrent calls
        never see each other's context."""
        import asyncio

        with self._aio_lock:
            if self._aio_loop is None:
                loop = asyncio.new_event_loop()
                t = threading.Thread(target=loop.run_forever, daemon=True, name="actor-aio")
                t.start()
                self._aio_loop = loop
        from ray_tpu_torch.util import tracing

        ctx = tracing.current_trace_context() if tracing.is_enabled() else None
        if ctx is not None:
            async def _with_ctx(c=coro, ctx=ctx):
                with tracing.context_scope(ctx):
                    return await c

            coro = _with_ctx()
        return asyncio.run_coroutine_threadsafe(coro, self._aio_loop).result()

    def locate_many(self, keys) -> dict:
        """Batched location-directory query over the control connection
        (locate_object/object_locations tags)."""
        from ray_tpu_torch._private import object_transfer

        return object_transfer.locate_via(
            self.wc.send, list(keys),
            timeout=self.args.config.object_pull_timeout_s,
        )

    def prefetch_args(self, req: ExecRequest) -> None:
        """Queued-task argument prefetch: start pulling remote arg segments
        at PREFETCH priority while earlier tasks still run. Runs on the
        reader thread — everything heavier than the enqueue happens on the
        transfer manager's prefetch thread."""
        metas = [
            m for m in
            list(req.arg_metas) + list(req.kwarg_metas.values())
            # Own-node args never transfer, whatever the force_object_pulls
            # testing knob says (matching resolve_for_read's remote check).
            if m is None or m.node_id != self.store.node_id
        ]
        self.transfer.prefetch(metas, self.locate_many)

    def ensure_local(self, meta: ObjectMeta, priority=None) -> ObjectMeta:
        """Make a segment-backed object readable on this node, streaming the
        bytes PEER-DIRECT from a holder node's data server in bounded chunks
        (the reader side of the reference's PullManager, `pull_manager.h:52`),
        else relaying through the head."""
        from ray_tpu_torch._private.object_store import resolve_for_read

        def pull(key: bytes):
            return self.wc.request(
                "pull_object", key, timeout=self.args.config.object_pull_timeout_s
            )

        def locate(key: bytes):
            return self.locate_many([key]).get(key)

        def note_replica(key: bytes):
            # This node now holds a cached copy: register it in the head's
            # location directory so other nodes can pull from here.
            self.wc.send_async(("cmd", "object_replica", (key, self.store.node_id)))

        return resolve_for_read(
            self.store, meta, pull, self.args.config.force_object_pulls,
            locate_fn=locate, transfer=self.transfer, priority=priority,
            replica_fn=note_replica,
        )

    def fetch_value(self, meta: ObjectMeta, priority=None):
        """Read an object value, reconstructing from lineage if its bytes were
        lost (reference: ObjectRecoveryManager re-submitting the creating
        task). The shared recovery loop in `_private/retry.py` runs the
        reconstruction under the unified policy and surfaces a typed
        ObjectLostError on budget exhaustion."""
        try:
            return self.store.get(self.ensure_local(meta, priority=priority))
        except (OSError, ConnectionError) as first_err:
            from ray_tpu_torch._private import retry

            cfg = self.args.config
            _fresh, value = retry.reconstruct_object_with_retry(
                cfg, meta,
                lambda key: self.wc.request(
                    "reconstruct_object", key, timeout=cfg.object_pull_timeout_s
                ),
                lambda m: self.store.get(self.ensure_local(m, priority=priority)),
                first_err,
            )
            return value

    def load_function(self, function_id: str, blob: Optional[bytes]):
        fn = self.functions.get(function_id)
        if fn is not None:
            return fn
        if blob is None:
            blob = self.wc.request("fetch_function", function_id)
        fn = serialization.loads(blob)
        self.functions[function_id] = fn
        return fn


def _run_generator(rt: WorkerRuntime, req: ExecRequest, out, progress: Dict[bytes, int]):
    """Drive a generator task: seal each yielded value as its own object and
    report it to the control plane immediately, so consumers can read items
    before the task finishes (reference: streaming generator returns,
    `core_worker/task_manager.cc HandleReportGeneratorItemReturns`).

    Returns the ObjectIDs of the yielded items. Exceptions from the user
    generator propagate to the caller with `progress` holding the failing
    index."""
    import inspect

    spec = req.spec
    cfg = rt.args.config
    if inspect.isasyncgen(out):
        agen = out

        def _drive(ag):
            while True:
                try:
                    yield rt.run_coroutine(ag.__anext__())
                except StopAsyncIteration:
                    return

        out = _drive(agen)
    if not hasattr(out, "__iter__") and not hasattr(out, "__next__"):
        raise TypeError(
            f"Task {spec.name or spec.func.name} declared "
            f"num_returns={spec.returns_mode!r} but returned a non-iterable "
            f"{type(out).__name__}"
        )
    # Item object ids start at index 2 for "dynamic" (index 1 is the handle
    # the outer ObjectRef resolves to) and at 1 for "streaming".
    base = 2 if spec.returns_mode == "dynamic" else 1
    key = spec.task_id.binary()
    window = spec.generator_backpressure
    item_oids = []
    for v in out:
        oid = ObjectID.for_return(spec.task_id, base + len(item_oids))
        sv = serialization.serialize(v)
        meta = rt.store.put_serialized(oid, sv, cfg.max_direct_call_object_size)
        # Coalescable: a fast producer's items batch; the consumer-side
        # latency bound is the sub-ms flush timer (and any blocking request
        # — e.g. the throttle below — flushes first).
        rt.wc.send_async(("stream", key, len(item_oids), meta))
        item_oids.append(oid)
        progress[key] = len(item_oids)
        if window is not None and len(item_oids) >= window:
            # Producer-side backpressure: pause until the consumer has asked
            # for the item `window` positions back (bounds store growth for
            # fast producers / slow consumers). "stop" means the consumer
            # dropped the stream: abandon the generator gracefully.
            verdict = rt.wc.request("stream_throttle", (key, len(item_oids) - window))
            if verdict == "stop":
                break
    return item_oids


def _execute(rt: WorkerRuntime, req: ExecRequest, batch_done: bool = False):
    worker_mod, exceptions = _runtime_mods()

    spec = req.spec
    rt.current_task_id = spec.task_id
    rt.current_task_name = spec.name or spec.func.name
    rt.executing[threading.get_ident()] = rt.current_task_name
    # Put-id minting and lineage attribution key off the module-level worker
    # state too (per-thread: threaded actors run concurrent calls).
    worker_mod.global_worker.current_task_id = spec.task_id
    # Job identity rides the task id (ids.py embedding): nested submits and
    # puts made DURING execution mint ids under the calling job, so the
    # head's ledger attributes them to the right tenant.
    worker_mod.global_worker.job_id = spec.task_id.actor_id.job_id
    cfg = rt.args.config
    if spec.env_vars:
        for k, v in spec.env_vars.items():
            os.environ[k] = v
        if "RAY_TPU_TORCH_TRACING" in spec.env_vars:
            from ray_tpu_torch.util import tracing

            tracing.refresh_env()  # is_enabled() caches the environ flag
    exec_span = None
    if spec.trace_context is not None:
        from ray_tpu_torch.util import tracing

        exec_span = tracing.start_span(
            f"execute::{spec.name or spec.func.name}",
            "execute",
            trace_context=spec.trace_context,
            attributes={"task_id": spec.task_id.hex()},
        )
    # Worker-side lifecycle stages (args_fetched / exec_start / exec_end /
    # result_stored): ride back on the done message — zero extra round trips.
    # Stamped for enable_metrics too: the scheduler's exec-time histogram is
    # fed from these stamps even when the timeline/event store is off.
    stages = {} if (cfg.enable_timeline or cfg.enable_metrics) else None
    try:
        if rt.setup_error is not None:
            raise exceptions.RuntimeEnvSetupError(
                f"runtime_env setup failed for this worker: {rt.setup_error!r}"
            )
        if failpoints.ENABLED:
            # Partial-failure injection: die before any argument bytes are
            # touched — the task must retry cleanly with its deps re-pinned.
            failpoints.maybe_crash("worker.crash_before_args_fetched")
        args = [rt.fetch_value(m, priority=PRIORITY_TASK_ARGS)
                for m in req.arg_metas]
        kwargs = {k: rt.fetch_value(m, priority=PRIORITY_TASK_ARGS)
                  for k, m in req.kwarg_metas.items()}
        if stages is not None:
            # exec_start follows immediately: first-call function deserialize
            # is accounted to exec, keeping the stamp count per task at four.
            stages["args_fetched"] = stages["exec_start"] = time.time()
        # Resolve any ObjectRefs that arrived as *resolved values already* — the
        # driver substitutes top-level refs with their value metas, so nothing to
        # do here; nested refs were rebuilt by the unpickler as live ObjectRefs.
        if spec.is_actor_creation:
            cls = rt.load_function(spec.func.function_id, req.func_blob)
            rt.actor_instance = cls(*args, **kwargs)
            rt.actor_id = spec.actor_id
            rt.enable_concurrency(
                getattr(spec, "max_concurrency", 1),
                getattr(spec, "concurrency_groups", None),
            )
            worker_mod._set_current_actor_id(spec.actor_id)
            results = [None] * spec.num_returns if spec.num_returns else []
            out = None
        elif spec.actor_id is not None:
            if spec.method_name == "__ray_ready__":
                out = True
            elif spec.method_name == "__ray_terminate__":
                rt.wc.task_queue.put(None)
                out = None
            else:
                method = getattr(rt.actor_instance, spec.method_name)
                out = method(*args, **kwargs)
                import inspect

                if inspect.iscoroutine(out):
                    out = rt.run_coroutine(out)
        else:
            fn = rt.load_function(spec.func.function_id, req.func_blob)
            out = fn(*args, **kwargs)
        # Split returns.
        n = spec.num_returns
        if spec.is_actor_creation:
            values = []
        elif spec.returns_mode is not None:
            item_oids = _run_generator(rt, req, out, rt.stream_progress)
            if spec.returns_mode == "dynamic":
                # The outer ref resolves to a picklable generator of the item
                # refs; pickling notes them as contained ids, which pins the
                # items to the handle's lifetime.
                values = [worker_mod.DynamicObjectRefGenerator(
                    [worker_mod.ObjectRef(oid) for oid in item_oids]
                )]
            else:
                values = []
        elif n == 1:
            values = [out]
        elif n == 0:
            values = []
        else:
            values = list(out)
            if len(values) != n:
                raise ValueError(
                    f"Task {spec.name} declared num_returns={n} but returned "
                    f"{len(values)} values"
                )
        if stages is not None:
            stages["exec_end"] = time.time()
        if failpoints.ENABLED:
            # Crash AFTER the user code ran but before any result byte is
            # stored: the work is done yet invisible — exactly the window the
            # exec_end/result_stored pipeline makes observable.
            failpoints.maybe_crash("worker.crash_after_exec_end")
        metas = []
        done_nbytes = 96
        for oid, value in zip(req.return_ids, values):
            sv = serialization.serialize(value)
            meta = rt.store.put_serialized(oid, sv, cfg.max_direct_call_object_size)
            metas.append(meta)
            if meta.segment is None:
                # Only inline payloads ride IN the done frame; a segment-
                # backed meta is ~200 wire bytes however big the object —
                # counting meta.size would trip the batch byte threshold on
                # every completion and defeat done coalescing.
                done_nbytes += meta.size
            else:
                done_nbytes += 160
        if failpoints.ENABLED:
            # Crash with results IN the store but the done message unsent:
            # the scheduler must treat the task as dead (segments orphaned),
            # and the retry must overwrite them without corruption.
            failpoints.maybe_crash("worker.crash_before_result_stored")
        if stages is not None:
            stages["result_stored"] = time.time()
        # Flush refcount ops BEFORE "done": pipe FIFO guarantees any borrower
        # registration this task made reaches the scheduler before its
        # dependency pins are released.
        worker_mod.flush_ref_ops()
        done = (spec.task_id.binary(), True, metas)
        rt.wc.send_done(done if stages is None else done + (stages,),
                        batch=batch_done, nbytes=done_nbytes)
    except Exception as e:  # noqa: BLE001 — every task error must be captured
        if exec_span is not None:
            from ray_tpu_torch.util import tracing

            tracing.end_span(exec_span, "ERROR")
            exec_span = None
        tb = traceback.format_exc()
        err = exceptions.RayTaskError(
            function_name=spec.name or spec.func.name,
            traceback_str=tb,
            cause=e,
            pid=os.getpid(),
        )
        metas = []
        try:
            sv = serialization.serialize(err)
        except Exception:
            sv = serialization.serialize(
                exceptions.RayTaskError(spec.func.name, tb, None, os.getpid())
            )
        if spec.returns_mode == "streaming":
            # Error becomes the NEXT stream item, so the consumer raises at
            # exactly the point the producer stopped.
            idx = rt.stream_progress.get(spec.task_id.binary(), 0)
            oid = ObjectID.for_return(spec.task_id, 1 + idx)
            meta = rt.store.put_serialized(oid, sv, cfg.max_direct_call_object_size)
            meta.is_error = True
            rt.wc.send_async(("stream", spec.task_id.binary(), idx, meta))
        else:
            # For "dynamic", return_ids[0] is the outer handle: the error
            # surfaces on the caller's single ObjectRef.
            targets = req.return_ids[:1] if spec.returns_mode else req.return_ids
            for oid in targets:
                meta = rt.store.put_serialized(oid, sv, cfg.max_direct_call_object_size)
                meta.is_error = True
                metas.append(meta)
        worker_mod.flush_ref_ops()
        if stages is not None:
            stages.setdefault("exec_end", time.time())
            stages["result_stored"] = time.time()
        done = (spec.task_id.binary(), False, metas)
        rt.wc.send_done(done if stages is None else done + (stages,),
                        batch=batch_done)
    finally:
        if exec_span is not None:
            from ray_tpu_torch.util import tracing

            tracing.end_span(exec_span)
        rt.stream_progress.pop(spec.task_id.binary(), None)
        rt.executing.pop(threading.get_ident(), None)
        rt.current_task_id = None
        worker_mod.global_worker.current_task_id = None


def worker_loop(conn, args: WorkerArgs):
    """Entry point run in the spawned worker process."""
    if os.environ.get("RAY_TPU_TORCH_WORKER_PROFILE"):
        # Debug: cProfile this worker's dispatch loop, dump stats to the
        # given directory at exit (perf investigations on the exec path).
        import atexit
        import cProfile

        prof = cProfile.Profile()
        outdir = os.environ["RAY_TPU_TORCH_WORKER_PROFILE"]
        atexit.register(
            lambda: prof.dump_stats(
                os.path.join(outdir, f"worker_{os.getpid()}.pstats")
            )
        )
        prof.enable()
    set_config(args.config)
    for k, v in args.env_vars.items():
        os.environ.setdefault(k, v)
    if args.head_address:
        os.environ.setdefault("RAY_TPU_TORCH_ADDRESS", args.head_address)
    wc = WorkerConnection(conn)
    wc.exit_on_eof = True
    rt = WorkerRuntime(args, wc)
    wc.runtime = rt  # serve_drain reaches the hosted actor through this

    # Live introspection: in-band stack dumps served by the reader thread
    # (annotated with the task each thread is executing), plus the SIGUSR1
    # faulthandler fallback for when even the reader can't run (GIL wedged):
    # the daemon/head signals and tails the per-worker stack file back.
    from ray_tpu_torch._private import introspection

    def _introspect():
        return introspection.thread_stacks(
            extra={
                "role": "worker",
                "worker_id": args.worker_id_hex,
                "node_id": args.node_id_hex,
                "current_task": rt.current_task_name or None,
            },
            executing=dict(rt.executing),
        )

    wc.introspect_fn = _introspect
    wc.prefetch_hook = rt.prefetch_args
    introspection.register_oob_dump(
        introspection.stack_file_path(args.shm_dir, args.worker_id_hex)
    )

    # Bind the module-level API (ray_tpu_torch.get/put/remote/...) to this worker.
    from ray_tpu_torch._private import worker as worker_mod

    worker_mod._connect_worker_process(rt)

    reader = threading.Thread(target=wc.reader_loop, daemon=True, name="reader")
    reader.start()

    worker_mod._start_ref_flusher()
    if args.runtime_env:
        from ray_tpu_torch._private.runtime_env import apply_runtime_env

        try:
            apply_runtime_env(args.runtime_env)
        except Exception as e:  # noqa: BLE001 — surfaced per-task as setup error
            rt.setup_error = e
    if os.environ.get("RAY_TPU_TORCH_LOG_TO_DRIVER", "1") != "0":
        _install_output_tee(wc, rt, args.worker_id_hex)
    wc.send(("register", args.worker_id_hex, os.getpid()))
    hb_period = args.config.health_check_period_ms / 1000.0
    if hb_period > 0:
        # Liveness beat on its own daemon thread: keeps ticking while the
        # dispatch loop runs user code, so the scheduler distinguishes a
        # SLOW task (beats keep coming) from a hung/stopped process (beats
        # stop while the socket stays open).
        def _heartbeat_loop():
            while not wc._closed.is_set():
                time.sleep(hb_period)
                if failpoints.ENABLED and failpoints.fire("worker.heartbeat"):
                    continue  # simulated hang: swallow the beat
                try:
                    wc.send_async(("heartbeat",))
                except Exception:  # noqa: BLE001 — connection gone
                    return

        threading.Thread(
            target=_heartbeat_loop, daemon=True, name="heartbeat"
        ).start()
    while True:
        # Flush the batch buffer (completions, stream items, ref ops) on
        # EVERY pass with an empty queue — a skipped (cancelled) task or any
        # other continue-path must never leave a buffered message stranded
        # while the loop blocks in get().
        if wc.task_queue.empty():
            wc.flush_batch()
        req = wc.task_queue.get()
        if req is None:
            wc.flush_batch()
            break
        if req.spec.task_id.binary() in wc.cancelled:
            # Cancelled while lease-queued: the scheduler already sealed the
            # result; drop without executing or replying.
            with wc._cancelled_lock:
                wc.cancelled.pop(req.spec.task_id.binary(), None)
            continue
        if (
            (rt.concurrency > 1 or rt._group_queues)
            and req.spec.actor_id is not None
            and not req.spec.is_actor_creation
            and req.spec.method_name != "__ray_terminate__"
        ):
            # Threaded actor: bounded out-of-order execution on the actor's
            # call-thread pool (a blocked long-poll call must not stall other
            # methods; __ray_terminate__ stays on the dispatch loop).
            rt.submit_call(
                lambda r=req: _execute(rt, r),
                group=getattr(req.spec, "concurrency_group", None),
            )
        else:
            # Serial dispatch: batch completion messages while more work is
            # queued locally (lease pipelining; flushed at loop top when the
            # queue drains).
            _execute(rt, req, batch_done=True)
    rt.store.detach_all()
    sys.exit(0)
